"""Shared helpers of the family tests (``test_torch_port_yolox.py``,
``_yolov8.py``, ``_yolov7.py``, ``_retinanet.py``, ``_fcos.py``): seeded JAX
variables, targets, batches, a PNG folder set, the JAX ``cli/val.py`` main,
raw-map comparison and two train-step updates against the JAX step."""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
NC = 3
SIZE = 64


def jax_variables(model, seed=0, size=SIZE, noise=0.05):
    """``model.init`` with N(0, noise) added to every parameter and BN
    stats drawn away from the identity, as numpy trees."""
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))())
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, noise, x.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0, 0.1, x.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def jax_param_count(model, size=SIZE):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, size, size, 3)), train=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"])), shapes


def targets(rng, b, m, size=SIZE, nc=NC, lo=1):
    """(b, m, 6) [x1, y1, x2, y2, cls, img] in pixels, ``lo``..m boxes per
    image, -1 padded."""
    t = np.full((b, m, 6), -1.0, np.float32)
    for i in range(b):
        k = int(rng.integers(lo, m + 1))
        xy = rng.uniform(0, size * 0.8, (k, 2))
        wh = rng.uniform(4, size * 0.5, (k, 2))
        t[i, :k, :2] = xy
        t[i, :k, 2:4] = np.minimum(xy + wh, size)
        t[i, :k, 4] = rng.integers(0, nc, k)
        t[i, :k, 5] = i
    return t


def batch(seed, n, size=SIZE, m=8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return img, targets(rng, n, m, size)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).permute(0, 3, 1, 2)


def write_folder(root, n=8, seed=0):
    """``n`` PNGs of assorted sizes with 1-4 filled boxes each, labels and
    names.txt. Returns (img_dir, lab_dir, names)."""
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, NC))
            img[y1:y1 + bh, x1:x1 + bw] = (200, 60 + 60 * c, 40)
            lines.append(f"{c} {x1} {y1} {x1 + bw} {y1 + bh}")
        Image.fromarray(img).save(img_dir / f"{i:03d}.png")
        (lab_dir / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    names = root / "names.txt"
    names.write_text("0 a\n1 b\n2 c\n")
    return img_dir, lab_dir, names


def jax_val_main():
    spec = importlib.util.spec_from_file_location("jax_cli_val", ROOT / "cli" / "val.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def match_detections(got, want, box_tol=2e-3, conf_tol=1e-5):
    """Per image, the same detections one for one (slots matched: keepers
    whose confs differ by ulps may swap)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(-1, 6), np.asarray(w).reshape(-1, 6)
        assert g.shape == w.shape
        free = np.ones(len(g), bool)
        for row in w:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= conf_tol)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= box_tol))
            if not close.any():
                same = g[g[:, 5] == row[5]]
                near = same[np.argmin(np.abs(same[:, :4] - row[:4]).max(1))] if len(same) else None
                raise AssertionError(f"no match for {row}; the nearest of its class {near}")
            free[np.argmax(close)] = False


def rel_diff(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def flat_maps(out) -> list:
    """A model's output (maps, tuples or lists of them, nested) -> numpy
    arrays in the JAX layout: 4-d NCHW maps as NHWC, the rest as they are;
    non-tensor entries (RetinaNet's ``level_hw``) dropped."""
    import torch

    if isinstance(out, (list, tuple)):
        return [a for o in out for a in flat_maps(o)]
    if torch.is_tensor(out):
        return [nhwc(out) if out.dim() == 4 else out.detach().numpy()]
    if isinstance(out, (np.ndarray, jax.Array)):
        return [np.asarray(out)]
    return []


def map_err(got, want) -> float:
    """Largest |got - want| of each map over max(1, the map's largest
    |want|), the worst over the maps: the error at the map's own scale."""
    g, w = flat_maps(got), flat_maps(want)
    assert [a.shape for a in g] == [b.shape for b in w]
    return max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max())) for a, b in zip(g, w))


def two_updates(model, params, stats, port, name, convert, size=SIZE, seeds=(20, 21),
                one_pass_bn=False, hyp=None, **optim):
    """Two ``make_train_step`` updates (8 images as B=4 x accumulate 2, warmup
    active) of the JAX model and of ``port`` from the same weights and
    batches, with family ``name``'s loss built from ``hyp`` (``optim``:
    optimizer config fields on both sides). ``one_pass_bn``: the port's BN
    takes the JAX one-pass batch variance in f32 too (``BatchNorm.forward``
    patched to ``BatchNorm._one_pass`` in training).
    Returns (the worst relative difference per loss entry and grad norm
    over the updates, and of the balances and state trees after them; the
    same for each update alone, a list; the port's last metrics)."""
    import torch

    from yoloseries_tpu_torch.nn.layers import _RECOMPUTING, BatchNorm

    if one_pass_bn:
        forward = BatchNorm.forward

        def one_pass(self, x):
            if not self.training:
                return forward(self, x)
            return self._one_pass(x, _RECOMPUTING.get())

        with mock.patch.object(BatchNorm, "forward", one_pass):
            return two_updates(model, params, stats, port, name, convert, size, seeds,
                               hyp=hyp, **optim)

    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
    from yoloseries_tpu.train.state import create_train_state as jax_create_state
    from yoloseries_tpu.train.state import make_train_step as jax_make_step
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step
    from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

    kw = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5, **optim)
    tx = jax_build_optimizer(JaxOptimizerConfig(**kw), params)
    jloss, jbal = jax_family(name).make_loss(hyp or {}, NC, (size, size))
    ploss, pbal = get_family(name).make_loss(hyp or {}, NC, (size, size))
    jstate = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, size, size, 3), balances=jbal)
    jstate = jstate.replace(params=params, batch_stats=stats, opt_state=tx.init(params),
                            ema_params=params, ema_batch_stats=stats)
    port.load_state_dict(state_dict_from_jax(params, stats))
    pstate = create_train_state(port, OptimizerConfig(**kw), balances=pbal, device="cpu")
    jstep = jax_make_step(jloss, accumulate=2, donate=False)
    pstep = make_train_step(ploss, accumulate=2)
    worst, each = {}, []
    for seed in seeds:
        img, ann = batch(seed, 8, size)
        jstate, jm = jstep(jstate, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
        pstate, pm = pstep(pstate, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        assert set(pm) == set(jm)
        each.append({k: abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-12)
                     for k in pm})
        for k, v in each[-1].items():
            worst[k] = max(worst.get(k, 0.0), v)
    p_params, p_stats = convert(pstate.model.state_dict(), NC)
    e_params, e_stats = convert(pstate.ema, NC)
    for label, got_tree, want_tree in (("params", p_params, jstate.params),
                                       ("batch_stats", p_stats, jstate.batch_stats),
                                       ("ema_params", e_params, jstate.ema_params),
                                       ("ema_batch_stats", e_stats, jstate.ema_batch_stats)):
        got, want = flatten_tree(got_tree), flatten_tree(jax.device_get(dict(want_tree)))
        assert set(got) == set(want), label
        worst[label] = max([rel_diff(np.asarray(got[k]), np.asarray(want[k])) for k in want],
                           default=0.0)
    worst["balances"] = rel_diff(pstate.balances.numpy(), np.asarray(jstate.balances))
    return worst, each, {k: float(v) for k, v in pm.items()}

"""Port YOLOv8 family (models/yolov8.py, losses/yolov8.py,
evaluation/yolov8.py, the ``yolov8`` family entry, the entry points)
against the JAX package.

* raw maps of YOLOv8 at scale 0.34 (yolov8n), JAX weights through
  ``state_dict_from_jax``, eval mode, within 1e-5;
* every registered name (yolov8, yolov8n/s/m): parameter count,
  ``state_dict`` names and shapes, output shapes equal to JAX's;
* the bridge back through JAX's ``convert_yolov8_state_dict`` rebuilds the
  JAX trees exactly;
* ``torch.pow`` against ``jnp.power`` at TAL's exponents (6 and 0.5): at
  most one ulp apart;
* TAL: ``fg`` and the matched gt equal to JAX's ``_assign_image`` element
  for element on random and edge cases (no target, no cell centre in any
  box, duplicate gts, several gts on one cell, tied metrics), the
  normalized metric within 1e-6;
* the loss dicts within 1e-5 relative;
* the dense and the fused decodes within 1e-5, the same candidates, at
  serving and protocol thresholds; at a map size other than the family's
  input size the port decodes on the map's own grid, where JAX's dense
  decode raises and its fused selection moves the boxes;
* two ``make_train_step`` updates against the JAX step;
* ``cli/train.py``, ``cli/val.py`` and ``cli/detect.py --model yolov8n``
  on the CPU; the knobs: the fold, remat, a knob the model lacks raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_families import (
    NC,
    SIZE,
    batch,
    jax_param_count,
    jax_variables,
    nchw,
    nhwc,
    rel_diff,
    targets,
    write_folder,
)

from yoloseries_tpu.evaluation.yolov8 import decode_topk_yolov8 as jax_decode_topk
from yoloseries_tpu.evaluation.yolov8 import decode_yolov8 as jax_decode
from yoloseries_tpu.losses import yolov8 as jax_loss
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from yoloseries_tpu.utils.torch_import import convert_yolov8_state_dict
from yoloseries_tpu_torch.evaluation.yolov8 import decode_topk_yolov8, decode_yolov8
from yoloseries_tpu_torch.losses import yolov8 as port_loss
from yoloseries_tpu_torch.models import YOLOv8, create_model
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

SCALE = 0.34  # yolov8n
STRIDES = (4, 8, 16, 32)
REG = 16
TOL = dict(atol=1e-5, rtol=1e-5)
BOX_ATOL = 5e-5  # px: 32 ulps of a DFL expectation near 16, at stride 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def v8n():
    model = JaxYOLOv8(num_class=NC, scale=SCALE)
    return model, *jax_variables(model, noise=0.01)


def _port(params, stats, **kw):
    port = YOLOv8(NC, SCALE, **kw)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return port.eval()


# --------------------------------------------------------------- models

def test_raw_maps_match_jax(v8n):
    model, params, stats = v8n
    x = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(params, stats)(nchw(x))
    assert len(got) == 4
    for g, r, s in zip(got, ref, STRIDES):
        assert g.shape == (2, 4 * REG + NC, SIZE // s, SIZE // s)
        np.testing.assert_allclose(nhwc(g), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", ["yolov8", "yolov8n", "yolov8s", "yolov8m"])
def test_registered_models_match_jax(name):
    jax_model = jax_create_model(name, num_class=NC)
    want_n, shapes = jax_param_count(jax_model)
    port = create_model(name, num_class=NC, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == want_n
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(zeros["params"],
                                                              zeros["batch_stats"]).items()}
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    out = jax.eval_shape(lambda v: jax_model.apply(v, jnp.zeros((1, SIZE, SIZE, 3)),
                                                   train=False), shapes)
    with torch.no_grad():
        got = port(torch.zeros(1, 3, SIZE, SIZE))
    assert [tuple(g.permute(0, 2, 3, 1).shape) for g in got] == [tuple(o.shape) for o in out]


def test_bridge_round_trips_through_convert_yolov8_state_dict(v8n):
    _, params, stats = v8n
    back_p, back_s = convert_yolov8_state_dict(_port(params, stats).state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_head_biases_match_jax_init():
    """The box outputs' bias 1.0 and the cls outputs' log(5/nc/(640/s)^2),
    the JAX package's ``V8Head`` initializers."""
    port = YOLOv8(NC, SCALE)
    for scale, s in zip(("xsmall", "small", "mid", "large"), STRIDES):
        box = getattr(port.detect, f"detect_{scale}_bbox")[2].bias.detach().numpy()
        cls = getattr(port.detect, f"detect_{scale}_cls")[2].bias.detach().numpy()
        np.testing.assert_array_equal(box, np.ones(4 * REG, np.float32))
        np.testing.assert_allclose(cls, np.full(NC, np.log(5 / NC / (640 / s) ** 2)), rtol=1e-6)


# ----------------------------------------------------------------- TAL

@pytest.mark.parametrize("exponent", [6.0, 0.5])
def test_pow_matches_jnp_power_within_one_ulp(exponent):
    """TAL's metric ``iou**6 * score**0.5`` decides ``metric >= kth``: the
    two packages' powers may part in the last bit, never by more."""
    x = np.random.default_rng(0).uniform(0, 1, 200_000).astype(np.float32)
    want = np.asarray(jnp.power(jnp.asarray(x), exponent))
    got = torch.from_numpy(x).pow(exponent).numpy()
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def _tal_case(name, seed=0):
    """(pred_xyxy_px (N, 4), pred_cls_prob (N, nc), tar_xyxy (M, 4),
    tar_cls (M,), tar_valid (M,), grid_px (N, 2)) at a 64 px input."""
    rng = np.random.default_rng(seed)
    grids, cols = port_loss.v8_grid([(SIZE // s, SIZE // s) for s in STRIDES], STRIDES)
    grid_px = (grids * cols).numpy()
    n = grid_px.shape[0]
    xy = grid_px + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    pred = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
    prob = rng.uniform(0.01, 1, (n, NC))
    m = 6
    tar = np.zeros((m, 4))
    valid = np.zeros(m, bool)
    cls = rng.integers(0, NC, m)
    if name == "random":
        c = rng.uniform(8, 56, (5, 2))
        half = rng.uniform(3, 20, (5, 2))
        tar[:5] = np.concatenate([c - half, c + half], 1)
        valid[:5] = True
    elif name == "no_centre":  # 1 px boxes between the /4 cell centres (at 2 + 4i)
        tar[:3] = [[3.2, 3.2, 3.8, 3.8], [11.1, 20.2, 11.9, 21.0], [40.3, 50.3, 41.7, 51.7]]
        valid[:3] = True
    elif name == "duplicates":
        tar[:4] = [[10, 12, 30, 28]] * 3 + [[30, 30, 60, 50]]
        cls[:3] = [1, 1, 2]
        valid[:4] = True
    elif name == "one_cell":  # nested boxes around one cell centre
        tar[:4] = [[24, 24, 32, 32], [20, 22, 36, 34], [12, 14, 44, 40], [4, 2, 60, 58]]
        valid[:4] = True
    elif name == "ties":  # every prediction the same box and probabilities
        pred[:] = [16, 16, 40, 40]
        prob[:] = prob[0]
        tar[:3] = [[16, 16, 40, 40], [10, 30, 40, 50], [30, 8, 50, 28]]
        valid[:3] = True
    elif name != "empty":
        raise ValueError(name)
    f32 = np.float32
    return (pred.astype(f32), prob.astype(f32), tar.astype(f32), cls.astype(np.int32), valid,
            grid_px.astype(f32))


@pytest.mark.parametrize("name", ["random", "empty", "no_centre", "duplicates", "one_cell",
                                  "ties"])
def test_tal_assignment_matches_jax(name):
    pred, prob, tar, cls, valid, grid_px = _tal_case(name)
    jcfg = jax_loss.YOLOv8LossConfig(num_class=NC, input_size=(SIZE, SIZE))
    pcfg = port_loss.YOLOv8LossConfig(num_class=NC)
    fg_j, gt_j, norm_j = jax.jit(lambda *a: jax_loss._assign_image(*a, jcfg))(
        pred, prob, tar, cls, valid, grid_px)
    fg, gt, norm = port_loss.tal_assign(
        torch.from_numpy(pred)[None], torch.from_numpy(prob)[None], torch.from_numpy(tar)[None],
        torch.from_numpy(cls).long()[None], torch.from_numpy(valid)[None],
        torch.from_numpy(grid_px), pcfg)
    np.testing.assert_array_equal(fg[0].numpy(), np.asarray(fg_j))
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(gt_j))
    np.testing.assert_allclose(norm[0].numpy(), np.asarray(norm_j), atol=1e-6, rtol=1e-5)
    assert fg.any() == (name not in ("empty", "no_centre"))


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("kw", [{}, {"use_focal_factor": False, "topk": 5, "image_chunk": 1}],
                         ids=["preset", "no_focal_topk5_chunk1"])
def test_loss_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    b = 3
    maps = [rng.normal(0, 1, (b, SIZE // s, SIZE // s, 4 * REG + NC)).astype(np.float32)
            for s in STRIDES]
    t = targets(rng, b, 6, lo=0)
    t[2] = -1.0  # an image without targets
    kw = {"image_chunk": 2, **kw}
    want, _ = jax_loss.yolov8_loss([jnp.asarray(m) for m in maps], jnp.asarray(t), jnp.ones(1),
                                   jax_loss.YOLOv8LossConfig(num_class=NC, input_size=(SIZE, SIZE),
                                                             **kw))
    got, bal = port_loss.yolov8_loss([nchw(m) for m in maps], torch.from_numpy(t), torch.ones(1),
                                     port_loss.YOLOv8LossConfig(num_class=NC, **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["tar_nums"]) > 0 and torch.equal(bal, torch.ones(1))


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("conf, k", [(0.25, 64), (0.001, 4096)], ids=["serving", "protocol"])
def test_decodes_match_jax(conf, k):
    rng = np.random.default_rng(2)
    size = 128
    maps = [rng.normal(0, 1.5, (2, size // s, size // s, 4 * REG + NC)).astype(np.float32)
            for s in STRIDES]
    jmaps = [jnp.asarray(m) for m in maps]
    dense = decode_yolov8([nchw(m) for m in maps], NC)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_decode(jmaps, NC, (size, size))),
                               **TOL)
    got = decode_topk_yolov8([nchw(m) for m in maps], NC, k=k, conf_threshold=conf,
                             cls_threshold=conf)
    want = jax_decode_topk(jmaps, NC, (size, size), k=k, conf_threshold=conf, cls_threshold=conf)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # a side's DFL expectation (up to 16 grid units) may part in its last
    # bits, 9.5e-7 each, and the /32 stage multiplies them by 32: 3e-5 px
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=BOX_ATOL, rtol=1e-5)
    assert (got[1] > 0).sum() > 0 and got[1].shape == (2, min(k, dense.shape[1]))


def test_decode_grid_at_another_map_size():
    """Maps of a 64 px input (a 0.67 branch of 96 px before its pad): the
    port decodes them on their own grid, as JAX does when told (64, 64);
    JAX's decode built at the family's (96, 96) raises (dense) or moves
    the boxes by tens of pixels (fused)."""
    rng = np.random.default_rng(3)
    maps = [rng.normal(0, 1.5, (1, SIZE // s, SIZE // s, 4 * REG + NC)).astype(np.float32)
            for s in STRIDES]
    jmaps = [jnp.asarray(m) for m in maps]
    dense = decode_yolov8([nchw(m) for m in maps], NC).numpy()
    np.testing.assert_allclose(dense, np.asarray(jax_decode(jmaps, NC, (SIZE, SIZE))), **TOL)
    with pytest.raises((ValueError, TypeError)):
        jax_decode(jmaps, NC, (96, 96))
    kw = dict(k=256, conf_threshold=0.001, cls_threshold=0.001)
    got = decode_topk_yolov8([nchw(m) for m in maps], NC, **kw)[0].numpy()
    right = np.asarray(jax_decode_topk(jmaps, NC, (SIZE, SIZE), **kw)[0])
    wrong = np.asarray(jax_decode_topk(jmaps, NC, (96, 96), **kw)[0])
    np.testing.assert_allclose(got, right, **TOL)
    assert np.abs(wrong - right).max() > 10.0


# ------------------------------------------------------------- training

def test_two_updates_match_jax(v8n):
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
    from yoloseries_tpu.train.state import create_train_state as jax_create_state
    from yoloseries_tpu.train.state import make_train_step as jax_make_step
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    model, params, stats = v8n
    kw = dict(batch_size=2, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)
    tx = jax_build_optimizer(JaxOptimizerConfig(**kw), params)
    jloss, jbal = jax_family("yolov8n").make_loss({}, NC, (SIZE, SIZE))
    ploss, pbal = get_family("yolov8n").make_loss({}, NC, (SIZE, SIZE))
    jstate = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3), balances=jbal)
    jstate = jstate.replace(params=params, batch_stats=stats, opt_state=tx.init(params),
                            ema_params=params, ema_batch_stats=stats)
    pstate = create_train_state(YOLOv8(NC, SCALE), OptimizerConfig(**kw), balances=pbal,
                                state_dict=state_dict_from_jax(params, stats), device="cpu")
    jstep = jax_make_step(jloss, accumulate=2, donate=False)
    pstep = make_train_step(ploss, accumulate=2)
    worst = {}
    for i in range(2):
        img, ann = batch(30 + i, 4)
        jstate, jm = jstep(jstate, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
        pstate, pm = pstep(pstate, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        assert set(pm) == set(jm)
        for k in ("tot_loss", "iou_loss", "cls_loss", "dfl_loss", "grad_norm"):
            r = abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-12)
            worst[k] = max(worst.get(k, 0.0), r)
        assert float(pm["tar_nums"]) == float(jm["tar_nums"]) > 0
    p_params, p_stats = convert_yolov8_state_dict(pstate.model.state_dict(), NC)
    e_params, e_stats = convert_yolov8_state_dict(pstate.ema, NC)
    for name, got_tree, want_tree in (("params", p_params, jstate.params),
                                      ("batch_stats", p_stats, jstate.batch_stats),
                                      ("ema_params", e_params, jstate.ema_params),
                                      ("ema_batch_stats", e_stats, jstate.ema_batch_stats)):
        got, want = flatten_tree(got_tree), flatten_tree(jax.device_get(want_tree))
        assert set(got) == set(want)
        worst[name] = max(rel_diff(np.asarray(got[k]), np.asarray(want[k])) for k in want)
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    for k in ("tot_loss", "params", "batch_stats", "ema_params", "ema_batch_stats"):
        assert worst[k] <= 1e-4, msg


# ----------------------------------------------------------- entry points

def test_train_val_detect_entry_points_on_cpu(tmp_path, monkeypatch, capsys):
    """``cli/train.py --model yolov8n`` (one update, the family's loss:
    ``dfl_loss`` in the log), then ``cli/val.py`` and ``cli/detect.py`` on
    the checkpoint it wrote, through the family's fused selection."""
    from functools import partial

    import yoloseries_tpu_torch.data as port_data
    import yoloseries_tpu_torch.train.trainer as port_trainer
    from yoloseries_tpu_torch.cli.detect import main as detect_main
    from yoloseries_tpu_torch.cli.train import main as train_main
    from yoloseries_tpu_torch.cli.val import main as val_main
    from yoloseries_tpu_torch.evaluation import yolov8 as ev_v8

    img_dir, lab_dir, names = write_folder(tmp_path / "data", n=4)
    # threads: forking a process that holds JAX can deadlock
    monkeypatch.setattr(port_trainer, "DataLoader",
                        partial(port_trainer.DataLoader, use_processes=False))
    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    calls = []
    real = ev_v8.decode_topk_yolov8
    monkeypatch.setattr(ev_v8, "decode_topk_yolov8",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    train_main(["--model", "yolov8n", "--train-img-dir", str(img_dir), "--train-lab-dir",
                str(lab_dir), "--name-path", str(names), "--batch-size", "4", "--total-epoch",
                "1", "--input-size", str(SIZE), "--output-dir", str(tmp_path / "run"),
                "--set", "accumulate_loss_step=4", "--set", "num_workers=1", "--set",
                "no_data_aug_epoch=1", "--set", "save_log_txt=false", "--device", "cpu"])
    assert "dfl" in capsys.readouterr().out
    ckpt = str(tmp_path / "run" / "checkpoints")
    out = val_main(["--model", "yolov8n", "--ckpt-dir", ckpt, "--val-img-dir", str(img_dir),
                    "--val-lab-dir", str(lab_dir), "--name-path", str(names), "--batch-size",
                    "4", "--input-size", str(SIZE), "--device", "cpu"])
    assert calls and 0.0 <= out["map"] <= 1.0
    calls.clear()
    found = detect_main(["--model", "yolov8n", "--ckpt-dir", ckpt, "--img-dir", str(img_dir),
                         "--name-path", str(names), "--input-size", str(SIZE), "--conf",
                         "0.001", "--save-dir", str(tmp_path / "det"), "--device", "cpu"])
    assert calls and len(found) == 4


# ---------------------------------------------------------------- knobs

def test_fold_remat_and_knobs(v8n):
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn
    from yoloseries_tpu_torch.nn.layers import ConvBnAct

    _, params, stats = v8n
    port = _port(params, stats)
    x = nchw(np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        ref = port(x)
        got = fold_conv_bn(port)(x)
    assert all(isinstance(m.bn, torch.nn.Identity) for m in port.modules()
               if isinstance(m, ConvBnAct))
    assert port.detect.detect_xsmall_bbox[2].bias is not None
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)
    # remat: the same maps and gradients in train mode
    img, ann = batch(5, 2)
    xs = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255
    grads = []
    for remat in (False, True):
        m = _port(params, stats, remat=remat).train()
        sum(o.square().mean() for o in m(xs)).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="yolov8n.*s2d_stem"):
        create_model("yolov8n", num_class=NC, device="cpu", s2d_stem=True)

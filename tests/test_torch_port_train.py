"""Port train step (yoloseries_tpu_torch.train) against the JAX package.

* lr and momentum per group against the JAX schedules for updates 0 to
  W + 2S: warmup, the hold after it and the epoch boundaries, for the
  linear, cosine and onecycle schedules (rtol 1e-6);
* ``param_group_label`` against the JAX labels on the same model;
* one optimizer update from fixed gradients, clipping on and off, SGD and
  Adam (rtol 1e-6);
* the EMA decay and update;
* the bilinear multi-scale resize against ``jax.image.resize``, down and up;
* three ``make_train_step`` updates of a narrow YOLOv5 (width 8, depth 1,
  nc=3, 64 px, B=4, accumulate 2, warmup active, the third resized to 96
  px), port against JAX from the same weights: per-step ``tot_loss``
  within rtol 1e-4; params, BN stats, EMA and balances within
  1e-4 * max(1, |ref|);
* a checkpoint round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig as JaxLossConfig
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.train.ema import ema_decay_weight as jax_ema_decay
from yoloseries_tpu.train.ema import ema_update as jax_ema_update
from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from yoloseries_tpu.train.optim import _group_schedule as jax_group_schedule
from yoloseries_tpu.train.optim import _momentum_schedule as jax_momentum_schedule
from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
from yoloseries_tpu.train.optim import param_group_label as jax_label
from yoloseries_tpu.train.state import create_train_state as jax_create_state
from yoloseries_tpu.train.state import make_train_step as jax_make_step
from yoloseries_tpu.utils.torch_import import convert_yolov5_state_dict
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.train import (
    OptimizerConfig,
    build_optimizer,
    create_train_state,
    ema_decay_weight,
    ema_update,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from yoloseries_tpu_torch.train.optim import _group_schedule, _momentum_schedule, param_group_label
from yoloseries_tpu_torch.train.state import resize_batch
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 64
STEP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("sched", ["linear", "cosine", "onecycle"])
@pytest.mark.parametrize("warmup", [7, 12, 0])
def test_schedules_match_jax(sched, warmup):
    """S = 5 updates an epoch; W = 7 ends warmup mid-epoch (the hold), W = 12
    too, W = 0 turns warmup off."""
    kw = dict(scheduler_type=sched, steps_per_epoch=5, total_epochs=6, batch_size=16,
              warmup_steps_override=warmup, do_warmup=warmup > 0)
    jcfg, pcfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    for start in (0.0, 0.1):
        jf, pf = jax_group_schedule(jcfg, start), _group_schedule(pcfg, start)
        for step in range(warmup + 2 * 5 + 1):
            np.testing.assert_allclose(pf(step), float(jf(step)), rtol=1e-6,
                                       err_msg=f"lr step {step} start {start}")
    jm, pm = jax_momentum_schedule(jcfg), _momentum_schedule(pcfg)
    for step in range(warmup + 2 * 5 + 1):
        np.testing.assert_allclose(pm(step), float(jm(step)), rtol=1e-6, err_msg=f"m {step}")


# ------------------------------------------------------------- weights

@pytest.fixture(scope="module")
def jax_vars():
    """The narrow JAX YOLOv5, its params (init plus N(0, 0.02) noise) and BN
    stats, as numpy trees."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                           train=False))()
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["batch_stats"]))
    return model, params, stats


def _port_model(params, stats):
    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    port.load_state_dict(state_dict_from_jax(params, stats))
    return port


def test_param_group_label_matches_jax(jax_vars):
    _, params, stats = jax_vars
    codes = {"weight": 1.0, "other": 2.0, "bias": 3.0}
    labels = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full(v.shape, codes[jax_label(path, v)], np.float32), params)
    want = state_dict_from_jax(labels, stats)
    port = _port_model(params, stats)
    seen = 0
    for mod_name, module in port.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            assert codes[param_group_label(module, name)] == float(want[key].flatten()[0]), key
            seen += 1
    assert seen == len(flatten_tree(params))


# ----------------------------------------------------------- optimizer

@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("clip", [10.0, 1e6])
def test_one_update_from_fixed_gradients(jax_vars, kind, clip):
    """clip 10 (the preset's) is under the gradient norm (clipping on), 1e6
    over it."""
    _, params, stats = jax_vars
    kw = dict(optimizer=kind, batch_size=16, clip_grad_norm=clip, steps_per_epoch=4,
              warmup_steps_override=6, weight_decay=0.01)
    jcfg, pcfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32),
                                   params)
    tx = jax_build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    jp = params
    port = _port_model(params, stats)
    opt = build_optimizer(pcfg, port)
    gsd = state_dict_from_jax(grads, stats)
    for _ in range(2):  # the second update reads the trace / moments
        upd, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in port.named_parameters():
            p.grad = gsd[name].clone()
        norm = opt.step()
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    assert (float(norm) > clip) == (clip == 10.0)
    want = state_dict_from_jax(jax.device_get(jp), stats)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ----------------------------------------------------------------- EMA

def test_ema_matches_jax():
    for n in (1.0, 7.0, 2000.0, 1e5):
        np.testing.assert_allclose(ema_decay_weight(n), float(jax_ema_decay(jnp.float32(n))),
                                   rtol=1e-6)
    rng = np.random.default_rng(0)
    ema = {"w": rng.normal(size=(3, 4)).astype(np.float32),
           "v": rng.normal(size=5).astype(np.float32)}
    new = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in ema.items()}
    want = jax_ema_update(ema, new, jnp.float32(3.0))
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    got["n"] = torch.tensor(2)
    ema_update(got, {**{k: torch.from_numpy(v) for k, v in new.items()}, "n": torch.tensor(9)}, 3.0)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    assert int(got["n"]) == 9  # integer buffers are copied


# -------------------------------------------------------------- resize

@pytest.mark.parametrize("dst", [(40, 40), (96, 96), (64, 96), (33, 47)])
def test_resize_matches_jax_image_resize(dst):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32)
    ann = rng.uniform(0, 64, (2, 5, 6)).astype(np.float32)
    got, got_ann = resize_batch(torch.from_numpy(img), torch.from_numpy(ann), dst, (64, 64))
    want = jax.image.resize(jnp.asarray(img), (2, *dst, 3), method="bilinear", antialias=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-6)
    scale = max(dst) / 64.0
    np.testing.assert_allclose(got_ann[..., :4].numpy(), ann[..., :4] * scale, rtol=1e-6)
    np.testing.assert_array_equal(got_ann[..., 4:].numpy(), ann[..., 4:])


# -------------------------------------------------------- three updates

def _batch(seed, n, size=SIZE, m=8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    ann = np.full((n, m, 6), -1.0, np.float32)
    for b in range(n):
        k = rng.integers(1, m + 1)
        xy = rng.uniform(0, size - 12, (k, 2))
        wh = rng.uniform(6, size / 2, (k, 2))
        ann[b, :k, :2] = xy
        ann[b, :k, 2:4] = np.minimum(xy + wh, size)
        ann[b, :k, 4] = rng.integers(0, NC, k)
        ann[b, :k, 5] = b
    return img, ann


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def test_three_updates_match_jax(jax_vars):
    model, params, stats = jax_vars
    kw = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)
    jcfg, pcfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    tx = jax_build_optimizer(jcfg, params)
    jstate = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    jstate = jstate.replace(params=params, batch_stats=stats, opt_state=tx.init(params),
                            ema_params=params, ema_batch_stats=stats)
    pstate = create_train_state(YOLOv5(NC, YOLOv5Spec(*NARROW)), pcfg,
                                state_dict=state_dict_from_jax(params, stats), device="cpu")

    def jloss(size):
        return JaxLossConfig(num_class=NC, input_size=(size, size))

    def ploss(size):
        return YOLOv5LossConfig(num_class=NC, input_size=(size, size))

    steps = [(jax_make_step(jloss(SIZE), YOLOV5_ANCHORS, accumulate=2, donate=False),
              make_train_step(ploss(SIZE), YOLOV5_ANCHORS, accumulate=2))] * 2
    steps.append((jax_make_step(jloss(96), YOLOV5_ANCHORS, accumulate=2, donate=False,
                                resize_to=(96, 96), base_hw=(SIZE, SIZE)),
                  make_train_step(ploss(96), YOLOV5_ANCHORS, accumulate=2, resize_to=(96, 96),
                                  base_hw=(SIZE, SIZE))))
    worst = {}
    for i, (jstep, pstep) in enumerate(steps):
        img, ann = _batch(10 + i, 8)
        jstate, jm = jstep(jstate, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
        pstate, pm = pstep(pstate, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        for k in ("tot_loss", "iou_loss", "cof_loss", "cls_loss", "grad_norm"):
            r = abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-12)
            worst[f"{k}"] = max(worst.get(k, 0.0), r)
        assert float(pm["tar_nums"]) == float(jm["tar_nums"])
    p_params, p_stats = convert_yolov5_state_dict(pstate.model.state_dict(), NC)
    e_params, e_stats = convert_yolov5_state_dict(pstate.ema, NC)
    for name, got_tree, want_tree in (("params", p_params, jstate.params),
                                      ("batch_stats", p_stats, jstate.batch_stats),
                                      ("ema_params", e_params, jstate.ema_params),
                                      ("ema_batch_stats", e_stats, jstate.ema_batch_stats)):
        got, want = flatten_tree(got_tree), flatten_tree(jax.device_get(want_tree))
        assert set(got) == set(want)
        worst[name] = max(_rel(np.asarray(got[k]), np.asarray(want[k])) for k in want)
    worst["balances"] = _rel(pstate.balances.numpy(), np.asarray(jstate.balances))
    assert pstate.step == int(jstate.step) == 3
    assert pstate.ema_count == float(jstate.ema_count)
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    assert worst["tot_loss"] <= STEP_TOL, msg
    for k in ("params", "batch_stats", "ema_params", "ema_batch_stats", "balances"):
        assert worst[k] <= STEP_TOL, msg
    print("three updates, worst relative difference:", msg)


# ---------------------------------------------------------- checkpoint

def test_checkpoint_round_trip(jax_vars, tmp_path):
    _, params, stats = jax_vars
    cfg = OptimizerConfig(batch_size=4, steps_per_epoch=2, warmup_steps_override=3)
    state = create_train_state(_port_model(params, stats), cfg, device="cpu")
    step = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                           YOLOV5_ANCHORS, accumulate=1)
    img, ann = _batch(0, 2)
    state, _ = step(state, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path / "ck", state, s, hyp={"a": 1, "b": [1, 2], "f": object()},
                        keep=3)
    assert latest_step(tmp_path / "ck") == 4
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "3", "4"]
    assert latest_step(tmp_path / "none") is None
    fresh = create_train_state(_port_model(params, stats), cfg, device="cpu")
    fresh, got = restore_checkpoint(tmp_path / "ck", fresh)
    assert got == 4 and fresh.step == state.step and fresh.ema_count == state.ema_count
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.ema.items():
        assert torch.equal(fresh.ema[k], v), k
    assert torch.equal(fresh.balances, state.balances)
    assert fresh.optimizer.counts == state.optimizer.counts
    for g, st in state.optimizer.state.items():
        for a, b in zip(st["trace"], fresh.optimizer.state[g]["trace"]):
            assert torch.equal(a, b)
    # the restored state trains on exactly like the saved one
    img, ann = _batch(1, 2)
    batch = {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)}
    _, m1 = step(state, batch)
    _, m2 = step(fresh, batch)
    assert float(m1["tot_loss"]) == float(m2["tot_loss"])
    assert dataclasses.is_dataclass(fresh)

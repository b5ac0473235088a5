"""Port YOLOX family (models/yolox.py, losses/yolox.py, evaluation/yolox.py,
the ``yolox`` family entry, the entry points) against the JAX package.

* raw maps of a narrow YOLOX (CSP trunk of width 8) and a narrow DarkNet21
  (head width 16), JAX weights through ``state_dict_from_jax``, eval mode,
  within 1e-5;
* every registered name (yolox_s/m/l, yolox_darknet21/53): parameter
  count, ``state_dict`` names and shapes, output shapes equal to JAX's;
* the bridge back through JAX's ``convert_yolox_state_dict`` rebuilds the
  JAX trees exactly (DarkNet has no reference converter: one way only);
* SimOTA: ``fg`` and the matched gt equal to JAX's ``_simota_assign_image``
  element for element, with the class cost off (the default) and on, on
  random and edge cases: no target, no cell centre in any box (the
  nearest-cell fallback), duplicate gts, several gts on one cell, tied
  costs;
* the loss dicts and the balances within 1e-5 relative;
* the dense and the fused decodes within 1e-5, the same candidates, at
  serving and protocol thresholds;
* two ``make_train_step`` updates against the JAX step (as YOLOv5's in
  ``test_torch_port_train.py``), a two-epoch ``Trainer`` against JAX's
  (losses to 1e-3, mAP to 1e-6), ``cli/val.py`` against the JAX main and
  ``cli/detect.py`` on the CPU;
* the knobs: the fold, the s2d stem map under ``neck.``, a knob the model
  lacks raises.
"""

from functools import partial

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
    jax_val_main,
    jax_variables,
    match_detections,
    nchw,
    nhwc,
    rel_diff,
    targets,
    write_folder,
)

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.evaluation.yolox import decode_topk_yolox as jax_decode_topk
from yoloseries_tpu.evaluation.yolox import decode_yolox as jax_decode
from yoloseries_tpu.losses import yolox as jax_loss
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxV5Spec
from yoloseries_tpu.models.yolox import YOLOX as JaxYOLOX
from yoloseries_tpu.models.yolox import YOLOXDarknet as JaxDarknet
from yoloseries_tpu.models.yolox import YOLOXSpec as JaxSpec
from yoloseries_tpu.utils.torch_import import convert_yolox_state_dict
from yoloseries_tpu_torch.evaluation.yolox import decode_topk_yolox, decode_yolox
from yoloseries_tpu_torch.losses import yolox as port_loss
from yoloseries_tpu_torch.models import YOLOX, YOLOXDarknet, YOLOXSpec, YOLOv5Spec, create_model
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
HEAD_W = 16
DARKNET21 = (1, 1, 2, 2, 1)
MODEL = "yolox_port_test"  # a narrow YOLOX registered in both packages
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_yolox():
    return JaxYOLOX(num_class=NC, spec=JaxSpec(JaxV5Spec(*NARROW), HEAD_W, 1))


def _port_yolox(params=None, stats=None):
    model = YOLOX(NC, YOLOXSpec(YOLOv5Spec(*NARROW), HEAD_W, 1))
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params, stats))
    return model.eval()


@pytest.fixture(scope="module")
def narrow():
    model = _jax_yolox()
    return model, *jax_variables(model)


# --------------------------------------------------------------- models

@pytest.mark.parametrize("kind", ["yolox", "darknet21"])
def test_raw_maps_match_jax(narrow, kind):
    if kind == "yolox":
        model, params, stats = narrow
        port = _port_yolox(params, stats)
    else:
        model = JaxDarknet(num_class=NC, num_blocks=DARKNET21, head_width=HEAD_W)
        params, stats = jax_variables(model, seed=1, noise=0.01)
        port = YOLOXDarknet(NC, DARKNET21, head_width=HEAD_W)
        port.load_state_dict(state_dict_from_jax(params, stats))  # every key, strictly
        port.eval()
    x = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert g.shape[1] == 5 + NC
        np.testing.assert_allclose(nhwc(g), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", ["yolox_s", "yolox_m", "yolox_l", "yolox_darknet21",
                                  "yolox_darknet53"])
def test_registered_models_match_jax(name):
    """Parameter count, every ``state_dict`` name and shape (the JAX tree
    through the bridge), and the output shapes."""
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


def test_bridge_round_trips_through_convert_yolox_state_dict(narrow):
    _, params, stats = narrow
    back_p, back_s = convert_yolox_state_dict(_port_yolox(params, stats).state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_prior_bias_matches_jax_init():
    params = jax.jit(lambda: _jax_yolox().init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, SIZE, SIZE, 3))))()["params"]
    port = _port_yolox()
    for i, name in enumerate(("pred_small", "pred_middle", "pred_large")):
        head = getattr(port.detect, name)
        for ours, theirs in ((head.cls[-1], "cls"), (head.reg, "reg"), (head.cof, "cof")):
            np.testing.assert_allclose(ours.bias.detach().numpy(),
                                       np.asarray(params[f"head{i}"][theirs]["bias"]), rtol=1e-6)


# --------------------------------------------------------------- SimOTA

def _case(name, seed=0):
    """(gt_xywh (M, 4), gt_cls (M,), gt_valid (M,), pred (P, 5+nc)) at
    stride 8 of a 64 px input."""
    rng = np.random.default_rng(seed)
    p = (SIZE // 8) ** 2
    xy = rng.uniform(0, SIZE, (p, 2))
    pred = np.concatenate([xy, rng.uniform(4, 40, (p, 2)), rng.normal(0, 2, (p, 1 + NC))], 1)
    m = 6
    gt = np.zeros((m, 4))
    valid = np.zeros(m, bool)
    cls = rng.integers(0, NC, m)
    if name == "random":
        gt[:5] = np.concatenate([rng.uniform(8, 56, (5, 2)), rng.uniform(6, 40, (5, 2))], 1)
        valid[:5] = True
    elif name == "fallback":  # 2 px boxes between the cell centres (at 4 + 8i)
        gt[:3] = [[8, 8, 2, 2], [24, 40, 2, 2], [48, 16, 2, 2]]
        valid[:3] = True
    elif name == "duplicates":
        gt[:4] = [[20, 20, 16, 12]] * 3 + [[44, 36, 20, 24]]
        cls[:3] = [1, 1, 2]
        valid[:4] = True
    elif name == "one_cell":  # nested boxes centred in one cell
        gt[:4] = [[28, 28, 6, 6], [28, 28, 14, 10], [29, 27, 30, 24], [27, 29, 50, 40]]
        valid[:4] = True
    elif name == "ties":  # every prediction the same box: equal IoUs and costs
        pred[:, 0:4] = [30, 30, 20, 20]
        gt[:3] = [[30, 30, 20, 20], [20, 36, 24, 16], [40, 24, 12, 28]]
        valid[:3] = True
    elif name != "empty":
        raise ValueError(name)
    return (gt.astype(np.float32), cls.astype(np.int32), valid, pred.astype(np.float32))


@pytest.mark.parametrize("use_pred", [False, True], ids=["zeroed_cost", "pred_cost"])
@pytest.mark.parametrize("name", ["random", "empty", "fallback", "duplicates", "one_cell",
                                  "ties"])
def test_simota_assignment_matches_jax(name, use_pred):
    gt, cls, valid, pred = _case(name)
    jcfg = jax_loss.YOLOXLossConfig(num_class=NC, input_size=(SIZE, SIZE),
                                    use_pred_cls_in_cost=use_pred)
    pcfg = port_loss.YOLOXLossConfig(num_class=NC, input_size=(SIZE, SIZE),
                                     use_pred_cls_in_cost=use_pred)
    h = SIZE // 8
    ys, xs = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    ctr = ((np.stack([xs, ys], -1).reshape(-1, 2) + 0.5) * 8).astype(np.float32)
    fg_j, box_j, cls_j, iou_j = jax.jit(
        lambda *a: jax_loss._simota_assign_image(*a[:4], None, a[4], jcfg))(
        gt, cls, valid, pred, ctr)
    fg, matched, iou = port_loss.simota_assign(
        torch.from_numpy(gt)[None], torch.from_numpy(cls).long()[None],
        torch.from_numpy(valid)[None], torch.from_numpy(pred)[None], torch.from_numpy(ctr),
        pcfg)
    fg, matched, iou = fg[0].numpy(), matched[0].numpy(), iou[0].numpy()
    np.testing.assert_array_equal(fg, np.asarray(fg_j))
    np.testing.assert_array_equal(gt[matched], np.asarray(box_j))
    onehot = np.eye(NC, dtype=np.float32)[cls]
    np.testing.assert_array_equal(onehot[matched] * iou[:, None], np.asarray(cls_j))
    np.testing.assert_array_equal(iou, np.asarray(iou_j))
    # the matched slot: the first gt of that box (duplicates go to the first)
    for col in np.flatnonzero(fg):
        same = np.flatnonzero((gt == gt[matched[col]]).all(1) & valid & (cls == cls[matched[col]]))
        assert matched[col] == same[0]
    if name == "empty":
        assert not fg.any()
    else:
        assert fg.any()


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("kw", [
    {},
    {"use_pred_cls_in_cost": True, "use_focal_loss": True},
    {"iou_type": "giou", "use_l1": False, "class_smooth_factor": 0.9},
    {"iou_type": "iou", "image_chunk": 1},
], ids=["preset", "pred_cost_focal", "giou_smooth", "iou_chunk1"])
def test_loss_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    b = 3  # image_chunk 2 leaves a ragged last chunk
    maps = [rng.normal(0, 1, (b, SIZE // s, SIZE // s, 5 + NC)).astype(np.float32)
            for s in (8, 16, 32)]
    t = targets(rng, b, 6, lo=0)
    t[1] = -1.0  # an image without targets
    bal = np.array([4.0, 1.3, 0.4], np.float32)
    kw = {"image_chunk": 2, **kw}
    want, want_bal = jax_loss.yolox_loss(
        [jnp.asarray(m) for m in maps], jnp.asarray(t), jnp.asarray(bal),
        jax_loss.YOLOXLossConfig(num_class=NC, input_size=(SIZE, SIZE), **kw))
    got, got_bal = port_loss.yolox_loss(
        [nchw(m) for m in maps], torch.from_numpy(t), torch.from_numpy(bal),
        port_loss.YOLOXLossConfig(num_class=NC, input_size=(SIZE, SIZE), **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["fg_nums"]) == float(want["fg_nums"]) > 0
    np.testing.assert_allclose(got_bal.numpy(), np.asarray(want_bal), rtol=1e-5)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("conf, k", [(0.25, 64), (0.001, 4096)], ids=["serving", "protocol"])
def test_decodes_match_jax(conf, k):
    rng = np.random.default_rng(2)
    size = 128
    maps = [rng.normal(0, 1.5, (2, size // s, size // s, 5 + NC)).astype(np.float32)
            for s in (8, 16, 32)]
    dense = decode_yolox([nchw(m) for m in maps], NC)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_decode([jnp.asarray(m) for m in maps],
                                                                     NC)), **TOL)
    got = decode_topk_yolox([nchw(m) for m in maps], NC, k=k, conf_threshold=conf,
                            cls_threshold=conf)
    want = jax_decode_topk([jnp.asarray(m) for m in maps], NC, k=k, conf_threshold=conf,
                           cls_threshold=conf)
    # the same candidates in the same order: scores (the sigmoid differs in
    # ulps), classes and boxes slot for slot
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert (got[1] > 0).sum() > 0 and got[1].shape == (2, min(k, dense.shape[1]))


# ------------------------------------------------------------- training

def test_two_updates_match_jax(narrow):
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
    from yoloseries_tpu.train.state import create_train_state as jax_create_state
    from yoloseries_tpu.train.state import make_train_step as jax_make_step
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    model, params, stats = narrow
    kw = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)
    tx = jax_build_optimizer(JaxOptimizerConfig(**kw), params)
    jloss, jbal = jax_family("yolox_s").make_loss({}, NC, (SIZE, SIZE))
    ploss, pbal = get_family("yolox_s").make_loss({}, NC, (SIZE, SIZE))
    jstate = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3), balances=jbal)
    jstate = jstate.replace(params=params, batch_stats=stats, opt_state=tx.init(params),
                            ema_params=params, ema_batch_stats=stats)
    pstate = create_train_state(_port_yolox(), OptimizerConfig(**kw), balances=pbal,
                                state_dict=state_dict_from_jax(params, stats), device="cpu")
    jstep = jax_make_step(jloss, accumulate=2, donate=False)
    pstep = make_train_step(ploss, accumulate=2)
    worst = {}
    for i in range(2):
        img, ann = batch(20 + i, 8)
        jstate, jm = jstep(jstate, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
        pstate, pm = pstep(pstate, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        assert set(pm) == set(jm)
        for k in ("tot_loss", "iou_loss", "cof_loss", "cls_loss", "l1_loss", "grad_norm"):
            r = abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-12)
            worst[k] = max(worst.get(k, 0.0), r)
        assert float(pm["fg_nums"]) == float(jm["fg_nums"])
        assert float(pm["tar_nums"]) == float(jm["tar_nums"])
    p_params, p_stats = convert_yolox_state_dict(pstate.model.state_dict(), NC)
    e_params, e_stats = convert_yolox_state_dict(pstate.ema, NC)
    for name, got_tree, want_tree in (("params", p_params, jstate.params),
                                      ("batch_stats", p_stats, jstate.batch_stats),
                                      ("ema_params", e_params, jstate.ema_params),
                                      ("ema_batch_stats", e_stats, jstate.ema_batch_stats)):
        got, want = flatten_tree(got_tree), flatten_tree(jax.device_get(want_tree))
        assert set(got) == set(want)
        worst[name] = max(rel_diff(np.asarray(got[k]), np.asarray(want[k])) for k in want)
    worst["balances"] = rel_diff(pstate.balances.numpy(), np.asarray(jstate.balances))
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    for k in ("tot_loss", "params", "batch_stats", "ema_params", "ema_batch_stats", "balances"):
        assert worst[k] <= 1e-4, msg


def _register(params, stats):
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxYOLOX(num_class=num_class, spec=JaxSpec(JaxV5Spec(*NARROW), HEAD_W, 1),
                                 dtype=dtype))

    def port_model(num_class, generator=None):
        m = YOLOX(num_class, YOLOXSpec(YOLOv5Spec(*NARROW), HEAD_W, 1), generator=generator)
        if params is not None:
            m.load_state_dict(state_dict_from_jax(params, stats))
        return m

    port_register(MODEL, knobs=("dtype",))(port_model)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("port_yolox"))


@pytest.fixture(scope="module")
def wide(narrow):
    """The narrow weights with the output convs widened (kernel N(0, 0.3),
    bias 0, but log w, log h 2): the prior biases put every box at ~0.1 px
    and every score near 0.005, so the merge would keep nothing; now boxes
    overlap and scores spread, as a trained head's do."""
    _, params, stats = narrow
    params = jax.tree_util.tree_map(np.copy, params)
    rng = np.random.default_rng(0)
    for i in range(3):
        for conv in ("cls", "cof", "reg"):
            leaf = params[f"head{i}"][conv]
            leaf["kernel"] = rng.normal(0, 0.3, leaf["kernel"].shape).astype(np.float32)
            leaf["bias"] = np.zeros_like(leaf["bias"])
        params[f"head{i}"]["reg"]["bias"][2:] = 2.0  # boxes of e^2 strides: neighbours overlap
    return params, stats


def _label_from_detections(trainer, img_dir, names, lab_dir, per_image=3):
    """Label files holding each image's ``per_image`` most confident
    detections of ``trainer``'s evaluator at its eval weights."""
    lab_dir.mkdir()
    trainer._eval_model.load_state_dict(trainer.eval_variables())
    ds = port_data.DetectionDataset(img_dir, img_dir.parent / "lab", names,
                                    input_size=(SIZE, SIZE))
    loader = port_data.DataLoader(ds, batch_size=len(ds), max_labels=8, shuffle=False,
                                  infinite=False, use_processes=False)
    batch = next(loader)
    loader.stop()
    dets = trainer.evaluator(batch["img"])
    for path, det in zip(ds.img_files, trainer.evaluator.to_host_detections(dets, batch["info"])):
        rows = [] if det is None else det[np.argsort(-det[:, 4])]
        rows = [r for r in rows if min(r[2] - r[0], r[3] - r[1]) > 3][:per_image]
        (lab_dir / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[5])} {r[0]:.2f} {r[1]:.2f} {r[2]:.2f} {r[3]:.2f}\n" for r in rows))
    return lab_dir


def test_trainer_matches_jax(folder, wide, tmp_path):
    """Two epochs of two updates each (B=2, accumulate 2, warmup active,
    augmentation closed) from the same weights: the losses within 1e-3;
    ``evaluate()`` (B1 at K=4096) within 1e-6 in mAP, on val labels made
    from the port's own top detections so that it scores real matches."""
    from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
    from yoloseries_tpu.train import Trainer as JaxTrainer
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = folder
    params, stats = wide
    _register(params, stats)
    hyp = {"input_img_size": [SIZE, SIZE], "batch_size": 2, "accumulate_loss_step": 4,
           "total_epoch": 2, "no_data_aug_epoch": 2, "warmup_steps": 3, "num_workers": 1,
           "save_log_txt": False, "save_ckpt_every": 100, "random_seed": 3,
           "compute_metric_conf_threshold": 0.001, "eval_num_candidates": 4096}
    jcfg = JaxTrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                   output_dir=str(tmp_path / "jax"))
    pcfg = TrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                output_dir=str(tmp_path / "port"))
    jtr = JaxTrainer(jcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                     log_fn=lambda *a: None)
    ptr = Trainer(pcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                  log_fn=lambda *a: None, device="cpu")
    try:
        assert ptr.family.name == "yolox"
        put = jax.device_put
        jtr.state = jtr.state.replace(params=put(params), ema_params=put(params),
                                      batch_stats=put(stats), ema_batch_stats=put(stats))
        jtr.train()
        want_losses = list(jtr.meters["tot_loss"]._window)
        ptr.train()
        got_losses = [h["tot_loss"] for h in ptr.history]
        val_lab = _label_from_detections(ptr, img_dir, names, tmp_path / "val_lab")
        jtr.val_dataset = jax_data.DetectionDataset(img_dir, val_lab, names,
                                                    input_size=(SIZE, SIZE), enable_aug=False)
        ptr.val_dataset = port_data.DetectionDataset(img_dir, val_lab, names,
                                                     input_size=(SIZE, SIZE))
        want = jtr.evaluate()
        got = ptr.evaluate()
    finally:
        jtr.close()
        ptr.close()
    assert len(want_losses) == len(got_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert set(ptr.history[0]) >= {"iou_loss", "cls_loss", "cof_loss", "l1_loss", "fg_nums"}
    for k in ("map", "map50"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # P and R at the best-F1 conf move with a detection conf's last bits
    for k in ("mp", "mr"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["map50"] > 0.5, got


# ----------------------------------------------------------- entry points

@pytest.fixture(scope="module")
def checkpoints(wide, tmp_path_factory):
    """The widened weights as a JAX Orbax checkpoint and as a port
    checkpoint, both at step 3."""
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu.train.checkpoint import save_checkpoint as jax_save
    from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
    from yoloseries_tpu.train.state import create_train_state as jax_create_state
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, save_checkpoint

    params, stats = wide
    _register(params, stats)
    root = tmp_path_factory.mktemp("port_yolox_ckpt")
    model = jax_create_model(MODEL, num_class=NC)
    _, bal = jax_family(MODEL).make_loss({}, NC, (SIZE, SIZE))
    tx = jax_build_optimizer(JaxOptimizerConfig(batch_size=4), params)
    state = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3), balances=bal)
    state = state.replace(params=params, batch_stats=stats, ema_params=params,
                          ema_batch_stats=stats)
    jax_save(root / "jax", state, 3)
    pstate = create_train_state(_port_yolox(params, stats), OptimizerConfig(), device="cpu")
    pstate.step = 3
    save_checkpoint(root / "port", pstate, 3)
    return root


@pytest.mark.parametrize("tta", [False, True])
def test_val_mains_agree(folder, checkpoints, tmp_path, monkeypatch, capsys, tta):
    """Both ``cli/val.py`` mains on the same weights: the same mAP line and
    the same detections; the protocol TTA (K = 3 x 512) too."""
    import pickle

    from yoloseries_tpu_torch.cli.val import main as port_main

    img_dir, lab_dir, names = folder
    common = ["--model", MODEL, "--val-img-dir", str(img_dir), "--val-lab-dir", str(lab_dir),
              "--name-path", str(names), "--batch-size", "4", "--input-size", str(SIZE)]
    if tta:
        cfg = tmp_path / "val.yaml"
        cfg.write_text("val_hyp:\n  eval_num_candidates: 512\n")
        common += ["--tta", "--cfg", str(cfg)]
    monkeypatch.setattr(jax_data, "DataLoader", partial(jax_data.DataLoader, use_processes=False))
    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    monkeypatch.setattr("sys.argv", ["val.py", "--ckpt-dir", str(checkpoints / "jax"),
                                     "--save-pkl-dir", str(tmp_path / "jax"), *common])
    jax_val_main()()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    port_main(["--ckpt-dir", str(checkpoints / "port"), "--save-pkl-dir", str(tmp_path / "port"),
               "--device", "cpu", *common])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want_line

    def load(side):
        with open(tmp_path / side / f"pred_bbox_{SIZE}_{MODEL}.pkl", "rb") as f:
            return pickle.load(f)

    want = load("jax")
    assert sum(len(p) for p in want) > 0
    match_detections(load("port"), want)


def test_detect_runs_the_yolox_family(folder, checkpoints, tmp_path, monkeypatch):
    """``cli/detect.py --model`` of the yolox family decodes with
    ``decode_topk_yolox``: folded (the default) and ``--no-fuse`` give the
    same detections."""
    from yoloseries_tpu_torch.cli.detect import main
    from yoloseries_tpu_torch.evaluation import yolox as ev_yolox

    calls = []
    real = ev_yolox.decode_topk_yolox
    monkeypatch.setattr(ev_yolox, "decode_topk_yolox",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    img_dir, _, names = folder
    args = ["--model", MODEL, "--ckpt-dir", str(checkpoints / "port"), "--img-dir",
            str(img_dir), "--name-path", str(names), "--input-size", str(SIZE),
            "--batch-size", "3", "--conf", "0.01", "--device", "cpu"]
    folded = main([*args, "--save-dir", str(tmp_path / "a")])
    unfused = main([*args, "--save-dir", str(tmp_path / "b"), "--no-fuse"])
    assert calls and sum(len(v) for v in folded.values()) > 0
    names_ = sorted(folded)
    match_detections([np.asarray(folded[n]) for n in names_],
                     [np.asarray(unfused[n]) for n in names_], box_tol=1e-3, conf_tol=1e-5)


# ---------------------------------------------------------------- knobs

def test_fold_and_s2d_stem(narrow):
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn, fold_stem_to_s2d
    from yoloseries_tpu_torch.nn.layers import ConvBnAct

    _, params, stats = narrow
    port = _port_yolox(params, stats)
    x = nchw(np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        ref = port(x)
        s2d = YOLOX(NC, YOLOXSpec(YOLOv5Spec(*NARROW), HEAD_W, 1), s2d_stem=True)
        s2d.load_state_dict(fold_stem_to_s2d(port.state_dict()))
        got_s2d = s2d.eval()(x)
        folded = fold_conv_bn(port)
        got = folded(x)
    assert all(isinstance(m.bn, torch.nn.Identity) for m in folded.modules()
               if isinstance(m, ConvBnAct))
    heads = [getattr(folded.detect, n) for n in ("pred_small", "pred_middle", "pred_large")]
    assert all(h.cof.bias is not None and h.reg.weight.shape[0] == 4 for h in heads)
    for a, b, c in zip(got, got_s2d, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(b.numpy(), c.numpy(), atol=1e-4, rtol=1e-4)


def test_a_knob_the_model_lacks_raises():
    with pytest.raises(ValueError, match="yolox_darknet21.*remat"):
        create_model("yolox_darknet21", num_class=NC, device="cpu", remat=True)
    with pytest.raises(ValueError, match="s2d_stem"):
        create_model("yolox_darknet53", num_class=NC, device="cpu", s2d_stem=True)
    model = create_model("yolox_s", num_class=NC, device="cpu", remat=True, s2d_stem=True)
    assert model.neck.remat and model.neck.s2d_stem

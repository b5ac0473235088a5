"""Port FCOS and FCOS on the CSP trunk (nn/layers.py's GroupNorm and Scale,
models/fcos.py, losses/fcos.py, evaluation/fcos.py, the ``fcos`` family and
its evaluator quirks) against the JAX package.

* raw maps of a narrow FCOS (ResNet blocks (1, 1, 1, 1), 128 px: at inputs
  that are multiples of 128 the JAX package's input / map stride is the
  pyramid's own) and of FCOS-CSPNet, JAX weights through
  ``state_dict_from_jax``, within 1e-4 of each map's scale;
* both registered names: parameter count, ``state_dict`` names and shapes
  (GroupNorm ``scale``/``bias``, ``Scale.scale``), output shapes against
  ``jax.eval_shape``; FCOS's bridge back through ``convert_fcos_state_dict``
  leaf for leaf; the head's prior bias, the FPN's N(0, 0.001) init;
* the assignment: positives, the matched gt (least area, the first slot on
  ties), ltrb and centerness targets equal to JAX's ``_assign_level``
  element for element (duplicate and nested boxes, an image with no box,
  boxes at the range limits), in image chunks;
* the loss dicts within 1e-5 relative (giou, iou, linear_iou, no center
  sampling, label smoothing, an image without positives);
* the dense and the fused decodes; at 96 px, where the two packages'
  P6 and P7 strides part, each package's own arithmetic;
* two ``make_train_step`` updates against the JAX step; a two-epoch
  ``Trainer`` against JAX's (losses 1e-3, mAP 1e-6) on a model with no BN
  at all, then ``cli/detect.py`` on its checkpoint;
* the evaluator's fcos quirks (``conf_sqrt``, ``min_box_wh``,
  ``merge_gate_max=301``) through the port's and JAX's ``Evaluator`` on the
  same weights, plain and TTA.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_families import (
    NC,
    jax_param_count,
    map_err,
    match_detections,
    nchw,
    targets,
    two_updates,
    write_folder,
)

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.evaluation.fcos import decode_fcos as jax_decode
from yoloseries_tpu.evaluation.fcos import decode_topk_fcos as jax_decode_topk
from yoloseries_tpu.losses import fcos as jax_loss
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.fcos import FCOS as JaxFCOS
from yoloseries_tpu.models.fcos import FCOSCSPNet as JaxFCOSCSPNet
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.utils.torch_import import convert_fcos_state_dict
from yoloseries_tpu_torch.evaluation.fcos import decode_fcos, decode_topk_fcos
from yoloseries_tpu_torch.losses import fcos as port_loss
from yoloseries_tpu_torch.models import FCOS, FCOSCSPNet, create_model
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

LAYERS = (1, 1, 1, 1)
SIZE = 128
MAP_TOL = 1e-4
MODEL = "fcos_port_test"  # the narrow FCOS registered in both packages


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _variables(model, seed=0, noise=0.01, size=SIZE):
    """``model.init`` with N(0, noise) on every parameter (and BN statistics
    away from the identity), numpy trees."""
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))())
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x + rng.normal(0, noise, np.shape(x)), np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0, 0.1, x.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return params, stats


def _port(params=None):
    model = FCOS(NC, resnet_layers=LAYERS)
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params, {}))
    return model.eval()


@pytest.fixture(scope="module")
def narrow():
    model = JaxFCOS(num_class=NC, resnet_layers=LAYERS)
    params, _ = _variables(model)
    return model, params


def _images(seed, b=2, size=SIZE):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------- models

def test_raw_maps_match_jax(narrow):
    model, params = narrow
    x = _images(1)
    ref = model.apply({"params": params}, jnp.asarray(x))
    port = _port(params)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    with torch.no_grad():
        got = port(nchw(x))
    assert [len(g) for g in got] == [5, 5, 5]
    assert map_err(got, ref) <= MAP_TOL


def test_cspnet_raw_maps_match_jax():
    model = JaxFCOSCSPNet(num_class=NC)
    params, stats = _variables(model, seed=1, size=64)
    x = _images(2, size=64)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    port = FCOSCSPNet(NC)
    port.load_state_dict(state_dict_from_jax(params, stats))  # every key, strictly
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert [len(g) for g in got] == [3, 3, 3]
    assert map_err(got, ref) <= MAP_TOL


@pytest.mark.parametrize("name", ["fcos", "fcos_cspnet"])
def test_registered_models_match_jax(name):
    jax_model = jax_create_model(name, num_class=NC)
    want_n, shapes = jax_param_count(jax_model, size=SIZE)
    port = create_model(name, num_class=NC, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == want_n
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        zeros["params"], zeros.get("batch_stats", {})).items()}
    assert want == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    out = jax.eval_shape(lambda v: jax_model.apply(v, jnp.zeros((1, SIZE, SIZE, 3)),
                                                   train=False), shapes)
    with torch.no_grad():
        got = port(torch.zeros(1, 3, SIZE, SIZE))
    assert ([tuple(m.permute(0, 2, 3, 1).shape) for g in got for m in g]
            == [tuple(o.shape) for g in out for o in g])
    with pytest.raises(ValueError, match="s2d_stem"):
        create_model(name, num_class=NC, device="cpu", s2d_stem=True)


def test_bridge_round_trips_through_convert_fcos_state_dict(narrow):
    _, params = narrow
    back_p, back_s = convert_fcos_state_dict(_port(params).state_dict(), NC)
    assert back_s == {}
    a, b = flatten_tree(back_p), flatten_tree(params)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_init_matches_jax():
    params = jax.jit(lambda: JaxFCOS(num_class=NC, resnet_layers=LAYERS).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))()["params"]
    port = _port()
    np.testing.assert_allclose(port.head.cls_out_layer.bias.detach().numpy(),
                               np.asarray(params["head"]["cls_out"]["bias"]), rtol=1e-6)
    assert [float(s.scale.detach()) for s in port.head.scales] == [1.0] * 5
    assert abs(float(port.fpn.p3_2.weight.std()) - 0.001) < 1e-4
    assert port.head.cls_layers[0][1].eps == 1e-5 and port.head.cls_layers[0][1].num_groups == 32


# ------------------------------------------------------------ assignment

def _assign_case(name, seed=0):
    """(tar_xyxy (2, 6, 4), tar_valid (2, 6)) at a 128 px input."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((2, 6, 4), np.float32)
    valid = np.zeros((2, 6), bool)
    if name == "random":
        xy = rng.uniform(0, 80, (2, 5, 2))
        gt[:, :5] = np.concatenate([xy, xy + rng.uniform(8, 80, (2, 5, 2))], -1)
        valid[:, :5] = True
    elif name == "duplicates":  # equal areas: the first slot wins
        gt[0, :3] = [[16, 16, 80, 80]] * 3
        gt[1, :2] = [[20, 12, 84, 60], [20, 12, 84, 60]]
        valid[0, :3] = valid[1, :2] = True
    elif name == "nested":  # the least area wins
        gt[0, :4] = [[56, 56, 72, 72], [48, 48, 80, 80], [32, 32, 96, 96], [0, 0, 128, 128]]
        valid[0, :4] = True
    elif name == "range_limits":  # max(ltrb) at 64 and 128: both levels' ends
        gt[0, :3] = [[4 - 60, 4, 4 + 64, 20], [8, 8, 136, 24], [60, 60, 68, 68]]
        valid[0, :3] = True
    elif name != "empty":
        raise ValueError(name)
    return gt, valid


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("sampling", [True, False], ids=["center", "no_center"])
@pytest.mark.parametrize("name", ["random", "empty", "duplicates", "nested", "range_limits"])
def test_assignment_matches_jax(name, sampling, chunk):
    gt, valid = _assign_case(name)
    kw = dict(num_class=NC, input_size=(SIZE, SIZE), do_center_sampling=sampling,
              image_chunk=chunk)
    jcfg, pcfg = jax_loss.FCOSLossConfig(**kw), port_loss.FCOSLossConfig(**kw)
    ranges = port_loss.regression_ranges(5, pcfg.strides)
    assert ranges == jax_loss._regression_ranges(5, jcfg.strides)
    n_pos = 0
    for li, stride in enumerate(pcfg.strides):
        h = SIZE // stride
        grid = port_loss.level_grid(h, h, float(stride), "cpu")
        got = port_loss.fcos_assign(grid, torch.from_numpy(gt), torch.from_numpy(valid),
                                    float(stride), *ranges[li], pcfg)
        for i in range(2):
            want = jax_loss._assign_level(jnp.asarray(grid.numpy()), jnp.asarray(gt[i]),
                                          jnp.asarray(valid[i]), float(stride), *ranges[li],
                                          jcfg)
            pos = np.asarray(want[0])
            np.testing.assert_array_equal(got[0][i].numpy(), pos)
            np.testing.assert_array_equal(got[1][i].numpy()[pos], np.asarray(want[1])[pos])
            np.testing.assert_allclose(got[2][i].numpy()[pos], np.asarray(want[2])[pos],
                                       rtol=1e-6)
            np.testing.assert_allclose(got[3][i].numpy()[pos], np.asarray(want[3])[pos],
                                       rtol=1e-6)
            n_pos += int(pos.sum())
    assert (n_pos > 0) == (name != "empty")


# ----------------------------------------------------------------- loss

def _level_maps(rng, b, size=SIZE, levels=5):
    shapes = [(size // s, size // s) for s in (8, 16, 32, 64, 128)[:levels]]
    cls = [rng.normal(-2, 1.5, (b, h, w, NC)).astype(np.float32) for h, w in shapes]
    reg = [np.abs(rng.normal(1.5, 1.0, (b, h, w, 4))).astype(np.float32) for h, w in shapes]
    ctr = [rng.normal(0, 1, (b, h, w, 1)).astype(np.float32) for h, w in shapes]
    return cls, reg, ctr


@pytest.mark.parametrize("kw", [
    {},
    {"iou_type": "iou", "image_chunk": 1},
    {"iou_type": "linear_iou", "do_center_sampling": False},
    {"class_smooth_factor": 0.1, "cls_loss_weight": 5.0, "ctr_loss_weight": 2.0},
], ids=["giou", "iou_chunk1", "linear_no_sampling", "smooth_weights"])
def test_loss_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    b = 3
    maps = _level_maps(rng, b)
    t = targets(rng, b, 6, size=SIZE)
    t[1] = -1.0  # an image without targets: the centerness BCE falls back
    cfg = {"num_class": NC, "input_size": (SIZE, SIZE), "image_chunk": 2, **kw}
    want = jax_loss.fcos_loss(*[[jnp.asarray(m) for m in g] for g in maps], jnp.asarray(t),
                              jax_loss.FCOSLossConfig(**cfg))
    got = port_loss.fcos_loss(*[[nchw(m) for m in g] for g in maps], torch.from_numpy(t),
                              port_loss.FCOSLossConfig(**cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["tar_nums"]) > 0


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("conf, k", [(0.25, 64), (0.001, 4096)], ids=["serving", "protocol"])
def test_decodes_match_jax(conf, k):
    rng = np.random.default_rng(2)
    maps = _level_maps(rng, 2, size=256)
    jmaps = [[jnp.asarray(m) for m in g] for g in maps]
    pmaps = [[nchw(m) for m in g] for g in maps]
    dense = decode_fcos(*pmaps)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_decode(*jmaps, (256, 256))),
                               atol=1e-4, rtol=1e-5)
    got = decode_topk_fcos(*pmaps, k=k, conf_threshold=conf, cls_threshold=conf)
    want = jax_decode_topk(*jmaps, (256, 256), k=k, conf_threshold=conf, cls_threshold=conf)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-5)
    assert (got[1] > 0).sum() > 0


def test_strides_part_off_the_128_grid(narrow):
    """At 96 px, not a multiple of 128, the packages part (a deliberate
    difference, ROADMAP.md §C): the maps are 12, 6, 3, 2 and 1 cells (P6
    and P7 round up), the JAX decode takes the stride as 96 / map height
    (8, 16, 32, 48, 96) and the port the pyramid's (8, 16, 32, 64, 128) on
    the map's own cells. The raw maps and the first three levels' rows
    agree; P6's and P7's boxes are each package's arithmetic at its own
    strides, tens of pixels apart; scores agree everywhere. Both decode
    JAX's maps."""
    model, params = narrow
    x = _images(5, b=1, size=96)
    ref = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        own = _port(params)(nchw(x))
    assert [tuple(m.shape[-2:]) for m in own[0]] == [(12, 12), (6, 6), (3, 3), (2, 2), (1, 1)]
    assert map_err(own, ref) <= MAP_TOL
    maps = [[nchw(np.array(m)) for m in group] for group in ref]
    got = decode_fcos(*maps).numpy()
    want = np.asarray(jax_decode(*ref, (96, 96)))
    fine = 12 * 12 + 6 * 6 + 3 * 3
    np.testing.assert_allclose(got[:, :fine], want[:, :fine], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-6, rtol=0)
    start = fine
    for reg, stride, jax_stride in zip(maps[1][3:], (64, 128), (48, 96)):
        h, w = reg.shape[-2:]
        ltrb = reg[0].permute(1, 2, 0).reshape(h * w, 4).numpy().astype(np.float64)
        ys, xs = np.divmod(np.arange(h * w), w)
        for out, s in ((got, stride), (want, jax_stride)):
            cx, cy = xs * s + s // 2, ys * s + s // 2
            xyxy = np.stack([cx - ltrb[:, 0] * s, cy - ltrb[:, 1] * s,
                             cx + ltrb[:, 2] * s, cy + ltrb[:, 3] * s], 1)
            cxcywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2, xyxy[:, 2:] - xyxy[:, :2]], 1)
            np.testing.assert_allclose(out[0, start:start + h * w, :4], cxcywh, atol=1e-3,
                                       rtol=1e-5)
        assert np.abs(got[0, start:start + h * w, :2] - want[0, start:start + h * w, :2]).max() > 10
        start += h * w
    assert start == got.shape[1]


# ------------------------------------------------------------- training

def test_two_updates_match_jax(narrow):
    model, params = narrow
    worst, _, metrics = two_updates(model, params, {}, _port(), "fcos", convert_fcos_state_dict,
                                    size=SIZE)
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    assert metrics["tar_nums"] > 0 and worst["tar_nums"] == 0, msg
    for k in ("tot_loss", "cls_loss", "reg_loss", "cen_loss", "grad_norm", "params",
              "ema_params"):
        assert worst[k] <= 1e-3, msg  # TRAIN_TOL of chip_smoke.py
    assert worst["balances"] == 0


def _register(params):
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxFCOS(num_class=num_class, resnet_layers=LAYERS, dtype=dtype))

    def port_model(num_class, generator=None):
        m = FCOS(num_class, resnet_layers=LAYERS, generator=generator)
        if params is not None:
            m.load_state_dict(state_dict_from_jax(params, {}))
        return m

    port_register(MODEL, knobs=("dtype",))(port_model)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("port_fcos"))


@pytest.fixture(scope="module")
def wide(narrow):
    """The narrow weights with the output convs widened (kernel N(0, 0.01),
    bias 0): the focal prior puts every class score near 0.01."""
    _, params = narrow
    params = jax.tree_util.tree_map(np.copy, params)
    rng = np.random.default_rng(0)
    for conv in ("cls_out", "ctr_out", "reg_out"):
        leaf = params["head"][conv]
        leaf["kernel"] = rng.normal(0, 0.01, leaf["kernel"].shape).astype(np.float32)
        leaf["bias"] = np.full_like(leaf["bias"], 1.0 if conv == "reg_out" else 0.0)
    return params


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


def test_trainer_without_bn_matches_jax(folder, wide, tmp_path):
    """FCOS holds no BN state: two epochs of two updates each (B=2,
    accumulate 2, warmup active, augmentation closed) from the same weights,
    the losses within 1e-3; ``evaluate()`` (B1 at K=4096, the fcos quirks:
    sqrt scores, the box filter, the 301 merge gate) within 1e-6 in mAP on
    val labels made from the port's own top detections; the checkpoint it
    wrote through ``cli/detect.py``, which has no BN to fold."""
    from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
    from yoloseries_tpu.train import Trainer as JaxTrainer
    from yoloseries_tpu_torch.cli.detect import main as detect_main
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = folder
    _register(wide)
    hyp = {"input_img_size": [SIZE, SIZE], "batch_size": 2, "accumulate_loss_step": 4,
           "total_epoch": 2, "no_data_aug_epoch": 2, "warmup_steps": 3, "num_workers": 1,
           "save_log_txt": False, "save_ckpt_every": 1, "random_seed": 3,
           "compute_metric_conf_threshold": 0.001, "eval_num_candidates": 4096,
           "min_prediction_box_wh": 2}
    jcfg = JaxTrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                   output_dir=str(tmp_path / "jax"))
    pcfg = TrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                output_dir=str(tmp_path / "port"))
    jtr = JaxTrainer(jcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                     log_fn=lambda *a: None)
    ptr = Trainer(pcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                  log_fn=lambda *a: None, device="cpu")
    try:
        cfg = ptr.evaluator.cfg
        assert ptr.family.name == "fcos" and not jtr.state.batch_stats
        assert (cfg.conf_sqrt, cfg.min_box_wh, cfg.merge_gate_max) == (True, 2.0, 301)
        jtr.state = jtr.state.replace(params=jax.device_put(wide), ema_params=jax.device_put(wide))
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
    assert set(ptr.history[0]) >= {"cls_loss", "reg_loss", "cen_loss", "tar_nums"}
    for k in ("map", "map50"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for k in ("mp", "mr"):  # P and R at the best-F1 conf move with a conf's last bits
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert got["map50"] > 0.3, got

    args = ["--model", MODEL, "--ckpt-dir", str(tmp_path / "port" / "checkpoints"),
            "--img-dir", str(img_dir), "--name-path", str(names), "--input-size", str(SIZE),
            "--batch-size", "3", "--conf", "0.05", "--device", "cpu"]
    folded = detect_main([*args, "--save-dir", str(tmp_path / "a")])
    unfused = detect_main([*args, "--save-dir", str(tmp_path / "b"), "--no-fuse"])
    names_ = sorted(folded)
    assert sum(len(v) for v in folded.values()) > 0
    match_detections([np.asarray(folded[n]) for n in names_],
                     [np.asarray(unfused[n]) for n in names_], box_tol=0.0, conf_tol=0.0)


# ------------------------------------------------------- evaluator quirks

@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_evaluator_fcos_quirks_match_jax(narrow, wide, tta, fused):
    """The family's overrides (``conf_sqrt``, ``min_box_wh`` 12 px, the merge
    gated at 301 candidates) through both evaluators on the same weights:
    the same detections; each quirk shows in them."""
    from yoloseries_tpu.evaluation.yolov5 import EvalConfig as JaxEvalConfig
    from yoloseries_tpu.evaluation.yolov5 import Evaluator as JaxEvaluator
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family

    model, _ = narrow
    hyp = {"min_prediction_box_wh": 12}
    kw = dict(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.5,
              num_candidates=4096, use_tta=tta)
    jfam, pfam = jax_family("fcos"), get_family("fcos")
    jcfg = jfam.apply_eval_overrides(JaxEvalConfig(**kw), hyp)
    pcfg = pfam.apply_eval_overrides(EvalConfig(**kw), hyp)
    assert (pcfg.conf_sqrt, pcfg.min_box_wh, pcfg.merge_gate_max) == (True, 12.0, 301)
    size = (SIZE, SIZE)
    jsel = jfam.make_select(hyp, NC, size)(jcfg) if fused else None
    psel = pfam.make_select(hyp, NC, size)(pcfg) if fused else None
    jev = JaxEvaluator(model.apply, jfam.make_decode(hyp, NC, size), jcfg, select_fn=jsel)
    pev = Evaluator(_port(wide), pfam.make_decode(hyp, NC, size), pcfg, select_fn=psel,
                    device="cpu")
    img = (_images(7, b=2) * 255).astype(np.uint8)
    want = np.asarray(jev({"params": wide}, img))
    got = pev(img).numpy()
    # FCOS's maps agree to 1e-4 of their scale (GroupNorm after an FPN drawn
    # from N(0, 0.001)), and a box is ltrb times a stride of up to 128 px
    match_detections([g[g[:, 4] > 0] for g in got], [w[w[:, 4] > 0] for w in want],
                     box_tol=1e-2, conf_tol=1e-4)
    live = got[got[:, :, 4] > 0]
    assert len(live) > 0
    assert ((live[:, 2] - live[:, 0] > 12) & (live[:, 3] - live[:, 1] > 12)).all()
    unsqrt = Evaluator(pev.model, pev.decode_fn, dataclasses.replace(pcfg, conf_sqrt=False),
                       select_fn=psel, device="cpu")(img).numpy()
    np.testing.assert_array_equal(unsqrt[..., [0, 1, 2, 3, 5]], got[..., [0, 1, 2, 3, 5]])
    np.testing.assert_allclose(np.sqrt(unsqrt[..., 4]), got[..., 4], rtol=1e-6)
    plain = Evaluator(pev.model, pev.decode_fn, EvalConfig(**kw), select_fn=psel,
                      device="cpu")(img).numpy()
    assert (plain[..., 4] > 0).sum() != len(live)  # the box filter and the merge gate

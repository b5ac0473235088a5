"""Port RetinaNet and its objectness "experiment" (models/retinanet.py,
losses/retinanet.py, evaluation/retinanet.py, ops/anchors.py, the
``retinanet`` families, the entry points) against the JAX package.

* raw maps of a narrow RetinaNet (ResNet blocks (1, 1, 1, 1)) and of the
  experiment variant, JAX weights through ``state_dict_from_jax``, eval
  mode, within 1e-4 of each map's scale; the anchors against JAX's
  ``pyramid_anchors``, and laid on the maps' own sizes;
* both registered names: parameter count, ``state_dict`` names and shapes,
  output shapes against ``jax.eval_shape``; the bridge back through
  ``convert_retinanet_state_dict`` leaf for leaf; the focal prior biases;
* the assignment: each anchor's best IoU and gt equal to JAX's
  ``_anchor_gt_iou`` with its thresholds element for element (duplicate,
  nested and tied boxes, an image with no box), in image chunks;
* the loss dicts within 1e-5 relative, iou/giou/ciou, both variants;
* the dense and the fused decodes, rounded and clipped;
* two ``make_train_step`` updates against the JAX step;
* both ``cli/val.py`` mains (the merge writes the boxes back) and
  ``cli/detect.py``. The two-epoch ``Trainer`` against JAX's is FCOS's
  (``test_torch_port_fcos.py``): here the merged boxes, a matmul summed in
  another order in each package, move by ~1e-3 px and can move a match
  across an IoU threshold of the mAP.
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
    jax_param_count,
    jax_val_main,
    jax_variables,
    map_err,
    match_detections,
    nchw,
    targets,
    two_updates,
    write_folder,
)

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.evaluation.retinanet import decode_retinanet as jax_decode
from yoloseries_tpu.evaluation.retinanet import decode_topk_retinanet as jax_decode_topk
from yoloseries_tpu.losses import retinanet as jax_loss
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from yoloseries_tpu.ops.anchors import pyramid_anchors as jax_pyramid_anchors
from yoloseries_tpu.utils.torch_import import convert_retinanet_state_dict
from yoloseries_tpu_torch.evaluation.retinanet import decode_retinanet, decode_topk_retinanet
from yoloseries_tpu_torch.losses import retinanet as port_loss
from yoloseries_tpu_torch.models import RetinaNet, create_model
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.ops.anchors import level_anchors, pyramid_anchors
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

LAYERS = (1, 1, 1, 1)
MAP_TOL = 1e-4
NOISE = 0.01
MODEL = "retinanet_port_test"  # the narrow RetinaNet registered in both packages


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax(objectness=False):
    return JaxRetinaNet(num_class=NC, resnet_layers=LAYERS, with_objectness=objectness)


def _port(params=None, stats=None, objectness=False):
    model = RetinaNet(NC, resnet_layers=LAYERS, with_objectness=objectness)
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params, stats))
    return model.eval()


@pytest.fixture(scope="module")
def narrow():
    model = _jax()
    return model, *jax_variables(model, noise=NOISE)


# --------------------------------------------------------------- models

@pytest.mark.parametrize("objectness", [False, True], ids=["retinanet", "experiment"])
def test_raw_maps_match_jax(objectness):
    model = _jax(objectness)
    params, stats = jax_variables(model, seed=int(objectness), noise=NOISE)
    x = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(params, stats, objectness)(nchw(x))
    assert got.regression.shape[-1] == (5 if objectness else 4)
    assert map_err(got, ref) <= MAP_TOL
    anchors = pyramid_anchors((SIZE, SIZE))
    np.testing.assert_array_equal(anchors, jax_pyramid_anchors(np.asarray((SIZE, SIZE))))
    np.testing.assert_array_equal(level_anchors(got.level_hw), anchors)
    assert anchors.shape[0] == got.regression.shape[1]


@pytest.mark.parametrize("name", ["retinanet", "retinanet_experiment"])
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
    assert [tuple(g.shape) for g in got[:2]] == [tuple(o.shape) for o in out]
    with pytest.raises(ValueError, match="s2d_stem"):
        create_model(name, num_class=NC, device="cpu", s2d_stem=True)


def test_bridge_round_trips_through_convert_retinanet_state_dict(narrow):
    _, params, stats = narrow
    back_p, back_s = convert_retinanet_state_dict(_port(params, stats).state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_prior_biases_match_jax_init():
    params = jax.jit(lambda: _jax().init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, SIZE, SIZE, 3))))()["params"]
    port = _port()
    for name in ("conv1", "conv4", "output"):
        np.testing.assert_allclose(getattr(port.classification, name).bias.detach().numpy(),
                                   np.asarray(params["classification"]
                                              ["out" if name == "output" else name]["bias"]),
                                   rtol=1e-6)
        assert not getattr(port.regression, name).bias.detach().any()


# ------------------------------------------------------------ assignment

def _assign_case(name, seed=0):
    """gt boxes (B=2, M=6, 4) and valid (2, 6) at a 64 px input."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((2, 6, 4), np.float32)
    valid = np.zeros((2, 6), bool)
    if name == "random":
        xy = rng.uniform(0, 40, (2, 5, 2))
        gt[:, :5] = np.concatenate([xy, xy + rng.uniform(8, 30, (2, 5, 2))], -1)
        valid[:, :5] = True
    elif name == "duplicates":
        gt[0, :3] = [[8, 8, 40, 40]] * 3
        gt[1, :2] = [[20, 12, 52, 44], [20, 12, 52, 44]]
        valid[0, :3] = valid[1, :2] = True
    elif name == "nested":
        gt[0, :4] = [[28, 28, 36, 36], [24, 24, 40, 40], [16, 16, 48, 48], [0, 0, 64, 64]]
        valid[0, :4] = True
    elif name == "mixed_empty":  # image 1 has no box
        gt[0, :2] = [[4, 4, 36, 30], [30, 30, 62, 58]]
        valid[0, :2] = True
    elif name != "empty":
        raise ValueError(name)
    return gt, valid


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", ["random", "empty", "duplicates", "nested", "mixed_empty"])
def test_assignment_matches_jax(name, chunk):
    gt, valid = _assign_case(name)
    anchors = pyramid_anchors((SIZE, SIZE))
    best, arg = port_loss.retinanet_assign(torch.from_numpy(anchors), torch.from_numpy(gt),
                                           torch.from_numpy(valid), image_chunk=chunk)
    for i in range(2):
        iou = jnp.where(valid[i][None, :],
                        jax_loss._anchor_gt_iou(jnp.asarray(anchors), jnp.asarray(gt[i])), -1.0)
        np.testing.assert_array_equal(best[i].numpy(), np.asarray(jnp.max(iou, -1)))
        np.testing.assert_array_equal(arg[i].numpy(), np.asarray(jnp.argmax(iou, -1)))
    pos = (best >= 0.5) & torch.from_numpy(valid).any(-1, keepdim=True)
    assert bool(pos.any()) == (name not in ("empty",))


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("kw", [
    {},
    {"iou_type": "iou", "image_chunk": 1},
    {"iou_type": "giou", "with_objectness": True},
    {"with_objectness": True, "iou_loss_scale": 0.0, "alpha": 0.5, "gamma": 1.5},
], ids=["ciou", "iou_chunk1", "giou_objectness", "objectness_no_iou"])
def test_loss_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    b = 3
    anchors = pyramid_anchors((SIZE, SIZE))
    a = anchors.shape[0]
    reg = rng.normal(0, 0.5, (b, a, 5 if kw.get("with_objectness") else 4)).astype(np.float32)
    cls = rng.normal(-2, 1.5, (b, a, NC)).astype(np.float32)
    t = targets(rng, b, 6)
    t[0, 0, :4] = anchors[a // 2]  # at least one positive anchor
    t[1] = -1.0  # an image without targets
    want = jax_loss.retinanet_loss(jnp.asarray(reg), jnp.asarray(cls), jnp.asarray(t),
                                   jnp.asarray(anchors),
                                   jax_loss.RetinaNetLossConfig(num_class=NC, **kw))
    got = port_loss.retinanet_loss(torch.from_numpy(reg), torch.from_numpy(cls),
                                   torch.from_numpy(t), anchors,
                                   port_loss.RetinaNetLossConfig(num_class=NC, **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(got["tar_nums"]) > 0


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("objectness", [False, True], ids=["retinanet", "experiment"])
@pytest.mark.parametrize("conf, k", [(0.25, 64), (0.001, 4096)], ids=["serving", "protocol"])
def test_decodes_match_jax(conf, k, objectness):
    rng = np.random.default_rng(2)
    size = 128
    anchors = pyramid_anchors((size, size))
    a = anchors.shape[0]
    reg = rng.normal(0, 0.5, (2, a, 5 if objectness else 4)).astype(np.float32)
    cls = rng.normal(0, 1.5, (2, a, NC)).astype(np.float32)
    for clip in (None, (size, size)):
        dense = decode_retinanet(torch.from_numpy(reg), torch.from_numpy(cls), anchors,
                                 clip_size=clip)
        want = jax_decode(jnp.asarray(reg), jnp.asarray(cls), jnp.asarray(anchors),
                          clip_size=clip)
        np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
        got = decode_topk_retinanet(torch.from_numpy(reg), torch.from_numpy(cls), anchors, k=k,
                                    conf_threshold=conf, cls_threshold=conf, clip_size=clip)
        want = jax_decode_topk(jnp.asarray(reg), jnp.asarray(cls), jnp.asarray(anchors), k=k,
                               conf_threshold=conf, cls_threshold=conf, clip_size=clip)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-5)
        assert (got[1] > 0).sum() > 0


# ------------------------------------------------------------- training

@pytest.mark.parametrize("one_pass_bn", [True, False], ids=["one_pass_bn", "fused_bn"])
@pytest.mark.parametrize("name", ["retinanet", "retinanet_experiment"])
def test_two_updates_match_jax(narrow, name, one_pass_bn):
    """With the preset's IoU loss ("iou"); the family's default CIoU in
    delta space divides by the predicted dw and dh unclamped, as the
    reference does, and its aspect term jumps where they cross 0, so it is
    held in ``test_loss_matches_jax`` on fixed maps. The port's BN in
    training takes its own f32 path (torch's fused kernel, the one the port
    trains with) or the JAX one-pass batch variance (``forward`` patched to
    ``nn/layers.py::BatchNorm._one_pass``). The two variances differ in
    f32 rounding only, which moves the gradient norm of this random net by
    up to 2.3e-3 on the fused path; the state after the updates stays
    within 1e-3 on both."""
    objectness = name.endswith("experiment")
    model = _jax(objectness)
    params, stats = narrow[1:] if not objectness else jax_variables(model, seed=1, noise=NOISE)
    worst, _, metrics = two_updates(model, params, stats, _port(objectness=objectness), name,
                                    convert_retinanet_state_dict, one_pass_bn=one_pass_bn,
                                    hyp={"iou_type": "iou"})
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    assert metrics["tar_nums"] > 0 and worst["tar_nums"] == 0, msg
    for k in ("tot_loss", "l1_loss", "iou_loss", "cls_loss", "params", "batch_stats",
              "ema_params", "ema_batch_stats"):
        assert worst[k] <= 1e-3, msg  # TRAIN_TOL of chip_smoke.py (measured <= 2e-4)
    assert worst["grad_norm"] <= (1e-3 if one_pass_bn else 1e-2), msg
    assert worst["balances"] == 0


def _register(params, stats):
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxRetinaNet(num_class=num_class, resnet_layers=LAYERS, dtype=dtype))

    def port_model(num_class, generator=None):
        m = RetinaNet(num_class, resnet_layers=LAYERS, generator=generator)
        if params is not None:
            m.load_state_dict(state_dict_from_jax(params, stats))
        return m

    port_register(MODEL, knobs=("dtype",))(port_model)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("port_retinanet"))


@pytest.fixture(scope="module")
def wide(narrow):
    """The narrow weights with the output convs widened (kernel N(0, 0.01))
    and every tower bias 0: the focal prior (on all five convs of the
    classification tower, as JAX initializes them) leaves the tower's ReLUs
    dead and every score at sigmoid(bias), tied."""
    _, params, stats = narrow
    params = jax.tree_util.tree_map(np.copy, params)
    rng = np.random.default_rng(0)
    for tower in ("classification", "regression"):
        for leaf in params[tower].values():
            leaf["bias"] = np.zeros_like(leaf["bias"])
        leaf = params[tower]["out"]
        leaf["kernel"] = rng.normal(0, 0.01, leaf["kernel"].shape).astype(np.float32)
    return params, stats


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
    root = tmp_path_factory.mktemp("port_retinanet_ckpt")
    model = jax_create_model(MODEL, num_class=NC)
    _, bal = jax_family(MODEL).make_loss({}, NC, (SIZE, SIZE))
    tx = jax_build_optimizer(JaxOptimizerConfig(batch_size=4), params)
    state = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3), balances=bal)
    state = state.replace(params=params, batch_stats=stats, ema_params=params,
                          ema_batch_stats=stats)
    jax_save(root / "jax", state, 3)
    pstate = create_train_state(_port(params, stats), OptimizerConfig(), balances=torch.ones(1),
                                device="cpu")
    pstate.step = 3
    save_checkpoint(root / "port", pstate, 3)
    return root


@pytest.mark.parametrize("tta", [False, True])
def test_val_mains_agree(folder, checkpoints, tmp_path, monkeypatch, capsys, tta):
    """Both ``cli/val.py`` mains on the same weights: the same mAP line and
    the same detections, boxes within 1e-2 px of the original images (the
    merged boxes written back are a matmul summed in another order in each
    package, 1e-3 px apart in the input, scaled up by the un-letterbox);
    protocol TTA too, where a box may move by a whole input pixel (1.5 px
    in the original): the decode rounds the boxes to integers, as the
    reference's ``bbox_clip``, and a TTA branch's rescaled coordinate that
    lies at .5 rounds either way with the exp's last bit."""
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
    match_detections(load("port"), want, box_tol=1.5 if tta else 1e-2)


def test_detect_runs_the_retinanet_family(folder, checkpoints, tmp_path):
    """``cli/detect.py``: the BNs of the ResNet are not ``ConvBnAct``s and
    stay (as JAX's fold leaves them), so folded and ``--no-fuse`` agree."""
    from yoloseries_tpu_torch.cli.detect import main

    img_dir, _, names = folder
    args = ["--model", MODEL, "--ckpt-dir", str(checkpoints / "port"), "--img-dir",
            str(img_dir), "--name-path", str(names), "--input-size", str(SIZE),
            "--batch-size", "3", "--conf", "0.05", "--device", "cpu"]
    folded = main([*args, "--save-dir", str(tmp_path / "a")])
    unfused = main([*args, "--save-dir", str(tmp_path / "b"), "--no-fuse"])
    names_ = sorted(folded)
    assert sum(len(v) for v in folded.values()) > 0
    match_detections([np.asarray(folded[n]) for n in names_],
                     [np.asarray(unfused[n]) for n in names_], box_tol=1e-3, conf_tol=1e-5)

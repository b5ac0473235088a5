"""Port YOLOv7 (nn/layers.py's CSPCSPP, RepConv and implicit layers,
nn/deploy.py::fold_repconv, models/yolov7.py, losses/yolov7.py, the
``yolov7`` family and its evaluator quirks) against the JAX package.

* raw maps of YOLOv7 (its widths are fixed: a 64 px input keeps it small),
  JAX weights through ``state_dict_from_jax``, eval mode, within 1e-4 of
  each map's scale;
* ``state_dict`` names and shapes, the parameter count and the output
  shapes of ``yolov7`` (and of its deploy form) against ``jax.eval_shape``;
  the bridge back through ``convert_yolov7_state_dict`` leaf for leaf; the
  detect prior and the implicit priors' init;
* the OTA refinement: ``keep`` and the matched gt equal to JAX's
  ``_ota_refine_image`` element for element on random and edge cases
  (tied costs, duplicate and nested boxes, an image with no box, no live
  candidate); the class cost reduced over the classes against JAX's full
  (M, C, nc) sum within 1e-5;
* the loss dicts and the balances within 1e-5 relative;
* the dense and the fused decodes with the "v7" gate, the same candidates;
* two ``make_train_step`` updates against the JAX step;
* the RepConv fold (after the conv+BN fold) against JAX's ``fold_repconv``
  through the deploy models' maps, within 1e-4; the folded ``state_dict``
  loads into ``create_model("yolov7", deploy=True)``;
* the evaluator's v7 quirks (``conf_gate="v7"``, ``min_box_wh``) through
  the port's and JAX's ``Evaluator`` on the same weights, plain and TTA,
  and ``cli/detect.py`` folded (conv+BN and RepConv) against ``--no-fuse``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_families import (
    NC,
    SIZE,
    jax_param_count,
    jax_variables,
    map_err,
    match_detections,
    nchw,
    targets,
    two_updates,
    write_folder,
)

from yoloseries_tpu.evaluation.yolov5 import decode_topk_yolov5 as jax_decode_topk
from yoloseries_tpu.evaluation.yolov5 import decode_yolov5 as jax_decode
from yoloseries_tpu.losses import yolov7 as jax_loss
from yoloseries_tpu.losses.common import bce_with_logits as jax_bce
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.yolov7 import YOLOv7 as JaxYOLOv7
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.utils.torch_import import convert_yolov7_state_dict
from yoloseries_tpu_torch.evaluation.yolov5 import decode_topk_yolov5, decode_yolov5
from yoloseries_tpu_torch.losses import yolov7 as port_loss
from yoloseries_tpu_torch.models import YOLOv7, create_model
from yoloseries_tpu_torch.nn.layers import ImplicitAdd, ImplicitMul
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

MAP_TOL = 1e-4
NOISE = 0.005  # on every parameter: more makes 100 random layers blow the maps up


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def v7():
    model = JaxYOLOv7(num_class=NC)
    return model, *jax_variables(model, noise=NOISE)


def _port(params=None, stats=None, **kw):
    model = YOLOv7(NC, **kw)
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params, stats))
    return model.eval()


def _images(seed, b=2, size=SIZE):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------- models

def test_raw_maps_match_jax(v7):
    model, params, stats = v7
    x = _images(1)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(params, stats)(nchw(x))
    assert [g.shape[1] for g in got] == [3 * (5 + NC)] * 3
    assert map_err(got, ref) <= MAP_TOL


@pytest.mark.parametrize("deploy", [False, True])
def test_registered_model_matches_jax(deploy):
    """Parameter count, every ``state_dict`` name and shape (the JAX tree
    through the bridge) and the output shapes."""
    jax_model = jax_create_model("yolov7", num_class=NC, deploy=deploy)
    want_n, shapes = jax_param_count(jax_model)
    port = create_model("yolov7", num_class=NC, device="cpu", deploy=deploy)
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
    with pytest.raises(ValueError, match="yolov7.*s2d_stem"):
        create_model("yolov7", num_class=NC, device="cpu", s2d_stem=True)
    with pytest.raises(ValueError, match="retinanet.*deploy"):
        create_model("retinanet", num_class=NC, device="cpu", deploy=True)


def test_bridge_round_trips_through_convert_yolov7_state_dict(v7):
    _, params, stats = v7
    back_p, back_s = convert_yolov7_state_dict(_port(params, stats).state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_priors_match_jax_init():
    """The detect biases equal JAX's; the implicit priors are N(0, 0.02)
    and 1 + N(0, 0.02). The model's priors (24 channels a level at nc=3)
    come from a seeded generator: from the global one their mean and std
    depended on the tests run before in the same process. 4096 channels
    hold the distribution."""
    params = jax.jit(lambda: JaxYOLOv7(num_class=NC).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))()["params"]
    port = _port(generator=torch.Generator().manual_seed(0))
    for i, s in enumerate("sml"):
        np.testing.assert_allclose(getattr(port.detect, f"detect_{s}").bias.detach().numpy(),
                                   np.asarray(params[f"detect_{i}"]["bias"]), rtol=1e-6)
        add = getattr(port.detect, f"implicitadd_{s}").implicit.detach()
        mul = getattr(port.detect, f"implicitmul_{s}").implicit.detach()
        assert add.shape[1] == params[f"ia_{i}"]["implicit"].shape[-1]
        assert abs(float(add.std()) - 0.02) < 0.01 and abs(float(mul.mean()) - 1.0) < 0.01
    gen = torch.Generator().manual_seed(1)
    add, mul = ImplicitAdd(4096, gen).implicit.detach(), ImplicitMul(4096, gen).implicit.detach()
    assert abs(float(add.mean())) < 2e-3 and abs(float(add.std()) - 0.02) < 2e-3
    assert abs(float(mul.mean()) - 1.0) < 2e-3 and abs(float(mul.std()) - 0.02) < 2e-3


# --------------------------------------------------------- OTA refinement

def _ota_case(name, seed=0):
    """(cand_mask (C,), cand_box (C, 4) px xyxy, cand_cof (C,), cand_cls
    (C, nc), gt_xyxy (M, 4), gt_cls (M,), gt_valid (M,)) with M = 6 slots,
    A = 3 anchors, C = M*A*5."""
    rng = np.random.default_rng(seed)
    m, c = 6, 6 * 3 * 5
    gt = np.zeros((m, 4), np.float32)
    valid = np.zeros(m, bool)
    cls = rng.integers(0, NC, m)
    mask = rng.uniform(size=c) < 0.6
    ctr = rng.uniform(8, 56, (c, 2))
    wh = rng.uniform(4, 30, (c, 2))
    box = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    cof = rng.normal(0, 2, c)
    lg = rng.normal(0, 2, (c, NC))
    if name in ("random", "no_live"):
        xy = rng.uniform(0, 40, (5, 2))
        gt[:5] = np.concatenate([xy, xy + rng.uniform(6, 24, (5, 2))], 1)
        valid[:5] = True
        if name == "no_live":
            mask[:] = False
    elif name == "duplicates":
        gt[:4] = [[10, 10, 30, 26]] * 3 + [[30, 20, 50, 44]]
        cls[:3] = [1, 1, 2]
        valid[:4] = True
    elif name == "nested":
        gt[:4] = [[26, 26, 32, 32], [22, 22, 36, 36], [14, 16, 44, 40], [4, 6, 60, 58]]
        valid[:4] = True
    elif name == "ties":  # every candidate the same box and logits: equal costs
        box[:] = [20, 20, 40, 40]
        cof[:] = 0.5
        lg[:] = lg[0]
        gt[:3] = [[20, 20, 40, 40], [16, 24, 38, 42], [24, 18, 46, 36]]
        valid[:3] = True
    elif name != "empty":
        raise ValueError(name)
    f32 = np.float32
    return (mask, box.astype(f32), cof.astype(f32), lg.astype(f32), gt, cls.astype(np.int32),
            valid)


@pytest.mark.parametrize("topk", [10, 3])
@pytest.mark.parametrize("name", ["random", "empty", "no_live", "duplicates", "nested", "ties"])
def test_ota_assignment_matches_jax(name, topk):
    case = _ota_case(name)
    jcfg = jax_loss.YOLOv7LossConfig(num_class=NC, input_size=(SIZE, SIZE), topk=topk)
    pcfg = port_loss.YOLOv7LossConfig(num_class=NC, input_size=(SIZE, SIZE), topk=topk)
    keep_j, gt_j = jax.jit(lambda *a: jax_loss._ota_refine_image(*a, jcfg))(*case)
    t = [torch.from_numpy(np.asarray(a))[None] for a in case]
    t[5] = t[5].long()
    keep, matched = port_loss.ota_refine(*t, pcfg)
    keep, matched = keep[0].numpy(), matched[0].numpy()
    np.testing.assert_array_equal(keep, np.asarray(keep_j))
    np.testing.assert_array_equal(matched[keep], np.asarray(gt_j)[keep])
    assert keep.any() == (name not in ("empty", "no_live"))


def test_ota_class_cost_matches_the_full_sum():
    """The (M, C) class cost from one reduction over the classes per
    candidate against JAX's sum over the (M, C, nc) BCE terms."""
    mask, box, cof, lg, gt, cls, valid = _ota_case("random", seed=3)
    joint = jnp.sqrt(jnp.clip(jax.nn.sigmoid(lg) * jax.nn.sigmoid(cof)[:, None], 1e-9,
                              1 - 1e-9))
    logit = jnp.log(joint / (1.0 - joint))
    want = jnp.sum(jax_bce(logit[None], jax.nn.one_hot(cls, NC)[:, None, :]), axis=-1)
    got = port_loss.ota_class_cost(torch.from_numpy(cof)[None], torch.from_numpy(lg)[None],
                                   torch.from_numpy(cls).long()[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("kw", [
    {},
    {"use_focal_loss": True, "use_iou_as_tar_cof": False, "topk": 15},
    {"image_chunk": 1, "label_smoothing": 0.0},
], ids=["default", "focal_keep_target_topk15", "chunk1"])
def test_loss_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    b = 3  # image_chunk 2 leaves a ragged last chunk
    maps = [rng.normal(0, 1, (b, SIZE // s, SIZE // s, 3 * (5 + NC))).astype(np.float32)
            for s in (8, 16, 32)]
    t = targets(rng, b, 6)
    t[1] = -1.0  # an image without targets
    bal = np.array([4.0, 1.3, 0.4], np.float32)
    kw = {"image_chunk": 2, **kw}
    want, want_bal = jax_loss.yolov7_loss(
        [jnp.asarray(m) for m in maps], jnp.asarray(t), jnp.asarray(YOLOV5_ANCHORS),
        jnp.asarray(bal), jax_loss.YOLOv7LossConfig(num_class=NC, input_size=(SIZE, SIZE), **kw))
    got, got_bal = port_loss.yolov7_loss(
        [nchw(m) for m in maps], torch.from_numpy(t), YOLOV5_ANCHORS, torch.from_numpy(bal),
        port_loss.YOLOv7LossConfig(num_class=NC, input_size=(SIZE, SIZE), **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["tar_nums"]) == float(want["tar_nums"]) > 0
    np.testing.assert_allclose(got_bal.numpy(), np.asarray(want_bal), rtol=1e-5)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("conf, cls_thr, k", [(0.25, 0.1, 64), (0.25, 0.1, 2048),
                                              (0.001, 0.001, 4096)],
                         ids=["serving", "serving_all", "protocol"])
def test_decodes_with_the_v7_gate_match_jax(conf, cls_thr, k):
    """cls_thr < conf: the gates differ (obj >= conf passes v5, obj*cls >=
    conf is v7's), which shows where K holds every candidate (N = 1008)."""
    rng = np.random.default_rng(2)
    maps = [rng.normal(0, 1.5, (2, 128 // s, 128 // s, 3 * (5 + NC))).astype(np.float32)
            for s in (8, 16, 32)]
    anchors = jnp.asarray(YOLOV5_ANCHORS)
    dense = decode_yolov5([nchw(m) for m in maps])
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_decode([jnp.asarray(m) for m in maps],
                                                                     anchors)), atol=1e-4,
                               rtol=1e-5)
    for select in ("topk", "sort"):
        got = decode_topk_yolov5([nchw(m) for m in maps], k=k, conf_threshold=conf,
                                 cls_threshold=cls_thr, conf_gate="v7", select=select)
        want = jax_decode_topk([jnp.asarray(m) for m in maps], anchors, k=k,
                               conf_threshold=conf, cls_threshold=cls_thr, conf_gate="v7",
                               select=select)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-5)
        v5 = decode_topk_yolov5([nchw(m) for m in maps], k=k, conf_threshold=conf,
                                cls_threshold=cls_thr, select=select)
        assert (got[1] > 0).sum() > 0
        if conf > cls_thr and k >= dense.shape[1]:
            assert (got[1] > 0).sum() < (v5[1] > 0).sum()


# ------------------------------------------------------------- training

def test_two_updates_match_jax(v7):
    """Two updates from the same weights. This random 100-layer net is
    touchy in f32 (gradient norm ~1e5): the first update's loss entries
    agree within 2e-4 and its assignments exactly; after the second, the
    total loss, the parameters, the BN statistics, their EMAs, the gradient
    norm and the balances within 1e-3, the card-vs-CPU ``TRAIN_TOL`` of
    ``chip_smoke.py`` (the f32 drift of the first update moves one of ~230
    OTA candidates in the second, so its loss parts are not held). The
    port's BN takes the JAX one-pass batch variance here (``forward``
    patched to ``nn/layers.py::BatchNorm._one_pass``), and the bias group's
    warmup lr starts at 0: at 0.1 it throws every bias of this net by up to
    1 an update."""
    model, params, stats = v7
    worst, each, metrics = two_updates(model, params, stats, _port(), "yolov7",
                                       convert_yolov7_state_dict, one_pass_bn=True,
                                       warmup_bias_max_lr=0.0)
    msg = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    assert metrics["tar_nums"] > 0
    assert each[0]["tar_nums"] == 0, msg
    for k in ("tot_loss", "iou_loss", "cof_loss", "cls_loss", "grad_norm"):
        assert each[0][k] <= 2e-4, (k, each[0])
    for k in ("tot_loss", "grad_norm", "params", "batch_stats", "ema_params", "ema_batch_stats",
              "balances"):
        assert worst[k] <= 1e-3, msg


# ------------------------------------------------------------------ fold

def test_repconv_fold_matches_jax(v7):
    """conv+BN then RepConv folded in both packages: the deploy models'
    maps agree within 1e-4 and with the unfolded model's; RepConv folded
    alone gives the ``state_dict`` of ``create_model("yolov7",
    deploy=True)``, key for key."""
    from yoloseries_tpu.nn.deploy import fold_conv_bn as jax_fold_conv_bn
    from yoloseries_tpu.nn.deploy import fold_repconv as jax_fold_repconv
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn, fold_repconv
    from yoloseries_tpu_torch.nn.layers import RepConv

    _, params, stats = v7
    p_f, s_f = jax_fold_repconv(*jax_fold_conv_bn(params, stats))
    x = _images(5)
    want = JaxYOLOv7(num_class=NC, deploy=True).apply({"params": p_f, "batch_stats": s_f},
                                                     jnp.asarray(x), train=False)
    port = _port(params, stats)
    with torch.no_grad():
        ref = port(nchw(x))
        folded = fold_repconv(fold_conv_bn(port))
        got = folded(nchw(x))
    reps = [m for m in folded.modules() if isinstance(m, RepConv)]
    assert folded.deploy and len(reps) == 3 and all(m.deploy for m in reps)
    assert map_err(got, want) <= MAP_TOL
    assert map_err(got, [np.asarray(a) for a in map(lambda t: t.permute(0, 2, 3, 1).numpy(),
                                                     ref)]) <= MAP_TOL
    rep = folded.head.head_output_repconv1.rbr_reparam
    np.testing.assert_allclose(rep.weight.detach().numpy().transpose(2, 3, 1, 0),
                               np.asarray(p_f["rep_s"]["rbr_reparam"]["kernel"]), atol=1e-5)
    deploy = create_model("yolov7", num_class=NC, device="cpu", deploy=True)
    deploy.load_state_dict(fold_repconv(_port(params, stats)).state_dict())  # strictly


# ------------------------------------------------------- evaluator quirks

@pytest.fixture(scope="module")
def wide(v7):
    """The weights with the detect convs widened (kernel N(0, 0.02), bias 0;
    the implicit priors at 0 and 1): random weights put every score at the
    prior, so the gates and the merge would see nothing."""
    _, params, stats = v7
    params = jax.tree_util.tree_map(np.copy, params)
    rng = np.random.default_rng(0)
    for i in range(3):
        leaf = params[f"detect_{i}"]
        leaf["kernel"] = rng.normal(0, 0.02, leaf["kernel"].shape).astype(np.float32)
        leaf["bias"] = np.zeros_like(leaf["bias"])
    return params, stats


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_evaluator_v7_quirks_match_jax(wide, tta, fused):
    """The family's overrides (``conf_gate="v7"``, ``min_box_wh`` 30 px: w
    and h strictly above) through both evaluators on the same weights: the
    same detections, and fewer than without the overrides."""
    from yoloseries_tpu.evaluation.yolov5 import EvalConfig as JaxEvalConfig
    from yoloseries_tpu.evaluation.yolov5 import Evaluator as JaxEvaluator
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family

    params, stats = wide
    hyp = {"min_prediction_box_wh": 30}
    kw = dict(conf_threshold=0.05, cls_threshold=0.02, iou_threshold=0.45, num_candidates=512,
              use_tta=tta)
    jfam, pfam = jax_family("yolov7"), get_family("yolov7")
    jcfg = jfam.apply_eval_overrides(JaxEvalConfig(**kw), hyp)
    pcfg = pfam.apply_eval_overrides(EvalConfig(**kw), hyp)
    assert (pcfg.conf_gate, pcfg.min_box_wh) == ("v7", 30.0) == (jcfg.conf_gate,
                                                                 jcfg.min_box_wh)
    size = (SIZE, SIZE)
    jsel = jfam.make_select(hyp, NC, size)(jcfg) if fused else None
    psel = pfam.make_select(hyp, NC, size)(pcfg) if fused else None
    jev = JaxEvaluator(JaxYOLOv7(num_class=NC).apply, jfam.make_decode(hyp, NC, size), jcfg,
                       select_fn=jsel)
    pev = Evaluator(_port(params, stats), pfam.make_decode(hyp, NC, size), pcfg, select_fn=psel,
                    device="cpu")
    img = (_images(7, b=3) * 255).astype(np.uint8)
    want = np.asarray(jev({"params": params, "batch_stats": stats}, img))
    got = pev(img).numpy()
    match_detections([g[g[:, 4] > 0] for g in got], [w[w[:, 4] > 0] for w in want],
                     box_tol=1e-3, conf_tol=1e-5)
    live = got[got[:, :, 4] > 0]
    assert len(live) > 0
    assert ((live[:, 2] - live[:, 0] > 30) & (live[:, 3] - live[:, 1] > 30)).all()
    plain = Evaluator(pev.model, pev.decode_fn, EvalConfig(**kw), select_fn=None, device="cpu")
    assert (plain(img).numpy()[..., 4] > 0).sum() > len(live)


@pytest.fixture(scope="module")
def checkpoint(wide, tmp_path_factory):
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, save_checkpoint

    params, stats = wide
    root = tmp_path_factory.mktemp("port_yolov7")
    state = create_train_state(_port(params, stats), OptimizerConfig(), device="cpu")
    save_checkpoint(root / "ckpt", state, 1)
    return root


def test_detect_folds_repconv(checkpoint, tmp_path, capsys):
    """``cli/detect.py --model yolov7``: conv+BN and RepConv folded (the
    default) against ``--no-fuse``, the same detections."""
    from yoloseries_tpu_torch.cli.detect import main

    img_dir, _, names = write_folder(tmp_path / "set", n=4)
    args = ["--model", "yolov7", "--ckpt-dir", str(checkpoint / "ckpt"), "--img-dir",
            str(img_dir), "--name-path", str(names), "--input-size", str(SIZE),
            "--batch-size", "2", "--conf", "0.02", "--device", "cpu"]
    folded = main([*args, "--save-dir", str(tmp_path / "a")])
    assert "reparameterized RepConv" in capsys.readouterr().out
    unfused = main([*args, "--save-dir", str(tmp_path / "b"), "--no-fuse"])
    names_ = sorted(folded)
    assert sum(len(v) for v in folded.values()) > 0
    match_detections([np.asarray(folded[n]) for n in names_],
                     [np.asarray(unfused[n]) for n in names_], box_tol=1e-3, conf_tol=1e-5)

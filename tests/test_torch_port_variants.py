"""The YOLOv5 variants of the port (yoloseries_tpu_torch) against the JAX package.

* Each new block (``DWConvBnAct``, ``Focus``, ``SPP``, ``BottleneckCSP``)
  against its JAX counterpart from the same weights: eval mode at 1e-5;
  train mode at 1e-3 with the BN running stats at 1e-4 (the JAX BN takes
  the batch variance in one pass, torch in two);
* ``s``, ``s_plain``, ``s_dw`` and a narrow depthwise spec, JAX init
  (perturbed) -> ``state_dict_from_jax`` -> the port: raw maps at
  atol/rtol 1e-4;
* all nine specs' ``state_dict`` names and shapes against JAX's
  ``jax.eval_shape`` of ``init``, through ``state_dict_key``;
* the depthwise, Focus and SPP names read back by JAX's
  ``convert_yolov5_state_dict`` (``s_plain`` goes one way only);
* the s2d stem: ``space_to_depth2`` and the kernel map against JAX's, both
  ways, exactly; the s2d model against the 6x6 model at 1e-4;
* ``fold_conv_bn`` against JAX's ``fold_conv_bn``: raw maps at 1e-4, the
  detections through ``Evaluator`` at rtol 2e-3 / atol 5e-3 (the tolerance
  of the JAX package's own fold test); a folded JAX tree loaded into the
  unfused port model against the port's own fold at 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.evaluation import EvalConfig as JaxEvalConfig
from yoloseries_tpu.evaluation import Evaluator as JaxEvaluator
from yoloseries_tpu.evaluation.yolov5 import decode_topk_yolov5 as jax_decode_topk
from yoloseries_tpu.models.yolov5 import YOLOV5_SIZES as JAX_SIZES
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.models.yolov5 import space_to_depth2 as jax_s2d
from yoloseries_tpu.nn import deploy as jax_deploy
from yoloseries_tpu.nn import layers as jax_layers
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.utils.torch_import import convert_yolov5_state_dict
from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, yolov5_select_fn
from yoloseries_tpu_torch.models import YOLOV5_SIZES, YOLOv5, YOLOv5Spec, space_to_depth2
from yoloseries_tpu_torch.nn import layers
from yoloseries_tpu_torch.nn.deploy import (
    fold_conv_bn,
    fold_stem_from_s2d,
    fold_stem_to_s2d,
    stem_kernel_from_s2d,
    stem_kernel_to_s2d,
)
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax, state_dict_key

NC = 4
SIZE = 64
TOL = dict(atol=1e-4, rtol=1e-4)
NARROW_DW = (16, (1, 1, 1, 1), 1, True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturb(variables, seed):
    """Params x (1 + N(0, 0.1)) + N(0, 0.01); BN means N(0, 0.1), variances
    U(0.5, 1.5). The maps of a full-width model stay O(10), where f32 sums
    in another order agree to 1e-4."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1 + rng.normal(0, 0.1, x.shape))
                   + rng.normal(0, 0.01, x.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = {k: (rng.normal(0, 0.1, v.shape) if k[-1] == "mean"
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
             for k, v in flatten_tree(jax.device_get(variables["batch_stats"])).items()}
    return params, _unflatten(stats)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- blocks

BLOCKS = {  # name: (JAX module, port module, trunk slot the bridge maps, input channels)
    "dw": (lambda: jax_layers.DWConvBnAct(24, 3, 2), lambda: layers.DWConvBnAct(16, 24, 3, 2),
           "b1_conv", 16),
    "focus": (lambda: jax_layers.Focus(16, 3, 1), lambda: layers.Focus(3, 16, 3, 1), "stem", 3),
    "spp": (lambda: jax_layers.SPP(24), lambda: layers.SPP(32, 24), "b4_spp", 32),
    "bscp": (lambda: jax_layers.BottleneckCSP(24, True, 2),
             lambda: layers.BottleneckCSP(16, 24, True, 2), "b1_csp", 16),
    "bscp_noshort": (lambda: jax_layers.BottleneckCSP(16, False, 1),
                     lambda: layers.BottleneckCSP(16, 16, False, 1), "b1_csp", 16),
}


def _block_pair(name, seed=0):
    make_jax, make_port, slot, cin = BLOCKS[name]
    jmod = make_jax()
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (2, 16, 16, cin)).astype(np.float32)
    params, stats = _perturb(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    sd = state_dict_from_jax({"trunk": {slot: params}}, {"trunk": {slot: stats}})
    prefix = state_dict_key(("trunk", slot, "x", "kernel")).split(".")[0] + "."
    port = make_port()
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return jmod, params, stats, port, x


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jmod, params, stats, port, x = _block_pair(name)
    ref = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5, rtol=1e-5)

    ref, upd = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-3, rtol=1e-3)
    _, slot = BLOCKS[name][2], BLOCKS[name][2]
    want = state_dict_from_jax({"trunk": {slot: params}},
                               {"trunk": {slot: jax.device_get(upd["batch_stats"])}})
    got_sd = port.state_dict()
    for key, value in want.items():
        short = key.split(".", 1)[1]
        if "running" in key:
            np.testing.assert_allclose(got_sd[short].numpy(), value.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=short)


def test_focus_channel_order():
    """Row parity varies fastest: (0, 0), (1, 0), (0, 1), (1, 1); not the
    (dy, dx) order of ``space_to_depth2``."""
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    focus = layers.Focus(1, 4, 1, 1)
    focus.conv = torch.nn.Identity()
    np.testing.assert_array_equal(focus(x)[0, :, 0, 0].numpy(), [0, 4, 1, 5])
    np.testing.assert_array_equal(space_to_depth2(x)[0, :, 0, 0].numpy(), [0, 1, 4, 5])


# ---------------------------------------------------------------- models

def _jax_model(spec, seed=0, **kw):
    model = JaxYOLOv5(num_class=NC, spec=spec, **kw)
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(seed),
                                           jnp.zeros((1, SIZE, SIZE, 3)), train=False))()
    params, stats = _perturb(variables, seed)
    return model, params, stats


@pytest.mark.parametrize("spec", ["s", "s_plain", "s_dw", "narrow_dw"])
def test_model_matches_jax(spec):
    jspec = JaxSpec(*NARROW_DW) if spec == "narrow_dw" else JAX_SIZES[spec]
    pspec = YOLOv5Spec(*NARROW_DW) if spec == "narrow_dw" else YOLOV5_SIZES[spec]
    model, params, stats = _jax_model(jspec)
    x = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = YOLOv5(NC, pspec)
    port.load_state_dict(state_dict_from_jax(params, stats))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


@pytest.mark.parametrize("size", sorted(YOLOV5_SIZES))
def test_state_dict_names_and_shapes_match_jax(size):
    model = JaxYOLOv5(num_class=80, spec=JAX_SIZES[size])
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    want = {}
    for path, leaf in {**flatten_tree(shapes["params"]),
                       **flatten_tree(shapes["batch_stats"])}.items():
        shape = tuple(leaf.shape)
        want[state_dict_key(path)] = (shape[3], shape[2], shape[0], shape[1]) \
            if path[-1] == "kernel" else shape
    with torch.device("meta"):
        port = YOLOv5(80, YOLOV5_SIZES[size])
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


def test_dw_focus_spp_names_read_back_by_jax():
    _, params, stats = _jax_model(JaxSpec(*NARROW_DW))
    port = YOLOv5(NC, YOLOv5Spec(*NARROW_DW))
    port.load_state_dict(state_dict_from_jax(params, stats))
    back_p, back_s = convert_yolov5_state_dict(port.state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert any(k[2] == "dw" for k in flatten_tree(back_p))


def test_create_model_builds_every_spec():
    from yoloseries_tpu_torch.models import available_models, create_model

    names = [f"yolov5{s}" for s in YOLOV5_SIZES]
    assert names == available_models()[:9]
    for name in ("yolov5s_plain", "yolov5s_dw"):
        model = create_model(name, num_class=NC, device="cpu")
        with torch.no_grad():
            out = model(torch.zeros(1, 3, SIZE, SIZE))
        assert [tuple(o.shape) for o in out] == [(1, 27, 8, 8), (1, 27, 4, 4), (1, 27, 2, 2)]


# ------------------------------------------------------------------ s2d

def test_space_to_depth_and_stem_map_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(space_to_depth2(_nchw(x))), np.asarray(jax_s2d(x)))
    k6 = rng.normal(size=(6, 6, 3, 5)).astype(np.float32)  # HWIO
    k3 = np.asarray(jax_deploy.stem_kernel_to_s2d(jnp.asarray(k6)))
    got3 = stem_kernel_to_s2d(torch.from_numpy(k6.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got3.numpy(), k3.transpose(3, 2, 0, 1))
    back = stem_kernel_from_s2d(got3)
    np.testing.assert_array_equal(back.numpy(), k6.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        np.asarray(jax_deploy.stem_kernel_from_s2d(jnp.asarray(k3))), k6)
    with pytest.raises(ValueError):
        stem_kernel_to_s2d(got3)


def test_s2d_model_matches_6x6_model():
    model = YOLOv5(NC, YOLOV5_SIZES["s"]).eval()
    s2d = YOLOv5(NC, YOLOV5_SIZES["s"], s2d_stem=True).eval()
    sd = fold_stem_to_s2d(model.state_dict())
    s2d.load_state_dict(sd)
    assert torch.equal(fold_stem_from_s2d(sd)["focus.conv.weight"],
                       model.state_dict()["focus.conv.weight"])
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a, b in zip(model(x), s2d(x)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


# ----------------------------------------------------------------- fold

def test_fold_conv_bn_matches_jax_fold():
    model, params, stats = _jax_model(JAX_SIZES["s"], seed=3)
    rng = np.random.default_rng(3)
    for head in params["detect"].values():  # scores above the protocol thresholds
        head["kernel"] = rng.normal(0, 0.3, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    p_f, s_f = jax_deploy.fold_conv_bn(params, stats)
    x = np.random.default_rng(7).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply({"params": p_f, "batch_stats": s_f}, jnp.asarray(x))
    unfused = YOLOv5(NC, YOLOV5_SIZES["s"]).eval()
    unfused.load_state_dict(state_dict_from_jax(params, stats))
    port = fold_conv_bn(copy.deepcopy(unfused))
    assert not any(isinstance(m, layers.ConvBnAct) and isinstance(m.bn, layers.BatchNorm)
                   for m in port.modules())
    with torch.no_grad():
        got = port(_nchw(x))
        # the folded JAX tree through the bridge into the unfused model:
        # the BN is "+bias" there, the same function as the port's fold
        via_bridge = YOLOv5(NC, YOLOV5_SIZES["s"]).eval()
        via_bridge.load_state_dict(state_dict_from_jax(jax.device_get(p_f),
                                                       jax.device_get(s_f)))
        bridged = via_bridge(_nchw(x))
    for g, r, b in zip(got, ref, bridged):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)
        np.testing.assert_allclose(b.numpy(), g.numpy(), atol=1e-5, rtol=1e-5)

    cfg = dict(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
               num_candidates=256, max_keep=50)
    jev = JaxEvaluator(model.apply, None, JaxEvalConfig(**cfg), select_fn=lambda p:
                       jax_decode_topk(p, YOLOV5_ANCHORS, 256, 0.001, 0.001))
    want = np.asarray(jev({"params": p_f, "batch_stats": s_f}, x))
    pcfg = EvalConfig(**cfg)
    got = Evaluator(port, None, pcfg, yolov5_select_fn(pcfg), device="cpu")(x).numpy()
    assert (want[..., 4] > 0).sum() > 15
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-3)

"""Port YOLOv5 model (yoloseries_tpu_torch.models) against the JAX graph.

JAX init (perturbed with numpy noise so BN scale/bias/mean/var are not the
identity) -> ``state_dict_from_jax`` -> the port; raw maps must agree at
atol/rtol 1e-4 (f32, the convolutions sum in another order) in eval mode.
In train mode the JAX BatchNorm takes the batch variance in one pass
(E[x^2] - E[x]^2) and torch in two, which moves the maps by up to ~2e-4
after a dozen layers, so that check holds them at 1e-3; the BN running
stats must update alike. The bridge back (``convert_yolov5_state_dict``)
must rebuild the JAX trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.utils.torch_import import convert_yolov5_state_dict
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec, create_model
from yoloseries_tpu_torch.nn.layers import detect_bias_init
from yoloseries_tpu_torch.utils.weights import (
    flatten_tree,
    state_dict_from_jax,
    unflatten_tree,
)

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_variables(seed=0):
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32),
        variables["params"])
    stats = flatten_tree(jax.device_get(variables["batch_stats"]))
    stats = {k: (rng.normal(0, 0.1, v.shape) if k[-1] == "mean"
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
             for k, v in stats.items()}
    return model, jax.device_get(params), unflatten_tree(stats)


def _port(params, stats):
    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    port.load_state_dict(state_dict_from_jax(params, stats))
    return port.eval()


def test_raw_maps_match_jax_eval():
    model, params, stats = _jax_variables()
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(params, stats)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), **TOL)


def test_raw_maps_and_bn_stats_match_jax_train():
    model, params, stats = _jax_variables(seed=2)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref, upd = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"])
    port = _port(params, stats).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   atol=1e-3, rtol=1e-3)
    _, new_stats = convert_yolov5_state_dict(port.state_dict(), NC)
    want = flatten_tree(jax.device_get(upd["batch_stats"]))
    got_stats = flatten_tree(new_stats)
    assert set(got_stats) == set(want)
    for k in want:
        np.testing.assert_allclose(got_stats[k], want[k], atol=1e-5, rtol=1e-4)


def test_bridge_round_trip_keys_and_shapes():
    _, params, stats = _jax_variables()
    port = _port(params, stats)
    back_p, back_s = convert_yolov5_state_dict(port.state_dict(), NC)
    for ours, theirs in ((back_p, params), (back_s, stats)):
        a, b = flatten_tree(ours), flatten_tree(theirs)
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == np.asarray(b[k]).shape
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_yolov5s_parameter_count():
    model = create_model("yolov5s", num_class=80, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 7_235_389


def test_detect_bias_prior_matches_jax_init():
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)["params"]
    port = create_model("yolov5s", num_class=NC, device="cpu")
    for i, (name, stride) in enumerate(zip(("detect_small", "detect_mid", "detect_large"),
                                           (8, 16, 32))):
        want = np.asarray(params["detect"][f"detect_{i}"]["bias"])
        np.testing.assert_allclose(detect_bias_init(stride, NC, 3).numpy(), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(getattr(port.detect, name).bias.detach().numpy(),
                                   want, rtol=1e-6)


def test_unported_specs_raise():
    """yolov5s_dw builds (the test's name dates from when it raised), with
    the JAX model's parameter count; an unknown name raises."""
    from yoloseries_tpu.models.yolov5 import YOLOV5_SIZES as JAX_SIZES

    jax_model = JaxYOLOv5(num_class=NC, spec=JAX_SIZES["s_dw"])
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    port = create_model("yolov5s_dw", num_class=NC, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == want
    with pytest.raises(KeyError):
        create_model("yolov9", num_class=NC, device="cpu")


def test_model_is_seeded():
    a = create_model("yolov5s", num_class=NC, device="cpu", seed=3)
    b = create_model("yolov5s", num_class=NC, device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)

"""The last public names of the JAX package, held against it through the
weight bridge (``utils/weights.py::state_dict_from_jax``).

* ``ELANBlock``, ``SEBottleneckCSP`` and ``SqueezeExcitation`` (a block's
  tree converted with ``family="block"``): outputs in eval and train mode
  within 1e-5 of JAX's (BN in train mode within 1e-4: JAX's one-pass
  variance against the port's two-pass);
* ``dfl_integral`` and ``ops/boxes.py::xywhn2xyxy`` within 1e-6;
* ``CropClassifier`` (ResNet blocks (1, 1, 1, 1), 64 px): logits within
  1e-4 of JAX's through the bridge; from JAX's init, the gradient of the
  cross-entropy within 1e-2 of ``jax.grad``'s in relative L2 (the family
  update tests' gradient-norm tolerance: five train-mode BNs of random
  weights spread f32 rounding through the backward), and one ``train_classifier``
  step against JAX's: the loss within 1e-4 of the one JAX logs, 99.99% of
  the parameters and BN statistics within 1e-5 and every one within 2 lr
  (BN in JAX's one-pass form, as the YOLOv7 update test runs it);
* ``kmeans_anchors``: the same anchors and mean best IoU for the same seed;
* ``crop_classifier_batches``: the same batches, byte for byte.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_families import rel_diff
from yoloseries_tpu.data.classifier_data import crop_classifier_batches as jax_batches
from yoloseries_tpu.models.classifier import CropClassifier as JaxClassifier
from yoloseries_tpu.models.classifier import train_classifier as jax_train_classifier
from yoloseries_tpu.nn import layers as jl
from yoloseries_tpu.ops.boxes import xywhn2xyxy as jax_xywhn2xyxy
from yoloseries_tpu.ops.kmeans_anchors import kmeans_anchors as jax_kmeans
from yoloseries_tpu_torch.data.classifier_data import crop_classifier_batches
from yoloseries_tpu_torch.models.classifier import CropClassifier, train_classifier
from yoloseries_tpu_torch.nn import layers as pl
from yoloseries_tpu_torch.ops.boxes import xywhn2xyxy
from yoloseries_tpu_torch.ops.kmeans_anchors import kmeans_anchors
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

LAYERS = (1, 1, 1, 1)
BN_FORWARD = pl.BatchNorm.forward


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _init(module, x, noise=0.05, **kw):
    """JAX variables with N(0, noise) on every parameter and BN statistics
    away from the identity."""
    variables = jax.device_get(module.init(jax.random.PRNGKey(0), x, **kw))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, noise, a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.1, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return params, stats


@pytest.mark.parametrize("name", ["ELANBlock", "SEBottleneckCSP", "SqueezeExcitation"])
def test_blocks_match_jax(name):
    x = np.random.default_rng(2).normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    if name == "ELANBlock":
        jm, pm = jl.ELANBlock(8, 12, depth=2), pl.ELANBlock(8, 8, 12, depth=2)
    elif name == "SEBottleneckCSP":
        jm, pm = jl.SEBottleneckCSP(12, num_blocks=2), pl.SEBottleneckCSP(8, 12, num_blocks=2)
    else:
        jm, pm = jl.SqueezeExcitation(), pl.SqueezeExcitation(8)
    kw = {} if name == "SqueezeExcitation" else {"train": False}
    params, stats = _init(jm, x, **kw)
    sd = state_dict_from_jax(params, stats, family="block")
    assert set(sd) == set(pm.state_dict()), set(sd) ^ set(pm.state_dict())
    pm.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    variables = {"params": params, "batch_stats": stats}
    want = jm.apply(variables, x, **kw)
    assert rel_diff(_nhwc(pm.eval()(xt)), np.asarray(want)) <= 1e-5
    if kw:
        want, _ = jm.apply(variables, x, train=True, mutable=["batch_stats"])
        assert rel_diff(_nhwc(pm.train()(xt)), np.asarray(want)) <= 1e-4


def test_dfl_integral_and_xywhn2xyxy_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(pl.dfl_integral(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.dfl_integral(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pl.dfl_integral(torch.from_numpy(x[..., :32]), 8).numpy(),
                               np.asarray(jl.dfl_integral(jnp.asarray(x[..., :32]), 8)),
                               atol=1e-6, rtol=1e-6)
    b = rng.uniform(0, 1, (3, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(xywhn2xyxy(torch.from_numpy(b), (640, 480)).numpy(),
                               np.asarray(jax_xywhn2xyxy(jnp.asarray(b), (640, 480))),
                               atol=1e-6 * 640, rtol=0)


def test_classifier_matches_jax():
    size, nc = 64, 5
    jm = JaxClassifier(num_class=nc, resnet_layers=LAYERS)
    x = np.random.default_rng(4).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    params, stats = _init(jm, x, train=False)
    pm = CropClassifier(nc, resnet_layers=LAYERS)
    sd = state_dict_from_jax(params, stats)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    want = jm.apply({"params": params, "batch_stats": stats}, x)
    got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    assert rel_diff(got, np.asarray(want)) <= 1e-4


def _one_pass_bn(self, x):
    """Training BN in the JAX one-pass form (``BatchNorm._one_pass``), as
    ``torch_port_families.two_updates(one_pass_bn=True)`` runs it: at the
    classifier's last stage a batch has few values per channel, where the
    one-pass and two-pass variances part."""
    if not self.training:
        return BN_FORWARD(self, x)
    return self._one_pass(x, False)


def test_train_classifier_matches_jax():
    """The gradient of the loss, then one ``train_classifier`` step (Adam
    moves an element by about lr whatever its gradient's size, so the few
    elements whose gradient is within f32 noise of 0 may step the other
    way: 2 lr at most; further steps would spread that through the
    forward)."""
    import optax
    import torch.nn.functional as F

    size, nc = 64, 4
    rng = np.random.default_rng(5)
    imgs = rng.normal(0, 1, (4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, nc, 4)
    jm = JaxClassifier(num_class=nc, resnet_layers=LAYERS)
    init = jax.device_get(jm.init(jax.random.PRNGKey(7), jnp.zeros((1, size, size, 3)),
                                  train=False))

    def loss_fn(p):
        logits, _ = jm.apply({"params": p, "batch_stats": init["batch_stats"]}, imgs,
                             train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    want_grad = state_dict_from_jax(jax.device_get(jax.grad(loss_fn)(init["params"])), {})
    pm = CropClassifier(nc, resnet_layers=LAYERS)
    pm.load_state_dict(state_dict_from_jax(init["params"], init["batch_stats"]))
    with mock.patch.object(pl.BatchNorm, "forward", _one_pass_bn):
        F.cross_entropy(pm.train()(torch.from_numpy(imgs).permute(0, 3, 1, 2)),
                        torch.from_numpy(labels)).backward()
        got_grad = torch.cat([p.grad.reshape(-1) for p in pm.parameters()])
        ref_grad = torch.cat([want_grad[n].reshape(-1) for n, _ in pm.named_parameters()])
        rel = float((got_grad - ref_grad).norm() / ref_grad.norm())
        assert rel <= 1e-2, rel
        pm.load_state_dict(state_dict_from_jax(init["params"], init["batch_stats"]))
        losses = train_classifier(pm, [(imgs, labels)], log_fn=lambda *a: None)
    logged = []
    want = jax.device_get(jax_train_classifier(jm, [(imgs, labels)], jax.random.PRNGKey(7),
                                               (1, size, size, 3), log_fn=logged.append))
    assert abs(losses[0] - float(logged[0].split("loss ")[1].split()[0])) <= 1e-4
    got = state_dict_from_jax(want["params"], want["batch_stats"])
    ours = pm.state_dict()
    diffs = torch.cat([(ours[k] - v).abs().reshape(-1) for k, v in got.items()
                       if not k.endswith("num_batches_tracked")])
    assert float(diffs.max()) <= 2 * 1e-3 * 1.01, float(diffs.max())
    assert float((diffs <= 1e-5).float().mean()) >= 0.9999


def test_kmeans_anchors_match_jax():
    whs = np.random.default_rng(6).lognormal(3.5, 0.8, (600, 2))
    got, got_iou = kmeans_anchors(whs, k=9, seed=2)
    want, want_iou = jax_kmeans(whs, k=9, seed=2)
    np.testing.assert_array_equal(got, want)
    assert got_iou == want_iou and got.shape == (9, 2)


def test_classifier_batches_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(7):
        img = rng.integers(0, 256, (int(rng.integers(20, 50)), int(rng.integers(20, 50)), 3),
                           dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / f"img_{i}_class{i % 3}_car_{i}.png")
    kw = dict(img_size=(24, 32), batch_size=3, seed=1, epochs=2)
    got, want = list(crop_classifier_batches(tmp_path, **kw)), list(jax_batches(tmp_path, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["img"].tobytes() == w["img"].tobytes()
        np.testing.assert_array_equal(g["cls"], w["cls"])
        assert g["lab"] == w["lab"] == ["car"] * 3

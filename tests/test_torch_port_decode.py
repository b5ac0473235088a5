"""Port YOLOv5 decoders against the JAX package on identical raw maps.

The JAX maps are NHWC (B, H, W, A*(5+nc)); the port's are the same numbers
as NCHW. Dense decode: atol 1e-4 (sigmoid in another library). Fused
selection: the same candidate indices in the same order (so the same
scores, exactly up to sigmoid ulps: atol 1e-6) and boxes at atol 1e-4, for
the "topk" engine (K <= 1024) and the "sort" engine (K > 1024, a 160 px
grid). Also the preprocess: letterbox geometry and pixels equal to the
byte, on the host and on the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.evaluation.yolov5 import decode_topk_yolov5 as jax_topk
from yoloseries_tpu.evaluation.yolov5 import decode_yolov5 as jax_decode
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS as JAX_ANCHORS
from yoloseries_tpu.ops.letterbox import letterbox_image as jax_letterbox
from yoloseries_tpu.ops.preprocess import device_letterbox_normalize as jax_dev_lb
from yoloseries_tpu_torch.evaluation.yolov5 import decode_topk_yolov5, decode_yolov5
from yoloseries_tpu_torch.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu_torch.ops.letterbox import letterbox_image, unletterbox_boxes_np
from yoloseries_tpu_torch.ops.preprocess import device_letterbox_normalize

NC = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_maps(seed, b, size, nc=NC):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2.0, (b, size // s, size // s, 3 * (5 + nc))).astype(np.float32)
            for s in (8, 16, 32)]


def to_port(maps):
    return [torch.from_numpy(m).permute(0, 3, 1, 2).contiguous() for m in maps]


def test_anchors_equal():
    np.testing.assert_array_equal(YOLOV5_ANCHORS, JAX_ANCHORS)


def test_dense_decode_matches_jax():
    maps = raw_maps(0, 2, 64)
    ref = np.asarray(jax_decode([jnp.asarray(m) for m in maps], jnp.asarray(JAX_ANCHORS)))
    got = decode_yolov5(to_port(maps)).numpy()
    assert got.shape == ref.shape == (2, (64 + 16 + 4) * 3, 5 + NC)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("size,k,select,conf", [
    (64, 128, "topk", 0.25),
    (96, 512, "topk", 0.05),
    (160, 1200, "sort", 0.05),
    (160, 2048, "sort", 0.001),  # more slots than candidates: zero padding
])
def test_fused_selection_matches_jax(size, k, select, conf):
    maps = raw_maps(size + k, 2, size)
    jb, js, jc = jax_topk([jnp.asarray(m) for m in maps], jnp.asarray(JAX_ANCHORS),
                          k=k, conf_threshold=conf, cls_threshold=conf, select=select)
    pb, ps, pc = decode_topk_yolov5(to_port(maps), k=k, conf_threshold=conf,
                                    cls_threshold=conf, select=select)
    assert pb.shape == (2, k, 4) and ps.shape == (2, k)
    assert (ps > 0).any()
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-4, rtol=1e-6)


def test_topk_and_sort_engines_agree():
    maps = to_port(raw_maps(5, 2, 160))
    a = decode_topk_yolov5(maps, k=700, conf_threshold=0.05, cls_threshold=0.05,
                           select="topk")
    b = decode_topk_yolov5(maps, k=700, conf_threshold=0.05, cls_threshold=0.05,
                           select="sort")
    # sigmoid(max logit) and max(sigmoid) may part by an ulp
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("hw", [(50, 80), (97, 61), (1, 1), (64, 64)])
def test_letterbox_matches_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref, ref_info = jax_letterbox(img, 64, stride=32, fill_value=114)
    got, info = letterbox_image(img, 64, stride=32, fill_value=114)
    np.testing.assert_array_equal(got, ref)
    assert info.as_array().tolist() == ref_info.as_array().tolist()
    boxes = np.array([[10.0, 12.0, 30.0, 40.0]], np.float32)
    back = unletterbox_boxes_np(boxes, info)
    assert (back >= 0).all() and (back[:, [0, 2]] <= hw[1]).all()


def test_device_letterbox_matches_jax():
    img = np.random.default_rng(9).integers(0, 256, (2, 45, 70, 3), dtype=np.uint8)
    ref = np.asarray(jax_dev_lb(jnp.asarray(img), (64, 64)))
    got = device_letterbox_normalize(torch.from_numpy(img), (64, 64))
    assert got.shape == ref.shape
    # the pixels are equal to the byte; /255 may part by an ulp (XLA turns
    # the division into a product with the reciprocal)
    np.testing.assert_array_equal(np.round(got.numpy() * 255), np.round(ref * 255))
    np.testing.assert_allclose(got.numpy(), ref, atol=6e-8, rtol=0)

"""The whole serving slice: a uint8 batch through the port ``Evaluator`` (on
the CPU, where the NMS wrappers take their plain twins) and through the
JAX ``Evaluator`` (``use_pallas_nms=False``) on the same weights, with TTA
off and on, fused and dense decode.

Weights: a narrow YOLOv5 initialised by JAX, its detect convs widened
(kernel noise N(0, 0.5), bias 0) so that random weights give a few hundred
candidates with real overlaps. Tolerance: the same detections per image,
one for one, with equal class ids, conf at atol 1e-5 and boxes at atol
1e-3 px: the raw maps agree to ~1e-5 (convolution order), so two keepers
whose confs differ by a few ulps may trade slots. Checked over seeds 0-4
before fixing seed 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.evaluation.yolov5 import EvalConfig as JaxEvalConfig
from yoloseries_tpu.evaluation.yolov5 import Evaluator as JaxEvaluator
from yoloseries_tpu.evaluation.yolov5 import decode_topk_yolov5 as jax_topk
from yoloseries_tpu.evaluation.yolov5 import decode_yolov5 as jax_decode
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu_torch.cli.detect import detect_batch, load_weights
from yoloseries_tpu_torch.evaluation import (
    EvalConfig,
    Evaluator,
    yolov5_decode_fn,
    yolov5_select_fn,
)
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 96


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for head in params["detect"].values():
        head["kernel"] = rng.normal(0, 0.5, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    return model, params, variables["batch_stats"]


def _port_model(params, stats):
    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    port.load_state_dict(state_dict_from_jax(params, stats))
    return port


def _jax_evaluator(model, cfg, fused):
    anchors = jnp.asarray(YOLOV5_ANCHORS)
    select = (lambda p: jax_topk(p, anchors, k=cfg.num_candidates,
                                 conf_threshold=cfg.conf_threshold,
                                 cls_threshold=cfg.cls_threshold)) if fused else None
    return JaxEvaluator(model.apply, lambda p: jax_decode(p, anchors), cfg, select_fn=select)


def _assert_detections_match(got, ref):
    """Per image, the same detections one for one: class equal, conf within
    1e-5, box within 1e-3 px. Slots are matched, not compared in place: two
    keepers whose confs differ by a few ulps may swap slots."""
    assert got.shape == ref.shape
    assert (ref[..., 4] > 0).any()
    for g, r in zip(got, ref):
        g, r = g[g[:, 4] > 0], r[r[:, 4] > 0]
        assert len(g) == len(r)
        free = np.ones(len(g), bool)
        for row in r:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= 1e-5)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= 1e-3))
            assert close.any(), f"no match for {row}"
            free[np.argmax(close)] = False


SERVING = dict(conf_threshold=0.25, cls_threshold=0.25, iou_threshold=0.45,
               num_candidates=512)
PROTOCOL = dict(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                num_candidates=4096)


@pytest.mark.parametrize("kw,tta,fused", [
    (SERVING, False, True),
    (PROTOCOL, False, True),
    (PROTOCOL, True, True),
    (SERVING, True, True),   # three sorted branches concatenated: unsorted NMS input
    (SERVING, True, False),
])
def test_evaluator_matches_jax(weights, kw, tta, fused):
    model, params, stats = weights
    img = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jcfg = JaxEvalConfig(use_tta=tta, use_pallas_nms=False, **kw)
    ref = np.asarray(_jax_evaluator(model, jcfg, fused)(
        {"params": params, "batch_stats": stats}, img))
    cfg = EvalConfig(use_tta=tta, **kw)
    ev = Evaluator(_port_model(params, stats), yolov5_decode_fn(), cfg,
                   yolov5_select_fn(cfg) if fused else None, device="cpu")
    got = ev(img).numpy()
    _assert_detections_match(got, ref)


def test_detect_batch_loads_npz_weights(weights, tmp_path):
    model, params, stats = weights
    flat = {"/".join(("params",) + k): v for k, v in flatten_tree(params).items()}
    flat.update({"/".join(("batch_stats",) + k): np.asarray(v)
                 for k, v in flatten_tree(stats).items()})
    np.savez(tmp_path / "w.npz", **flat)
    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    load_weights(port, tmp_path / "w.npz")
    cfg = EvalConfig(**SERVING)
    ev = Evaluator(port, yolov5_decode_fn(), cfg, yolov5_select_fn(cfg), device="cpu")
    img = np.random.default_rng(2).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    infos = np.array([[1.0, 0, 0, SIZE, SIZE]] * 2, np.float32)
    dets = detect_batch(ev, img, infos)
    ref = Evaluator.to_host_detections(ev(img), infos)
    assert len(dets) == 2
    for d, r in zip(dets, ref):
        assert (d is None) == (r is None)
        if d is not None:
            np.testing.assert_allclose(d, r)


def test_detect_cli_on_a_folder(tmp_path):
    from PIL import Image

    from yoloseries_tpu_torch.cli.detect import main
    from yoloseries_tpu_torch.models import create_model

    torch.save(create_model("yolov5s", num_class=NC, device="cpu").state_dict(),
               tmp_path / "w.pt")
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(4)
    for i, hw in enumerate([(40, 70), (64, 64), (90, 30)]):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
    main(["--weights", str(tmp_path / "w.pt"), "--img-dir", str(img_dir),
          "--save-dir", str(tmp_path / "out"), "--num-class", str(NC),
          "--input-size", "64", "--batch-size", "2", "--device", "cpu"])
    dets = json.loads((tmp_path / "out" / "detections.json").read_text())
    assert sorted(dets) == ["0.png", "1.png", "2.png"]

"""The serving knobs of the port against the JAX package: soft-NMS, Weighted
Boxes Fusion, bf16 compute, and ``cli/detect.py``'s conv+BN fold.

* ``soft_nms``, linear and exponential, against the JAX ``soft_nms`` on
  the same candidates (exact ties, zero-area boxes, dead tails, an
  all-dead row): keeper indices and validity equal, the decayed scores
  within 1e-6 (``exp`` may round in another last bit);
* ``weighted_boxes_fusion`` on the same branch lists: within 1e-5 (the same
  numpy arithmetic); ``Evaluator.detect_wbf`` against the JAX
  ``detect_wbf`` on the same weights and images, fused detections within
  1e-5 relative and absolute, matched one for one (the branches' raw maps
  agree to ~1e-5, so two fused boxes whose scores differ by ulps may swap);
  with ``use_wbf`` the ``Evaluator``'s own rows are that fusion;
* bf16: the raw maps of the port's bf16 model against the JAX bf16 model
  within 5e-2 of each map's max |value| (two bf16 pipelines round each
  layer's output to 8 significant bits, each in its own order), and the
  bf16 decode and the JAX bf16 decode of the same maps both within 6 bf16
  ulps (6 * 2^-8 relative) of the largest value of each chain of the f32
  decode (for xy that value is (2 sigmoid + grid) * stride, since
  2 sigmoid - 0.5 cancels): a sigmoid within 2 ulps (JAX's reads 1.9, the
  port's 1.0), doubled by wh's square, and two more roundings;
* ``cli/detect.py`` on one checkpoint: folded (the default) and
  ``--no-fuse`` give the same detections one for one (conf 1e-5, box
  1e-3 px); ``--bf16`` and ``--s2d-stem`` run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yoloseries_tpu.evaluation.yolov5 import EvalConfig as JaxEvalConfig
from yoloseries_tpu.evaluation.yolov5 import Evaluator as JaxEvaluator
from yoloseries_tpu.evaluation.yolov5 import decode_topk_yolov5 as jax_topk
from yoloseries_tpu.evaluation.yolov5 import decode_yolov5 as jax_decode
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.ops.nms import soft_nms as jax_soft_nms
from yoloseries_tpu.ops.wbf import weighted_boxes_fusion as jax_wbf
from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, decode_yolov5, yolov5_select_fn
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec, create_model
from yoloseries_tpu_torch.ops.nms import soft_nms
from yoloseries_tpu_torch.ops.wbf import weighted_boxes_fusion
from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, save_checkpoint
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 96
BF16_TOL = 5e-2  # of the map's max |value|


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The narrow JAX YOLOv5 with its detect convs widened (kernel
    N(0, 0.5), bias 0): a few hundred candidates with real overlaps."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))())
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for head in params["detect"].values():
        head["kernel"] = rng.normal(0, 0.5, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    return params, jax.tree_util.tree_map(np.asarray, variables["batch_stats"])


def _port_model(params, stats, **kw):
    port = YOLOv5(NC, YOLOv5Spec(*NARROW), **kw)
    port.load_state_dict(state_dict_from_jax(params, stats))
    return port.eval()


# -------------------------------------------------------------- soft-NMS

def _candidates(seed, b, k):
    rng = np.random.default_rng(seed)
    hot = rng.uniform(0, 300, (b, 12, 2))
    xy = hot[np.arange(b)[:, None], rng.integers(0, 12, (b, k))] + rng.normal(0, 10, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    wh[:, ::29] = 0.0  # zero-area boxes
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    scores[:, 3:7] = scores[:, 3:4]  # exact ties
    scores[:, k // 2:] *= rng.uniform(size=(b, 1)) < 0.5  # dead tails
    scores[-1] = 0.0  # an all-dead row
    return boxes, scores


@pytest.mark.parametrize("mode", ["linear", "exp"])
def test_soft_nms_matches_jax(mode):
    boxes, scores = _candidates(0, 4, 400)
    want = jax.vmap(lambda b, s: jax_soft_nms(b, s, 0.45, 100, mode=mode))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 100, mode=mode)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
    assert got[1][:3].all(dim=1).any() and not got[1][-1].any()


# ------------------------------------------------------------------- WBF

def test_weighted_boxes_fusion_matches_jax():
    rng = np.random.default_rng(1)
    lists = []
    for n in (30, 0, 25):
        xy = rng.uniform(0, 80, (n, 2))
        dets = np.concatenate([xy, xy + rng.uniform(4, 30, (n, 2)), rng.uniform(0, 1, (n, 1)),
                               rng.integers(0, 3, (n, 1))], axis=1)
        lists.append(dets)
    for weights, thr in ((None, 0.5), ([2.0, 1.0, 0.5], 0.3)):
        got = weighted_boxes_fusion(lists, weights=weights, iou_thr=thr, skip_box_thr=0.05)
        want = jax_wbf(lists, weights=weights, iou_thr=thr, skip_box_thr=0.05)
        assert got.shape == want.shape and len(got) > 10
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert weighted_boxes_fusion([np.zeros((0, 6))]).shape == (0, 6)


def test_detect_wbf_matches_jax(weights):
    params, stats = weights
    kw = dict(conf_threshold=0.25, cls_threshold=0.25, iou_threshold=0.45, num_candidates=512,
              wbf_iou_threshold=0.55, wbf_weights=(2.0, 1.0, 1.0))
    img = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    anchors = jnp.asarray(YOLOV5_ANCHORS)
    jcfg = JaxEvalConfig(use_pallas_nms=False, use_wbf=True, **kw)
    jev = JaxEvaluator(JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW)).apply,
                       lambda p: jax_decode(p, anchors), jcfg,
                       select_fn=lambda p: jax_topk(p, anchors, k=512, conf_threshold=0.25,
                                                    cls_threshold=0.25))
    want = jev.detect_wbf({"params": params, "batch_stats": stats}, img)
    cfg = EvalConfig(use_wbf=True, **kw)
    evaluator = Evaluator(_port_model(params, stats), None, cfg, yolov5_select_fn(cfg),
                          device="cpu")
    got = evaluator.detect_wbf(img)
    # use_wbf: the evaluator's rows are the fusion, the first max_keep by conf
    rows = evaluator(img).numpy()
    assert rows.shape == (2, cfg.max_keep, 6)
    for r, g in zip(rows, got):
        n = 0 if g is None else min(len(g), cfg.max_keep)
        np.testing.assert_array_equal(r[:n], np.asarray(g[:n], np.float32))
        assert not r[n:].any()
    assert len(got) == len(want) == 2
    assert sum(0 if w is None else len(w) for w in want) > 10
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.shape == w.shape
        free = np.ones(len(g), bool)
        for row in w:
            close = free & (np.abs(g - row) <= 1e-5 + 1e-5 * np.abs(row)).all(axis=1)
            assert close.any(), f"no match for {row}"
            free[np.argmax(close)] = False


# ------------------------------------------------------------------ bf16

def test_bf16_raw_maps_match_jax_bf16(weights):
    params, stats = weights
    x = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW), dtype=jnp.bfloat16)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = _port_model(params, stats, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        err = np.abs(g.float().permute(0, 2, 3, 1).numpy() - r).max()
        assert err <= BF16_TOL * np.abs(r).max(), (err, np.abs(r).max())
    # the bf16 decode on the same maps
    maps = [g.detach() for g in got]
    want = jax_decode([jnp.asarray(m.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
                       for m in maps], jnp.asarray(YOLOV5_ANCHORS), dtype=jnp.bfloat16)
    dec = decode_yolov5(maps, dtype=torch.bfloat16)
    assert dec.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # both against the f32 decode of the same maps, within 6 bf16 ulps
    # (6 * 2^-8 relative) of the largest value of each chain: the result for
    # wh, obj and cls; for xy (2 sigmoid + grid) * stride, as 2 sigmoid - 0.5
    # cancels. 6 = a sigmoid within 2 ulps, doubled by wh's square, and two
    # more roundings
    exact = decode_yolov5([m.float() for m in maps]).numpy()
    stride = np.concatenate([np.full(m.shape[2] * m.shape[3] * 3, s, np.float32)
                             for m, s in zip(maps, (8, 16, 32))])
    ulp = np.abs(exact) * 2.0 ** -8  # of each chain's largest value
    ulp[..., 0:2] += 2.5 * stride[None, :, None] * 2.0 ** -8
    jax_ulps = np.abs(want - exact) / ulp
    port_ulps = np.abs(dec.float().numpy() - exact) / ulp
    print(f"bf16 decode, worst error in ulps of the chain, obj/cls then wh: JAX "
          f"{jax_ulps[..., 4:].max():.2f} {jax_ulps[..., 2:4].max():.2f}, port "
          f"{port_ulps[..., 4:].max():.2f} {port_ulps[..., 2:4].max():.2f}")
    assert jax_ulps.max() <= 6  # the bound holds for JAX's own
    assert port_ulps.max() <= 6


# --------------------------------------------------------- cli/detect.py

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A yolov5s checkpoint (nc 3) whose BN stats are not the identity and
    whose detect convs give raw maps of std 1.5 on a calibration batch, and
    a folder of 5 PNGs."""
    root = tmp_path_factory.mktemp("port_detect_knobs")
    model = create_model("yolov5s", num_class=NC, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
        calib = torch.rand(2, 3, 64, 64, generator=gen)
        for conv, raw in zip((model.detect.detect_small, model.detect.detect_mid,
                              model.detect.detect_large), model(calib)):
            conv.bias.zero_()
            conv.weight.mul_(1.5 / raw.std())
    state = create_train_state(model, OptimizerConfig())
    save_checkpoint(root / "ckpt", state, 3)
    img_dir = root / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(4)
    for i, hw in enumerate([(40, 70), (64, 64), (90, 30), (64, 50), (20, 64)]):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
    return root


def _detect(root, out, *flags):
    from yoloseries_tpu_torch.cli.detect import main

    main(["--ckpt-dir", str(root / "ckpt"), "--img-dir", str(root / "img"), "--save-dir",
          str(out), "--num-class", str(NC), "--input-size", "64", "--batch-size", "2",
          "--conf", "0.1", "--device", "cpu", *flags])
    return json.loads((out / "detections.json").read_text())


def test_detect_cli_fold_matches_no_fuse(checkpoint, tmp_path, capsys):
    fused = _detect(checkpoint, tmp_path / "fused")
    assert "fused conv+bn" in capsys.readouterr().out
    plain = _detect(checkpoint, tmp_path / "plain", "--no-fuse")
    assert "fused conv+bn" not in capsys.readouterr().out
    assert sorted(fused) == sorted(plain)
    assert sum(len(v) for v in plain.values()) > 5
    for name in plain:
        g, r = np.asarray(fused[name]).reshape(-1, 6), np.asarray(plain[name]).reshape(-1, 6)
        assert g.shape == r.shape, name
        free = np.ones(len(g), bool)
        for row in r:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= 1e-5)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= 1e-3))
            assert close.any(), f"{name}: no match for {row}"
            free[np.argmax(close)] = False
    bf16 = _detect(checkpoint, tmp_path / "bf16", "--bf16")
    assert sorted(bf16) == sorted(plain)


def test_detect_cli_s2d_stem(checkpoint, tmp_path):
    """A checkpoint of the s2d model (its stem mapped from the 6x6 one)
    through ``--s2d-stem`` detects what the 6x6 checkpoint detects."""
    from yoloseries_tpu_torch.nn.deploy import fold_stem_to_s2d
    from yoloseries_tpu_torch.train import restore_weights

    model = create_model("yolov5s", num_class=NC, device="cpu")
    restore_weights(model, checkpoint / "ckpt", device="cpu")
    s2d = create_model("yolov5s", num_class=NC, device="cpu", s2d_stem=True)
    s2d.load_state_dict(fold_stem_to_s2d(model.state_dict()))
    root = tmp_path / "s2d"
    save_checkpoint(root / "ckpt", create_train_state(s2d, OptimizerConfig()), 3)
    (root / "img").symlink_to(checkpoint / "img")
    got = _detect(root, tmp_path / "out_s2d", "--s2d-stem")
    want = _detect(checkpoint, tmp_path / "out_6x6")
    assert sorted(got) == sorted(want)
    for name in want:
        g, r = np.asarray(got[name]).reshape(-1, 6), np.asarray(want[name]).reshape(-1, 6)
        assert g.shape == r.shape
        np.testing.assert_allclose(g[np.lexsort(g.T)], r[np.lexsort(r.T)], atol=1e-3)

"""Port kernels on the card: each CUDA kernel against its plain twin, index
for index, the serving path through the kernels, the augmentation render on
the card against the CPU's, byte for byte, the YOLOv5 knobs (the conv+BN
fold, the s2d stem, soft-NMS) and every family's evaluator and update on the
card against the CPU.

Marked ``gpu``; each test takes the ``cuda`` fixture, which skips when no
card is visible (decided at run time, never at import). On a machine with a
card and the CUDA toolkit:

    python -m pytest -m gpu tests/test_torch_port_gpu.py

This file imports no JAX: the card machine need not have it.
"""

import numpy as np
import pytest
import torch

from yoloseries_tpu_torch.kernels import nms_greedy, nms_matrix
from yoloseries_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu


def launches(counter):
    """The launches counted under ``counter`` since the last reset."""
    return trace.totals()["counters"].get(counter, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def candidates(seed, b, k, n_cls=4, shuffle=True):
    """Clustered boxes with zero-area boxes, exact ties, dead tails, an
    all-dead row and the class offset."""
    rng = np.random.default_rng(seed)
    hot = rng.uniform(0, 600, (b, 24, 2))
    xy = hot[np.arange(b)[:, None], rng.integers(0, 24, (b, k))] + rng.normal(0, 15, (b, k, 2))
    wh = rng.uniform(5, 90, (b, k, 2))
    wh[:, ::37] = 0.0
    cls = rng.integers(0, n_cls, (b, k))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes = boxes + (cls.astype(np.float32) * np.float32(4096.0))[..., None]
    scores = np.sort(rng.uniform(0.01, 1, (b, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[:, 5:9] = scores[:, 5:6]
    for r in range(b):
        scores[r, rng.integers(k // 4, k + 1):] = 0.0
    if b > 1:
        scores[-1] = 0.0
    if shuffle:
        order = rng.permutation(k)
        boxes, scores = boxes[:, order], scores[:, order]
    return (torch.from_numpy(np.ascontiguousarray(boxes)),
            torch.from_numpy(np.ascontiguousarray(scores)))


def _check(kernel, twin, dev, b, k, thr, max_keep=300, shuffle=True, **kw):
    boxes, scores = candidates(b * 31 + k, b, k, shuffle=shuffle)
    want = twin(boxes.to(dev), scores.to(dev), thr, max_keep, **kw)
    got = kernel(boxes.to(dev), scores.to(dev), thr, max_keep, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[0].cpu(), want[0].cpu())


@pytest.mark.parametrize("b,k,thr,shuffle", [
    (256, 512, 0.45, True), (8, 4096, 0.65, True), (3, 1000, 0.5, True),
    (256, 512, 0.45, False), (64, 4096, 0.65, False),  # sorted: the in-block sort skipped
    (2, 1536, 0.45, True),  # the serving-TTA shape: three branches, unsorted
    (2, 8192, 0.65, False), (2, 8192, 0.65, True),  # the largest K: 225 KB of shared memory
])
def test_greedy_kernel_matches_twin(cuda, b, k, thr, shuffle):
    trace.reset()
    _check(nms_greedy.nms_greedy, nms_greedy.greedy_nms, cuda, b, k, thr, shuffle=shuffle)
    assert launches("nms_greedy.launches") == 1


def test_greedy_kernel_cuts_inside_a_tile_and_skips_dead_images(cuda):
    """max_keep = 20 falls inside a 32-wide tile of image 0's order; images
    1 and 3 are all dead."""
    boxes, scores = candidates(7, 4, 512, shuffle=False)
    scores[1] = 0.0
    full = nms_greedy.greedy_nms(boxes, scores, 0.45, 300)
    rank = torch.argsort(nms_greedy.priority_order(scores), dim=1)
    tiles = rank[0, full[0][0, :21].long()] // 32
    assert bool(full[1][0, :21].all()) and tiles[19] == tiles[20]
    want = nms_greedy.greedy_nms(boxes, scores, 0.45, 20)
    got = nms_greedy.nms_greedy(boxes.to(cuda), scores.to(cuda), 0.45, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
    assert bool(got[1][0].all()) and not got[1][1].any() and not got[1][3].any()


@pytest.mark.parametrize("b,k,shuffle", [
    (1, 512, True), (8, 1024, True), (16, 700, True),
    (8, 512, False), (3, 333, False),  # sorted by priority: the popcount ranks
])
def test_matrix_kernel_matches_twin(cuda, b, k, shuffle):
    trace.reset()
    _check(nms_matrix.matrix_nms, nms_matrix.matrix_nms_plain, cuda, b, k, 0.45,
           shuffle=shuffle)
    assert launches("nms_matrix.launches") == 1


@pytest.mark.parametrize("b,k", [(8, 512), (2, 1024), (3, 200)])
def test_relation_kernel_matches_twin_bit_for_bit(cuda, b, k):
    trace.reset()
    boxes, scores = candidates(b * 17 + k, b, k)
    want = nms_matrix.nms_relation_plain(boxes.to(cuda), scores.to(cuda), 0.45)
    got = nms_matrix.nms_relation(boxes.to(cuda), scores.to(cuda), 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert launches("nms_relation.launches") == 1


def test_chunked_driver_matches_greedy_twin(cuda):
    boxes, scores = candidates(5, 2, 12288)
    want = nms_greedy.greedy_nms(boxes.to(cuda), scores.to(cuda), 0.65, 300)
    got = nms_matrix.matrix_nms_chunked(boxes.to(cuda), scores.to(cuda), 0.65, 300)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.parametrize("b,k,max_keep,chunk", [
    (2, 12288, 300, 1024),
    (2, 4096, 20, 1024),  # the carry fills in the first strip
    (3, 9000, 300, 1024),  # K not a multiple of 1024; one image all dead
    (2, 1500, 150, 128),  # narrow strips: the carry fills in the middle of one
])
def test_chunked_kernel_matches_chunked_twin(cuda, b, k, max_keep, chunk):
    trace.reset()
    _check(nms_matrix.matrix_nms_chunked, nms_matrix.matrix_nms_chunked_plain, cuda, b, k,
           0.65, max_keep, chunk=chunk)
    assert launches("nms_matrix_chunked.launches") == 1


def test_cuda_evaluator_matches_cpu(cuda):
    from yoloseries_tpu_torch.evaluation import (
        EvalConfig,
        Evaluator,
        yolov5_decode_fn,
        yolov5_select_fn,
    )
    from yoloseries_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False  # compare in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EvalConfig(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                     num_candidates=1024)
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    outs = []
    for dev in ("cpu", cuda):
        model = create_model("yolov5s", num_class=80, device="cpu", seed=1)
        with torch.no_grad():
            for name in ("detect_small", "detect_mid", "detect_large"):
                getattr(model.detect, name).bias.zero_()
        ev = Evaluator(model, yolov5_decode_fn(), cfg, yolov5_select_fn(cfg), device=dev)
        outs.append(ev(img).cpu())
    assert outs[0].shape == outs[1].shape == (2, 300, 6)
    # near-equal confs may trade slots: compare each image's sorted confs
    conf = [np.sort(o[..., 4].numpy(), axis=1) for o in outs]
    np.testing.assert_allclose(conf[1], conf[0], atol=1e-4)


def _train_batch(n, size, nc, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    ann = np.full((n, 8, 6), -1.0, np.float32)
    for b in range(n):
        k = int(rng.integers(1, 8))
        xy = rng.uniform(0, size * 0.7, (k, 2))
        ann[b, :k, :2] = xy
        ann[b, :k, 2:4] = np.minimum(xy + rng.uniform(6, size / 2, (k, 2)), size)
        ann[b, :k, 4] = rng.integers(0, nc, k)
        ann[b, :k, 5] = b
    return torch.from_numpy(img), torch.from_numpy(ann)


def test_train_update_on_card_matches_cpu(cuda):
    """One update (B=4 x accumulate 2, warmup active) of a narrow YOLOv5 on
    the card and on the CPU from the same weights: tot_loss within 1e-3
    relative, every parameter within 1e-3 * max(1, |p|) (f32, TF32 off;
    the sums run in other orders)."""
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = YOLOv5Spec(8, (1, 1, 1, 1), 1)
    sd = YOLOv5(3, spec, generator=torch.Generator().manual_seed(0)).state_dict()
    loss_fn, _ = get_family("yolov5s").make_loss({}, 3, (64, 64))
    img, ann = _train_batch(8, 64, 3)
    out = {}
    for dev in ("cpu", cuda):
        state = create_train_state(YOLOv5(3, spec), OptimizerConfig(batch_size=4), state_dict=sd,
                                   device=dev)
        state, metrics = make_train_step(loss_fn, accumulate=2)(
            state, {"img": img.to(dev), "ann": ann.to(dev)})
        out[str(dev)] = (float(metrics["tot_loss"]),
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    for k, p in p_cpu.items():
        assert float(((p_gpu[k] - p).abs() / p.abs().clamp_min(1.0)).max()) <= 1e-3, k


def test_trainer_evaluate_launches_nms_greedy(cuda, tmp_path):
    """The Trainer on the card: one update, then evaluate() at the protocol
    config runs its NMS in B1 (K=4096)."""
    from PIL import Image

    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    img, ann = _train_batch(4, 64, 3, seed=1)
    for i in range(4):
        Image.fromarray(img[i].numpy()).save(img_dir / f"{i}.png")
        rows = ann[i][ann[i][:, 4] >= 0].numpy()
        (lab_dir / f"{i}.txt").write_text(
            "".join(f"{int(r[4])} {r[0]:.1f} {r[1]:.1f} {r[2]:.1f} {r[3]:.1f}\n" for r in rows))
    hyp = {"input_img_size": [64, 64], "batch_size": 2, "accumulate_loss_step": 4,
           "total_epoch": 1, "no_data_aug_epoch": 1, "num_workers": 2, "save_ckpt_every": 10}
    cfg = TrainConfig.from_hyp(hyp, num_class=3, model="yolov5s", max_labels=8,
                               output_dir=str(tmp_path / "run"))
    trainer = Trainer(cfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir),
                      log_fn=lambda *a: None, device=cuda)
    try:
        trainer.train()
        assert np.isfinite(trainer.history[0]["tot_loss"])
        trace.reset()
        out = trainer.evaluate()
        assert launches("nms_greedy.launches") == 2  # one per val batch of 2
        assert 0.0 <= out["map"] <= 1.0
    finally:
        trainer.close()


def _aug_folder(root, n=6, size=128):
    """``n`` PNGs under ``size`` px with 2-3 filled boxes each."""
    from PIL import Image

    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        h, w = int(rng.integers(80, size + 1)), int(rng.integers(80, size + 1))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(2, 4))):
            x1, y1 = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
            x2, y2 = x1 + int(rng.integers(20, 40)), y1 + int(rng.integers(20, 40))
            img[y1:y2, x1:x2] = [220, 60 * (i % 3), 30]
            lines.append(f"{i % 3} {x1} {y1} {x2} {y2}")
        Image.fromarray(img).save(img_dir / f"{i}.png")
        (lab_dir / f"{i}.txt").write_text("\n".join(lines) + "\n")
    return img_dir, lab_dir


@pytest.mark.parametrize("mode", ["gather", "separable", "staged", "cache"])
def test_render_on_card_matches_cpu(cuda, tmp_path, mode):
    """The same plans rendered on the card and on the CPU: the same bytes
    (elementwise f32 in one order, true divisions, no fused multiply-add
    across ops)."""
    from yoloseries_tpu_torch.data import AugmentConfig, DetectionDataset
    from yoloseries_tpu_torch.data import device_aug as da
    from yoloseries_tpu_torch.data.loader import collate_plan_batch

    knobs = dict(mosaic_p=1.0, mixup_p=0.5, perspective_p=1.0, hsv_p=1.0, fliplr_p=0.5,
                 flipud_p=0.5, cutout_p=0.5)
    if mode == "separable":
        knobs["perspective"] = 0.0
    if mode == "staged":
        knobs.update(blur_p=0.7, scale_jitting_p=0.7)
    img_dir, lab_dir = _aug_folder(tmp_path)
    ds = DetectionDataset(img_dir, lab_dir, input_size=(128, 128),
                          aug=AugmentConfig(input_size=(128, 128), **knobs), enable_aug=True,
                          cache_images=mode == "cache", cache_dir=tmp_path / "cache")
    plans = [da.plan_sample(ds, i, np.random.default_rng((7, i)), mode != "cache")
             for i in range(6)]
    batch = collate_plan_batch(plans, 128, 20)
    out = {}
    for dev in ("cpu", cuda):
        plan = {k: torch.from_numpy(v).to(dev) for k, v in batch["plan"].items()}
        tiles = torch.from_numpy(batch["tiles"]).to(dev) if "tiles" in batch else None
        cache = (torch.from_numpy(np.ascontiguousarray(ds._cache)).to(dev)
                 if mode == "cache" else None)
        img = da.render_batch(tiles, plan, (128, 128), (128, 128), method=da.render_method(ds.aug),
                              cache=cache, staged=da.render_staged(ds.aug))
        assert img.device.type == torch.device(dev).type and img.dtype == torch.uint8
        out[str(dev)] = img.cpu().numpy()
    assert out["cpu"].tobytes() == out["cuda"].tobytes()


def test_trainer_with_device_aug_on_card(cuda, tmp_path):
    """The Trainer with ``device_aug`` and ``device_cache``: the cache on the
    card, the batches rendered there, one finite update."""
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir = _aug_folder(tmp_path, n=4)
    hyp = {"input_img_size": [128, 128], "batch_size": 2, "accumulate_loss_step": 4,
           "total_epoch": 1, "no_data_aug_epoch": 0, "num_workers": 2, "save_ckpt_every": 10,
           "device_aug": True, "device_cache": True}
    cfg = TrainConfig.from_hyp(hyp, num_class=3, model="yolov5s", max_labels=8,
                               output_dir=str(tmp_path / "run"))
    trainer = Trainer(cfg, (img_dir, lab_dir), log_fn=lambda *a: None, device=cuda)
    try:
        assert trainer._dev_cache.device.type == "cuda"
        batch = trainer._device_batch(next(trainer.train_loader))
        assert batch["img"].device.type == "cuda" and batch["img"].shape == (4, 128, 128, 3)
        trainer.train()
        assert np.isfinite(trainer.history[0]["tot_loss"])
    finally:
        trainer.close()


# ------------------------------------------- the YOLOv5 knobs on the card

def _knob_model(**kw):
    """yolov5s at nc=80, seed 1, BN stats not the identity, detect convs
    without bias (scores spread over the thresholds)."""
    from yoloseries_tpu_torch.models import create_model

    model = create_model("yolov5s", num_class=80, device="cpu", seed=1, **kw)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
        for name in ("detect_small", "detect_mid", "detect_large"):
            getattr(model.detect, name).bias.zero_()
    return model


def test_fold_on_card_matches_cpu(cuda):
    """``fold_conv_bn`` on the card: the folded model's raw maps against the
    unfused model's on the card (1e-3) and against the folded model on the
    CPU (1e-3, f32 with TF32 off)."""
    import copy

    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _knob_model()
    folded = fold_conv_bn(copy.deepcopy(model))
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        cpu = folded(x)
        card_folded = folded.to(cuda)(x.to(cuda))
        card_unfused = model.to(cuda)(x.to(cuda))
    for c, f, u in zip(cpu, card_folded, card_unfused):
        assert float((f.cpu() - c).abs().max()) <= 1e-3
        assert float((f - u).abs().max()) <= 1e-3


def test_s2d_stem_on_card_matches_6x6(cuda):
    """The s2d model with ``fold_stem_to_s2d`` weights against the 6x6-stem
    model, both on the card: raw maps within 1e-3 (TF32 off)."""
    from yoloseries_tpu_torch.nn.deploy import fold_stem_to_s2d

    torch.backends.cudnn.allow_tf32 = False
    model = _knob_model()
    s2d = _knob_model(s2d_stem=True)
    s2d.load_state_dict(fold_stem_to_s2d(model.state_dict()))
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(3)).to(cuda)
    with torch.no_grad():
        for a, b in zip(model.to(cuda)(x), s2d.to(cuda)(x)):
            assert float((a - b).abs().max()) <= 1e-3


@pytest.mark.parametrize("mode", ["linear", "exp"])
def test_soft_nms_on_card_matches_cpu(cuda, mode):
    """``soft_nms`` on the card against the CPU on the same candidates: at
    least 99% of the keeper slots equal, their scores within 1e-5 (the
    decayed scores compound ``exp`` and divisions that may round apart)."""
    from yoloseries_tpu_torch.ops.nms import soft_nms

    boxes, scores = candidates(9, 8, 512)
    got = soft_nms(boxes.to(cuda), scores.to(cuda), 0.45, 300, mode=mode)
    want = soft_nms(boxes, scores, 0.45, 300, mode=mode)
    valid = want[1] | got[1].cpu()
    same = (got[0].cpu() == want[0]) & valid
    assert int(same.sum()) >= 0.99 * int(valid.sum()) > 0
    assert float((got[2].cpu() - want[2]).abs()[same].max()) <= 1e-5


# ------------------------------------------------ the anchor-free families

def _seeded_family_model(name):
    """``name`` at nc=3 from seed 1; YOLOX's output convs widened (its
    prior biases put every box at ~0.1 px and every score near 0.005)."""
    from yoloseries_tpu_torch.models import create_model

    model = create_model(name, num_class=3, device="cpu", seed=1)
    if name.startswith("yolox"):
        with torch.no_grad():
            for head in (model.detect.pred_small, model.detect.pred_middle,
                         model.detect.pred_large):
                for conv in (head.cls[-1], head.reg, head.cof):
                    conv.bias.zero_()
                head.reg.bias[2:] = 2.0
    return model


@pytest.mark.parametrize("name", ["yolox_s", "yolov8n"])
def test_anchor_free_evaluator_on_card_matches_cpu(cuda, name):
    """The family's raw maps (1e-3) and its ``Evaluator`` at the protocol
    config (sorted confs 1e-4), card against CPU."""
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    family = get_family(name)
    cfg = EvalConfig(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                     num_candidates=1024)
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255
    maps, outs = [], []
    for dev in ("cpu", cuda):
        model = _seeded_family_model(name).to(dev)
        with torch.no_grad():
            maps.append([m.cpu() for m in model(x.to(dev))])
        ev = Evaluator(model, family.make_decode({}, 3, (128, 128)), cfg,
                       family.make_select({}, 3, (128, 128))(cfg), device=dev)
        outs.append(ev(img).cpu())
    for a, b in zip(*maps):
        assert float((a - b).abs().max()) <= 1e-3
    conf = [np.sort(o[..., 4].numpy(), axis=1) for o in outs]
    assert (conf[0] > 0).any()
    np.testing.assert_allclose(conf[1], conf[0], atol=1e-4)


@pytest.mark.parametrize("name", ["yolox_s", "yolov8n"])
def test_anchor_free_update_on_card_matches_cpu(cuda, name):
    """One update (B=2 x accumulate 2) of the family's model and loss
    (SimOTA, TAL) on the card and on the CPU from the same weights: tot_loss
    within 1e-3 relative, the foreground counts equal, every parameter
    within 1e-3 * max(1, |p|)."""
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = create_model(name, num_class=3, device="cpu", seed=0).state_dict()
    loss_fn, bal = get_family(name).make_loss({}, 3, (64, 64))
    img, ann = _train_batch(4, 64, 3)
    out = {}
    for dev in ("cpu", cuda):
        state = create_train_state(create_model(name, 3, device="cpu"),
                                   OptimizerConfig(batch_size=2), balances=bal, state_dict=sd,
                                   device=dev)
        state, metrics = make_train_step(loss_fn, accumulate=2)(
            state, {"img": img.to(dev), "ann": ann.to(dev)})
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert abs(m_gpu["tot_loss"] - m_cpu["tot_loss"]) <= 1e-3 * abs(m_cpu["tot_loss"])
    assert m_gpu["tar_nums"] == m_cpu["tar_nums"]
    for k, p in p_cpu.items():
        assert float(((p_gpu[k] - p).abs() / p.abs().clamp_min(1.0)).max()) <= 1e-3, k


@pytest.mark.parametrize("name", ["yolov7", "retinanet_experiment", "fcos"])
def test_last_families_evaluator_on_card_matches_cpu(cuda, name):
    """YOLOv7 (the v7 gate, the box filter), RetinaNet's experiment (merged
    boxes written back) and FCOS (sqrt scores, the 301 merge gate) at 128 px:
    raw maps (1e-3 of their scale) and the ``Evaluator`` at the protocol
    config with the family's overrides (sorted confs 1e-4), card against
    CPU."""
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    family = get_family(name)
    hyp = {"min_prediction_box_wh": 2}
    cfg = family.apply_eval_overrides(EvalConfig(conf_threshold=0.001, cls_threshold=0.001,
                                                 iou_threshold=0.65, num_candidates=1024), hyp)
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255
    maps, outs = [], []
    for dev in ("cpu", cuda):
        model = create_model(name, num_class=3, device="cpu", seed=1).to(dev)
        with torch.no_grad():
            out = model(x.to(dev))
            if name.startswith("retinanet"):
                out = out[:2]
            elif name == "fcos":
                out = [m for level_maps in out for m in level_maps]
            maps.append([m.float().cpu() for m in out])
        ev = Evaluator(model, family.make_decode(hyp, 3, (128, 128)), cfg,
                       family.make_select(hyp, 3, (128, 128))(cfg), device=dev)
        outs.append(ev(img).cpu())
    for a, b in zip(*maps):
        assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(a.abs().max()))
    conf = [np.sort(o[..., 4].numpy(), axis=1) for o in outs]
    assert (conf[0] > 0).any()
    np.testing.assert_allclose(conf[1], conf[0], atol=1e-4)


@pytest.mark.parametrize("name", ["yolov7", "retinanet", "fcos"])
def test_last_families_update_on_card_matches_cpu(cuda, name):
    """One update (B=2 x accumulate 2) of the family's model and loss (OTA,
    max-IoU anchors, FCOS's ranges) at 128 px on the card and on the CPU
    from the same weights: tot_loss within 1e-3 relative, the positive
    counts equal, every parameter within 1e-3 * max(1, |p|)."""
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = create_model(name, num_class=3, device="cpu", seed=0).state_dict()
    loss_fn, bal = get_family(name).make_loss({"iou_type": "iou"} if name == "retinanet" else {},
                                              3, (128, 128))
    img, ann = _train_batch(4, 128, 3)
    out = {}
    for dev in ("cpu", cuda):
        state = create_train_state(create_model(name, 3, device="cpu"),
                                   OptimizerConfig(batch_size=2), balances=bal, state_dict=sd,
                                   device=dev)
        state, metrics = make_train_step(loss_fn, accumulate=2)(
            state, {"img": img.to(dev), "ann": ann.to(dev)})
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert m_cpu["tar_nums"] > 0
    assert abs(m_gpu["tot_loss"] - m_cpu["tot_loss"]) <= 1e-3 * abs(m_cpu["tot_loss"])
    assert m_gpu["tar_nums"] == m_cpu["tar_nums"]
    for k, p in p_cpu.items():
        assert float(((p_gpu[k] - p).abs() / p.abs().clamp_min(1.0)).max()) <= 1e-3, k

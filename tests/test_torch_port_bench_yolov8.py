"""The port's YOLOv8 (YOLOSeries' at scale 0.5, the published widths, nc 80)
against the benchmark's plain reference (``port_bench/reference/families/
yolov8.py``, ``port_bench/reference/yolov8_loss.py``) on the seeded weights
the benchmark draws, at 64 x 64 and B = 2 on the CPU.

* the four raw maps in eval mode, and their decode;
* TAL: the foreground and each foreground cell's gt slot exactly, the class
  target's scale to f32 rounding, on boxes that share cells and whose edges
  pass through cell centres, and on an image with no box;
* the loss terms and the gradient of one update (train-mode BN, one
  micro-batch), parameter by parameter.

The port pads each image's boxes to the loader's gt slots; the reference
assigns over the image's own boxes, so a slot index is the box's index.
"""

import numpy as np
import pytest
import torch

from port_bench.core import spec
from port_bench.core.weights import images_u8, seeded_state, to_input
from port_bench.reference import models, yolov8_loss
from port_bench.reference.families import yolov8 as ref_family
from yoloseries_tpu_torch.evaluation.yolov8 import decode_yolov8
from yoloseries_tpu_torch.families import get_family
from yoloseries_tpu_torch.losses.yolov8 import (YOLOv8LossConfig, dfl_decode, flat_maps,
                                                tal_assign, v8_grid)
from yoloseries_tpu_torch.models import create_model
from yoloseries_tpu_torch.ops.boxes import tblr2xyxy

SEED = 2**31 + 7
SIZE = 64
SLOTS = 300  # the loader's max_labels: the port's gt slots
# the same f32 convolutions, BN affine and SiLU in the same order on both
# sides (the port's ConvBnAct, the reference's Net.cba): the maps agree to
# f32 rounding of values up to ~15 (read: bit-equal on this CPU)
MAP_ATOL = 1e-5
# boxes up to ~100 px from a softmax expectation, centres and sizes: a few
# ulps of 100 (7.6e-6 each)
BOX_ATOL = 1e-4
# the class target's scale, alignment x IoU / alignment with alignment =
# iou^6 score^0.5: the two CIoUs place their eps apart (1e-7 vs a 1e-6
# clamp), ~1e-7 relative, times 6 through the power
SCALE_RTOL = 1e-5
# the losses: sums over 340 cells x 80 classes of f32 terms, in another
# order and with another BCE form (logaddexp against torch's fused BCE);
# read 5.6e-6 (the class term)
LOSS_RTOL = 2e-5
# one update's gradient, train-mode BN over 2 images: torch's fused BN
# against the reference's two passes, ~1e-7 relative a layer through ~90
# layers; each leaf's gap over the larger of its norm and the median norm;
# read 2.1e-4 (``head_stage1_conv``, the deepest /32 layers)
GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    cfg = spec.config(spec.load_bench(), "yolov8")
    hyp = spec.traffic("train_noaug_b32x4")["hyp"]
    sd = seeded_state(cfg, SEED, "cpu", SIZE, calib=2)
    model = create_model(cfg["program_model"], num_class=cfg["nc"], device="cpu", seed=0)
    model.load_state_dict(sd, strict=True)
    # the calibration batch: BN's running statistics at this size are its own,
    # so the eval maps keep the scale the output convs were set to
    x = to_input(images_u8(SEED, 1, (2, SIZE, SIZE, 3), "cpu"))
    return cfg, hyp, sd, model, x


def _ann():
    """(2, SLOTS, 6): image 0 holds four boxes, two of them overlapping so
    that cells are shared, one with edges on stride-4 and stride-8 cell
    centres (2 + 4i); image 1 holds none."""
    ann = np.full((2, SLOTS, 6), -1.0, np.float32)
    boxes = [(6, 6, 30, 38, 3), (10, 14, 44, 42, 17), (34, 2, 62, 26, 3), (2, 40, 22, 62, 79)]
    for i, (x1, y1, x2, y2, c) in enumerate(boxes):
        ann[0, i] = (x1, y1, x2, y2, c, 0)
    return torch.from_numpy(ann)


def _loss_cfg(cfg, hyp):
    return YOLOv8LossConfig(num_class=cfg["nc"], strides=tuple(cfg["strides"]), reg=hyp["reg"],
                            topk=hyp["topk"], alpha=hyp["alpha"], beta=hyp["beta"])


def test_raw_maps_and_decode(setup):
    cfg, _, sd, model, x = setup
    with torch.no_grad():
        got, want = model.eval()(x), models.forward(sd, x, cfg)
    assert [tuple(m.shape) for m in got] == [(2, 64 + 80, SIZE // s, SIZE // s)
                                            for s in (4, 8, 16, 32)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=MAP_ATOL)
    rows = decode_yolov8(want, cfg["nc"], reg=cfg["reg"])
    boxes, obj, cls_p, cls_id = ref_family.decode(want, cfg)
    xyxy = torch.cat([rows[..., :2] - rows[..., 2:4] / 2, rows[..., :2] + rows[..., 2:4] / 2], -1)
    torch.testing.assert_close(xyxy, boxes, rtol=0, atol=BOX_ATOL)
    assert torch.equal(obj, rows[..., 4])
    torch.testing.assert_close(cls_p, rows[..., 5:].amax(-1), rtol=0, atol=1e-7)
    assert torch.equal(cls_id, rows[..., 5:].argmax(-1))


def test_tal_assignment(setup):
    cfg, hyp, sd, _, x = setup
    with torch.no_grad():
        maps = models.forward(sd, x, cfg)
    ann = _ann()
    # the port's inputs, as its loss builds them
    lcfg = _loss_cfg(cfg, hyp)
    grids, strides = v8_grid([m.shape[2:] for m in maps], lcfg.strides)
    rows = flat_maps(maps)
    pred_px = tblr2xyxy(dfl_decode(rows[..., :64], 16), grids) * strides
    fg, matched, norm = tal_assign(pred_px, torch.sigmoid(rows[..., 64:]), ann[..., :4],
                                   ann[..., 4].long().clamp(0, 79), ann[..., 4] >= 0,
                                   grids * strides, lcfg)
    # the reference's, as its loss builds them
    r = yolov8_loss.rows(maps)
    centres, cell_strides = yolov8_loss.cells(maps, cfg["strides"])
    ref_px = yolov8_loss.boxes_in_cells(yolov8_loss.side_expectation(r[..., :64], 16),
                                        centres) * cell_strides
    gt = ann[0, :4]
    ref_fg, ref_gt, ref_scale = yolov8_loss.tal(ref_px[0], torch.sigmoid(r[0, :, 64:]),
                                                gt[:, :4], gt[:, 4].long(),
                                                centres * cell_strides, hyp)
    assert int(ref_fg.sum()) >= 13 * 2  # something to compare: most boxes take k cells
    assert int((torch.bincount(ref_gt[ref_fg], minlength=4) > 0).sum()) == 4
    assert torch.equal(fg[0], ref_fg)
    assert torch.equal(matched[0][fg[0]], ref_gt[ref_fg])
    torch.testing.assert_close(norm[0], ref_scale, rtol=SCALE_RTOL, atol=1e-12)
    assert not fg[1].any() and not norm[1].any()


def test_loss_terms_and_gradient(setup):
    cfg, hyp, sd, model, x = setup
    ann = _ann()
    loss_fn, balances = get_family("yolov8").make_loss(hyp, cfg["nc"], (SIZE, SIZE))
    ref_loss, ref_balances = ref_family.loss(cfg, hyp, SIZE, "cpu")
    # the port: its model in train mode (BN on the batch), its loss
    train = create_model(cfg["program_model"], num_class=cfg["nc"], device="cpu", seed=0)
    train.load_state_dict(sd, strict=True)
    got, _ = loss_fn(train.train()(x), ann, balances)
    got["tot_loss"].backward()
    grads = {n: p.grad for n, p in train.named_parameters()}
    # the reference: the same weights, train-mode forward, its loss
    leaves = {n: sd[n].clone().requires_grad_(True) for n in grads}
    bufs = {k: v.clone() for k, v in sd.items() if k not in leaves}
    want, _ = ref_loss(models.forward({**bufs, **leaves}, x, cfg, mode="train"), ann,
                       ref_balances)
    ref_grads = dict(zip(leaves, torch.autograd.grad(want["tot_loss"], list(leaves.values()))))
    for k in ("tot_loss", "cls_loss", "iou_loss", "dfl_loss"):
        torch.testing.assert_close(got[k], want[k], rtol=LOSS_RTOL, atol=0, msg=k)
    assert float(got["tar_nums"]) == float(want["tar_nums"]) > 0
    norms = {k: float(v.norm()) for k, v in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    worst = max(float((grads[k] - ref_grads[k]).norm()) / max(norms[k], med) for k in norms)
    assert worst < GRAD_TOL, worst

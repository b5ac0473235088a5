"""YOLOv5 evaluator: decode, optional test-time augmentation, class-aware NMS
(greedy or soft), fixed (B, max_keep, 6) output; or Weighted Boxes Fusion
over the TTA branches (``Evaluator.detect_wbf``).

Counterpart of ``yoloseries_tpu/evaluation/yolov5.py``. The model's raw maps
are NCHW (B, A*(5+nc), H, W); the decoders view them as (B, H, W, A, 5+nc)
so the flat candidate index is ((y*W + x)*A + a) per stage, concatenated
over stages, as in the JAX package. ``decode_yolov5`` decodes in its
``dtype`` (default f32, which both packages' entry points use for a bf16
model too); the fused selection always decodes in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.anchors import YOLOV5_ANCHORS, make_grid
from ..ops.nms import candidate_gate, nms_candidates, postprocess_detections
from ..utils.trace import span, warmup

__all__ = [
    "decode_yolov5",
    "decode_topk_yolov5",
    "EvalConfig",
    "Evaluator",
    "scale_and_pad",
    "yolov5_decode_fn",
    "yolov5_select_fn",
]


def _stage_rows(pred: torch.Tensor, num_anchor: int, dtype=torch.float32) -> torch.Tensor:
    """(B, A*no, H, W) -> (B, H, W, A, no) in ``dtype``."""
    b, c, h, w = pred.shape
    no = c // num_anchor
    return pred.to(dtype).reshape(b, num_anchor, no, h, w).permute(0, 3, 4, 1, 2)


def decode_yolov5(stage_preds, anchors=YOLOV5_ANCHORS, strides=(8, 16, 32),
                  dtype=torch.float32):
    """Raw NCHW maps -> (B, N, 5+nc) [cx, cy, w, h, obj, cls...] in pixels,
    in ``dtype``: xy = (2*sigmoid - 0.5 + grid) * stride,
    wh = (2*sigmoid)^2 * anchor."""
    anchors = torch.as_tensor(np.asarray(anchors, np.float32))
    outs = []
    for si, (pred, stride) in enumerate(zip(stage_preds, strides)):
        p = torch.sigmoid(_stage_rows(pred, anchors.shape[1], dtype))
        b, h, w, a, no = p.shape
        grid = torch.from_numpy(make_grid(h, w)).to(p.device, dtype)
        anchor = anchors[si].to(p.device, dtype)
        xy = (p[..., 0:2] * 2.0 - 0.5 + grid[None, :, :, None, :]) * stride
        wh = (p[..., 2:4] * 2.0) ** 2 * anchor[None, None, None, :, :]
        out = torch.cat([xy, wh, p[..., 4:]], dim=-1)
        outs.append(out.reshape(b, h * w * a, no))
    return torch.cat(outs, dim=1)


def decode_topk_yolov5(stage_preds, anchors=YOLOV5_ANCHORS, k=512,
                       conf_threshold=0.25, cls_threshold=0.25,
                       strides=(8, 16, 32), select="auto", conf_gate="v5"):
    """Fused candidate selection + sparse decode.

    The score ``sigmoid(obj) * sigmoid(max cls)`` is gated (``conf_gate``
    "v5": obj >= conf, score > cls_thr; "v7": score >= conf, score >=
    cls_thr) and taken on the raw maps; only the K winners are decoded.
    ``select``:
    * "topk": per-stage score planes, one stable global top-k, sparse row
      gathers of the winners,
    * "sort": dense decode of six thin planes and one stable descending sort,
    * "auto": "sort" when k > 1024 else "topk". The cutoff is the JAX
      package's, picked on a TPU: a placeholder until both engines are timed
      on the card (here both sort all N scores, so they differ only in the
      decode's gathers).
    Both engines give the same candidates in the same order (equal scores,
    lower flat index first). The maps are decoded in f32, whatever the
    model's compute dtype.

    Returns boxes (B, K, 4) xyxy pixels, scores (B, K) (0 = gated/padded),
    cls_ids (B, K) float.
    """
    from .select import topk_gather

    anchors_np = np.asarray(anchors, np.float32)
    num_anchor = anchors_np.shape[1]
    if select == "auto":
        select = "sort" if k > 1024 else "topk"

    if select == "sort":
        parts = {n: [] for n in ("score", "x1", "y1", "x2", "y2", "cls")}
        for si, (pred, stride) in enumerate(zip(stage_preds, strides)):
            p = torch.sigmoid(_stage_rows(pred, num_anchor))
            b, h, w, a, _ = p.shape
            obj = p[..., 4]
            cls_conf, cls_id = p[..., 5:].amax(dim=-1), p[..., 5:].argmax(dim=-1)
            score = obj * cls_conf
            valid = candidate_gate(obj, score, conf_threshold, cls_threshold, conf_gate)
            score = torch.where(valid, score, 0.0)
            grid = torch.from_numpy(make_grid(h, w)).to(p.device)
            anchor = torch.from_numpy(anchors_np[si]).to(p.device)
            xy = (p[..., 0:2] * 2.0 - 0.5 + grid[None, :, :, None, :]) * stride
            half = ((p[..., 2:4] * 2.0) ** 2 * anchor[None, None, None, :, :]) * 0.5
            lo, hi = xy - half, xy + half

            def flat(x):
                return x.reshape(b, h * w * a)

            parts["score"].append(flat(score))
            parts["x1"].append(flat(lo[..., 0]))
            parts["y1"].append(flat(lo[..., 1]))
            parts["x2"].append(flat(hi[..., 0]))
            parts["y2"].append(flat(hi[..., 1]))
            parts["cls"].append(flat(cls_id.float()))
        planes = {n: torch.cat(v, dim=1) for n, v in parts.items()}
        score_s, order = torch.sort(planes["score"], dim=-1, descending=True,
                                    stable=True)
        kk = min(k, order.shape[1])
        order = order[:, :kk]
        score_f = score_s[:, :kk]
        boxes = torch.stack([torch.take_along_dim(planes[n], order, dim=1)
                             for n in ("x1", "y1", "x2", "y2")], dim=-1)
        cls_f = torch.take_along_dim(planes["cls"], order, dim=1)
        if kk < k:  # pad to the static K contract
            score_f = F.pad(score_f, (0, k - kk))
            cls_f = F.pad(cls_f, (0, k - kk))
            boxes = F.pad(boxes, (0, 0, 0, k - kk))
        return boxes, score_f, cls_f

    # pass 1: score planes from the raw maps; class ids only for the winners
    stage_scores, stage_rows, consts = [], [], []
    for si, (pred, stride) in enumerate(zip(stage_preds, strides)):
        rows = _stage_rows(pred, num_anchor)
        b, h, w, a, no = rows.shape
        ns = h * w * a
        p = rows.reshape(b, ns, no)
        obj = torch.sigmoid(p[..., 4])
        cls_conf = obj * torch.sigmoid(p[..., 5:].amax(dim=-1))
        valid = candidate_gate(obj, cls_conf, conf_threshold, cls_threshold, conf_gate)
        stage_scores.append(torch.where(valid, cls_conf, 0.0))
        stage_rows.append(p)
        # decode constants per flat index ((y*W + x)*A + a): grid x, grid y,
        # anchor w, anchor h, stride
        ii = np.arange(ns)
        cell, anc = ii // a, ii % a
        consts.append(np.stack([
            (cell % w).astype(np.float32),
            (cell // w).astype(np.float32),
            anchors_np[si][anc, 0],
            anchors_np[si][anc, 1],
            np.full(ns, float(stride), np.float32),
        ], axis=1))

    # pass 2: one global top-k, then sparse gathers of the K winning rows
    score_f, idx_f, (rows,) = topk_gather(stage_scores, k, [stage_rows])
    const_all = torch.from_numpy(np.concatenate(consts, axis=0)).to(score_f.device)
    ck = const_all[idx_f]  # (B, K, 5)

    cls_f = rows[..., 5:].argmax(dim=-1)
    sig = torch.sigmoid(rows[..., 0:4])
    stride_f = ck[..., 4:5]
    xy = (sig[..., 0:2] * 2.0 - 0.5 + ck[..., 0:2]) * stride_f
    half = ((sig[..., 2:4] * 2.0) ** 2 * ck[..., 2:4]) * 0.5
    boxes = torch.cat([xy - half, xy + half], dim=-1)
    return boxes, score_f, cls_f.float()


def scale_and_pad(img: torch.Tensor, scale_factor: float, pad_value: float = 0.447):
    """Bilinear downscale (align_corners=False, no antialias) then pad back
    to a /32-aligned size. img: (B, 3, H, W) float."""
    if scale_factor == 1.0:
        return img
    b, c, h, w = img.shape
    nh, nw = int(scale_factor * h), int(scale_factor * w)
    out = F.interpolate(img, size=(nh, nw), mode="bilinear", align_corners=False,
                        antialias=False)
    oh = int(np.ceil(h / 32) * 32)
    ow = int(np.ceil(w / 32) * 32)
    return F.pad(out, (0, ow - nw, 0, oh - nh), value=pad_value)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    conf_threshold: float = 0.001
    cls_threshold: float = 0.001
    iou_threshold: float = 0.65
    # pre-NMS candidate cap; 4096 keeps the count-based merge gate
    # (1 < n < 3000) exact
    num_candidates: int = 4096
    max_keep: int = 300
    class_aware: bool = True
    merge_boxes: bool = True
    use_tta: bool = False
    tta_scales: tuple = (1.0, 0.83, 0.67)
    # flip axis per TTA branch, in the JAX package's NHWC numbering:
    # None / 1 (H, up-down) / 2 (W, left-right)
    tta_flips: tuple = (None, 1, 2)
    nms_mode: str = "greedy"  # 'greedy' | 'soft_linear' | 'soft_exp'
    # Weighted Boxes Fusion over the TTA branches instead of NMS on the
    # merged set (TTA implied): ``Evaluator.__call__`` returns
    # ``detect_wbf``'s fusion with the two values below. The JAX config has
    # the flag and its ``detect_wbf``, but nothing there reads the flag
    use_wbf: bool = False
    wbf_iou_threshold: float = 0.5
    wbf_weights: tuple | None = None
    # retinanet writes the IoU-weighted merged boxes into the output rows
    merge_write_boxes: bool = False
    # the merge runs only where 1 < candidates < this (fcos: 301)
    merge_gate_max: int = 3000
    # family quirks (``Family.eval_overrides``): fcos reports sqrt of the
    # score (ctr * cls); yolov7 and fcos zero detections whose width or
    # height is not strictly above ``min_box_wh`` (None: off), after NMS;
    # the candidate gate is "v5" (obj >= conf, then obj*cls > cls_thr) but
    # "v7" for yolov7 (obj*cls >= conf, then obj*cls >= cls_thr)
    conf_sqrt: bool = False
    min_box_wh: float | None = None
    conf_gate: str = "v5"


def yolov5_decode_fn():
    """Dense decoder of the YOLOv5 family (anchors of ``YOLOV5_ANCHORS``)."""
    return lambda preds: decode_yolov5(preds, YOLOV5_ANCHORS)


def yolov5_select_fn(cfg: EvalConfig):
    """Fused candidate selection of the YOLOv5 family for ``cfg``."""
    return lambda preds: decode_topk_yolov5(
        preds, YOLOV5_ANCHORS, k=cfg.num_candidates,
        conf_threshold=cfg.conf_threshold, cls_threshold=cfg.cls_threshold,
        conf_gate=cfg.conf_gate,
    )


class Evaluator:
    """Image batch -> detections: model forward, decode (dense or fused
    candidate selection), optional TTA, NMS and merge.

    ``model(img NCHW) -> stage maps``; ``decode_fn(maps) -> (B, N, 5+nc)``;
    ``select_fn(maps) -> (boxes_xyxy, scores, cls_ids)`` (used when given).
    The NMS runs in the CUDA kernels on the card. Runs on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).

    Each call's phases run in sibling spans (``utils/trace.py``):
    ``eval.prepare`` (the copy to the device, /255, NHWC to NCHW),
    ``eval.forward`` (a branch's flip and resize, and the model),
    ``eval.select`` (decode or fused selection, the boxes mapped back) and
    ``eval.nms`` (the branches merged, NMS, the family's quirks). The first
    call at each input shape and dtype runs inside ``warmup.eval``.
    """

    def __init__(self, model: torch.nn.Module, decode_fn: Callable, cfg: EvalConfig,
                 select_fn: Callable | None = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.decode_fn = decode_fn
        self.cfg = cfg
        self.select_fn = select_fn
        self._shapes = set()  # (shape, dtype) of the inputs called so far

    def _branch_specs(self, tta: bool):
        """(scale, flip) per TTA branch; one plain branch without TTA."""
        return list(zip(self.cfg.tta_scales, self.cfg.tta_flips)) if tta else [(1.0, None)]

    @staticmethod
    def _branch_image(img, s, f, tta: bool):
        """A branch's input from img (B, 3, H, W): img itself without TTA,
        else flipped along ``f`` and scaled by ``s``."""
        if not tta:
            return img
        # JAX NHWC axis 1 (H) / 2 (W) -> NCHW dim 2 / 3
        x = torch.flip(img, dims=(f + 1,)) if f is not None else img
        return scale_and_pad(x, s)

    @staticmethod
    def _adjust_boxes(boxes, s, f, img_h, img_w):
        """Undo a TTA branch's scale/flip on xyxy candidate boxes."""
        boxes = boxes / s if s != 1.0 else boxes
        x0, y0, x1, y1 = boxes.unbind(-1)
        if f == 1:  # flipped along H -> mirror y, corners swap
            y0, y1 = img_h - y1, img_h - y0
        if f == 2:  # flipped along W -> mirror x
            x0, x1 = img_w - x1, img_w - x0
        return torch.stack([x0, y0, x1, y1], dim=-1)

    @staticmethod
    def _adjust_preds(p, s, f, img_h, img_w):
        """Undo a TTA branch's scale/flip on dense [cx, cy, w, h, ...] rows."""
        p = p.clone()
        p[..., 0:4] = p[..., 0:4] / s
        if f == 1:  # flipped along H -> mirror y
            p[..., 1] = img_h - p[..., 1]
        if f == 2:  # flipped along W -> mirror x
            p[..., 0] = img_w - p[..., 0]
        return p

    def _branch_outputs(self, img, tta: bool):
        """Per branch: candidates (boxes, scores, cls_ids) through
        ``select_fn``, else the dense decoded rows, mapped back to ``img``."""
        img_h, img_w = img.shape[2], img.shape[3]
        outs = []
        for s, f in self._branch_specs(tta):
            with span("eval.forward"):
                maps = self.model(self._branch_image(img, s, f, tta))
            with span("eval.select"):
                if self.select_fn is not None:
                    boxes, scores, cls_ids = self.select_fn(maps)
                    outs.append((self._adjust_boxes(boxes, s, f, img_h, img_w), scores,
                                 cls_ids))
                else:
                    p = self.decode_fn(maps)
                    outs.append(self._adjust_preds(p, s, f, img_h, img_w) if tta else p)
        return outs

    def _nms(self, branches):
        """(B, max_keep, 6) detections of the candidates of ``branches``
        merged along the candidate axis."""
        cfg = self.cfg
        kw = dict(iou_threshold=cfg.iou_threshold, max_keep=cfg.max_keep,
                  class_aware=cfg.class_aware, merge_boxes=cfg.merge_boxes,
                  nms_mode=cfg.nms_mode, merge_write_boxes=cfg.merge_write_boxes,
                  merge_gate_max=cfg.merge_gate_max)
        with span("eval.nms"):
            if self.select_fn is not None:
                merged = tuple(torch.cat(parts, dim=1) for parts in zip(*branches))
                return self._finalize(nms_candidates(*merged, **kw))
            return self._finalize(postprocess_detections(
                torch.cat(branches, dim=1), conf_threshold=cfg.conf_threshold,
                cls_threshold=cfg.cls_threshold, num_candidates=cfg.num_candidates,
                conf_gate=cfg.conf_gate, **kw))

    def _finalize(self, out):
        """The family's post-NMS quirks on (B, max_keep, 6) rows: conf 0
        where w or h is not strictly above ``min_box_wh``, then the square
        root of conf with ``conf_sqrt``."""
        if self.cfg.min_box_wh is None and not self.cfg.conf_sqrt:
            return out
        conf = out[..., 4]
        if self.cfg.min_box_wh is not None:
            m = self.cfg.min_box_wh
            big = ((out[..., 2] - out[..., 0]) > m) & ((out[..., 3] - out[..., 1]) > m)
            conf = torch.where(big, conf, 0.0)
        if self.cfg.conf_sqrt:
            conf = torch.sqrt(conf)
        return torch.cat([out[..., :4], conf[..., None], out[..., 5:]], dim=-1)

    def _prepare(self, img) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float, numpy or tensor -> (B, 3, H, W) f32
        in [0, 1] on the evaluator's device."""
        with span("eval.prepare"):
            img = torch.as_tensor(img).to(self.device)
            img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
            return img.permute(0, 3, 1, 2).contiguous()

    @torch.inference_mode()
    def __call__(self, img) -> torch.Tensor:
        """img: (B, H, W, 3) uint8 in [0, 255] or float in [0, 1], numpy or
        tensor. Returns (B, max_keep, 6) [x1, y1, x2, y2, conf, cls] in
        letterboxed input pixels on the evaluator's device; unused slots
        have conf 0. With ``cfg.use_wbf`` the rows are :meth:`detect_wbf`'s
        fused detections, the first ``max_keep`` by descending conf."""
        with warmup("warmup.eval", self._shapes, (np.shape(img), getattr(img, "dtype", None))):
            if not self.cfg.use_wbf:
                return self._nms(self._branch_outputs(self._prepare(img), self.cfg.use_tta))
            fused = self.detect_wbf(img)
            rows = np.zeros((len(fused), self.cfg.max_keep, 6), np.float32)
            for i, dets in enumerate(fused):
                if dets is not None:
                    dets = dets[:self.cfg.max_keep]
                    rows[i, :len(dets)] = dets
            return torch.from_numpy(rows).to(self.device)

    @torch.inference_mode()
    def detect_wbf(self, img) -> list:
        """TTA + Weighted Boxes Fusion: each TTA branch is postprocessed on
        the evaluator's device, the branches come to the host in one copy,
        and the fusion runs per image there. Returns per-image (n, 6) arrays
        in letterboxed input pixels, None where nothing survives."""
        from ..ops.wbf import weighted_boxes_fusion

        branches = torch.stack([self._nms([b]) for b in
                                self._branch_outputs(self._prepare(img), tta=True)])
        branches = branches.cpu().numpy()  # (n_branches, B, max_keep, 6)
        n_br = branches.shape[0]
        weights = list(self.cfg.wbf_weights or [1.0] * n_br)
        out = []
        for i in range(branches.shape[1]):
            per_branch = [branches[m, i][branches[m, i][:, 4] > 0] for m in range(n_br)]
            fused = weighted_boxes_fusion(per_branch, weights=weights,
                                          iou_thr=self.cfg.wbf_iou_threshold)
            out.append(fused if len(fused) else None)
        return out

    @staticmethod
    def to_host_detections(dets, infos=None) -> list:
        """(B, K, 6) -> list of per-image (n, 6) numpy arrays in original
        image coordinates (None where an image has no detections).
        infos: optional (B, 5) [scale, pad_left, pad_top, org_w, org_h]."""
        dets = dets.detach().cpu().numpy() if torch.is_tensor(dets) else np.asarray(dets)
        out = []
        for i in range(dets.shape[0]):
            d = dets[i]
            d = d[d[:, 4] > 0]
            if len(d) == 0:
                out.append(None)
                continue
            if infos is not None:
                scale, pad_l, pad_t, org_w, org_h = np.asarray(infos[i])
                d = d.copy()
                d[:, [0, 2]] = ((d[:, [0, 2]] - pad_l) / scale).clip(0, org_w)
                d[:, [1, 3]] = ((d[:, [1, 3]] - pad_t) / scale).clip(0, org_h)
            out.append(d)
        return out

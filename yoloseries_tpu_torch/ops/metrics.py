"""COCO-style mAP on the host (numpy), a copy of ``yoloseries_tpu/ops/metrics.py``
(the reference's mAP_v2 semantics): greedy unique gt<->pred matching sorted
by IoU, per-class cumulative P/R with confidence-interpolated curves,
101-point interpolated AP with a monotone precision envelope, and the
detection confusion matrix. Images where either the gt or the prediction
set is empty are dropped before accumulation, as the reference does.

``gather_across_processes`` merges the per-prediction statistics of every
rank of a ``torch.distributed`` run, so each rank's ``compute`` sees the
whole val set; ``plot_metrics`` and ``ConfusionMatrix.plot`` draw with
matplotlib, imported where they are called.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConfusionMatrix", "DetectionMetrics", "pairwise_iou_np", "compute_tp", "compute_ap",
           "plot_metrics"]

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 names it trapz


def pairwise_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """(M, 4) x (N, 4) -> (M, N) IoU in xyxy, eps semantics of utils/mAP.py:18-42."""
    b1 = np.expand_dims(box1, axis=1)
    area1 = np.prod(b1[..., [2, 3]] - b1[..., [0, 1]], axis=-1)
    area2 = np.prod(box2[:, [2, 3]] - box2[:, [0, 1]], axis=-1)
    ixmin = np.maximum(b1[..., 0], box2[:, 0])
    iymin = np.maximum(b1[..., 1], box2[:, 1])
    ixmax = np.minimum(b1[..., 2], box2[:, 2])
    iymax = np.minimum(b1[..., 3], box2[:, 3])
    iw = np.maximum(0.0, ixmax - ixmin)
    ih = np.maximum(0.0, iymax - iymin)
    inter = iw * ih
    return inter / np.clip(area1 + area2 - inter, 1e-6, 1e7)


def compute_tp(gt: np.ndarray, pred: np.ndarray,
               iou_thresholds: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """True-positive table for one image.

    gt: (N, 5) [x1,y1,x2,y2,cls]; pred: (M, 6) [x1,y1,x2,y2,conf,cls].
    Returns (M, T) bool. Greedy one-to-one matching sorted by IoU descending,
    each prediction claims at most one gt and vice versa (utils/mAP.py:70-100).
    """
    tp = np.zeros((pred.shape[0], len(iou_thresholds)), dtype=bool)
    if len(gt) == 0 or len(pred) == 0:
        return tp
    ious = pairwise_iou_np(gt[:, :4], pred[:, :4])  # (N, M)
    mask = (ious >= iou_thresholds[0]) & (gt[:, [4]] == pred[:, 5])
    if mask.sum() > 0:
        gt_i, pred_i = np.nonzero(mask)
        match = np.concatenate(
            [np.stack([gt_i, pred_i], axis=1), ious[mask][:, None]], axis=1
        )
        if mask.sum() > 1:
            match = match[match[:, 2].argsort()[::-1]]
            match = match[np.unique(match[:, 1], return_index=True)[1]]
            match = match[np.unique(match[:, 0], return_index=True)[1]]
        tp[match[:, 1].astype(np.int32)] = match[:, [2]] >= iou_thresholds
    return tp


def compute_ap(recall: np.ndarray, precision: np.ndarray, style: str = "coco"):
    """AP from raw cumulative P/R arrays (utils/mAP.py:171-189)."""
    rec = np.concatenate(([0.0], recall, [1.0]))
    pre = np.concatenate(([1.0], precision, [0.0]))
    pre = np.flip(np.maximum.accumulate(np.flip(pre)))
    if style == "coco":
        xs = np.linspace(0, 1, 101)
        ap = _trapezoid(np.interp(xs, rec, pre), xs)
    else:
        i = np.where(rec[1:] != rec[:-1])[0]
        ap = np.sum((rec[i + 1] - rec[i]) * pre[i + 1])
    return ap, rec, pre


def _smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather a per-rank (N_r, D) float64 array with varying N_r, in
    rank order: the lengths first, then the rows padded to the longest. The
    rows cross as float64 (gloo and NCCL both carry it), so the confidences
    sort as they would on one process."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    world = dist.get_world_size()
    n = torch.tensor([rows.shape[0]], dtype=torch.int64, device=dev)
    ns = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(ns, n)
    ns = [int(x.item()) for x in ns]
    pad = torch.zeros((max(max(ns), 1), rows.shape[1]), dtype=torch.float64, device=dev)
    pad[:rows.shape[0]] = torch.from_numpy(np.ascontiguousarray(rows, np.float64)).to(dev)
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad)
    return np.concatenate([p[:k].cpu().numpy() for p, k in zip(parts, ns)], axis=0)


class DetectionMetrics:
    """Accumulate per-image (gt, pred) pairs and produce COCO-style metrics."""

    def __init__(self, style: str = "coco"):
        self.style = style
        self.gts: list[np.ndarray] = []
        self.preds: list[np.ndarray] = []
        # set by gather_across_processes(): the statistics of every rank
        self._global: tuple | None = None

    def add_image(self, gt, pred):
        """gt: (N, 5) or None; pred: (M, 6) or None.

        Pairs with an empty side are dropped (reference protocol,
        utils/mAP.py:58-63)."""
        if gt is None or pred is None:
            return
        gt = np.asarray(gt, dtype=np.float64)
        pred = np.asarray(pred, dtype=np.float64)
        if len(gt) > 0 and len(pred) > 0:
            self.gts.append(gt)
            self.preds.append(pred)

    def _flatten(self):
        """Per-prediction sufficient statistics: (tps (P, T) bool, conf (P,),
        cls (P,), tar_cls (G,)). The greedy gt<->pred matching (compute_tp)
        is per-image, so it runs here — BEFORE any cross-process merge."""
        if not self.gts:
            t = len(IOU_THRESHOLDS)
            z = np.zeros((0,), np.float64)
            return np.zeros((0, t), bool), z, z, z
        tps = np.concatenate(
            [compute_tp(g, p) for g, p in zip(self.gts, self.preds)], axis=0
        )
        pred_all = np.concatenate(self.preds, axis=0)
        gt_all = np.concatenate(self.gts, axis=0)
        return tps, pred_all[:, 4], pred_all[:, 5], gt_all[:, 4]

    def gather_across_processes(self):
        """Merge every rank's statistics so that each rank's ``compute``
        sees the whole val set (``evaluate()`` gives each rank a contiguous
        part of it, so rank order is the one-process order). The per-image
        matching (``compute_tp``) runs before the merge. The identity
        without an initialized process group of more than one rank.
        Returns self."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self
        tps, conf, cls_, tar_cls = self._flatten()
        t = tps.shape[1]
        rows = _allgather_rows(np.concatenate([tps.astype(np.float64), conf[:, None],
                                               cls_[:, None]], axis=1))
        tar_cls = _allgather_rows(tar_cls[:, None])[:, 0]
        self._global = (rows[:, :t].astype(bool), rows[:, t], rows[:, t + 1], tar_cls)
        return self

    def compute(self) -> dict:
        """Returns dict with map, map50, mp, mr plus per-class arrays."""
        tps, conf, cls_, tar_cls = (self._global if self._global is not None
                                    else self._flatten())
        if len(tps) == 0 or len(tar_cls) == 0:
            return {
                "map": 0.0, "map50": 0.0, "mp": 0.0, "mr": 0.0,
                "ap": np.zeros((0, len(IOU_THRESHOLDS))),
                "unique_cls": np.zeros((0,)),
                "precision": np.zeros((0,)), "recall": np.zeros((0,)),
                "f1": np.zeros((0,)), "pr_curves": [],
                "conf_axis": np.linspace(0, 1, 1000),
            }

        sort_i = np.argsort(conf)[::-1]
        sorted_tps = tps[sort_i]
        sorted_conf = conf[sort_i]
        sorted_cls = cls_[sort_i]

        classes = np.unique(tar_cls)
        n_thr = sorted_tps.shape[1]
        ap = np.zeros((len(classes), n_thr))
        precision = np.zeros((len(classes), 1000))
        recall = np.zeros((len(classes), 1000))
        xs = np.linspace(0, 1, 1000)
        pr_curves = []

        for i, c in enumerate(classes):
            m = sorted_cls == c
            num_tar = (tar_cls == c).sum()
            if m.sum() == 0 or num_tar == 0:
                continue
            cum_fp = (~sorted_tps[m]).cumsum(0)
            cum_tp = sorted_tps[m].cumsum(0)
            cum_recall = cum_tp / (num_tar + 1e-16)
            cum_precision = cum_tp / (cum_tp + cum_fp + 1e-16)
            recall[i] = np.interp(-xs, -sorted_conf[m], cum_recall[:, 0], left=0)
            precision[i] = np.interp(-xs, -sorted_conf[m], cum_precision[:, 0], left=1)
            for j in range(n_thr):
                ap[i, j], rec, pre = compute_ap(
                    cum_recall[:, j], cum_precision[:, j], self.style
                )
                if j == 0:
                    pr_curves.append(np.interp(xs, rec, pre))

        f1 = 2 * precision * recall / (precision + recall + 1e-16)
        best_i = _smooth(f1.mean(0), 0.1).argmax() if len(classes) else 0

        apm = ap.mean(axis=1) if len(classes) else np.zeros((0,))
        return {
            "map": float(apm.mean()) if len(classes) else 0.0,
            "map50": float(ap[:, 0].mean()) if len(classes) else 0.0,
            "mp": float(precision[:, best_i].mean()) if len(classes) else 0.0,
            "mr": float(recall[:, best_i].mean()) if len(classes) else 0.0,
            "ap": ap,
            "unique_cls": classes,
            "precision": precision[:, best_i] if len(classes) else np.zeros((0,)),
            "recall": recall[:, best_i] if len(classes) else np.zeros((0,)),
            "f1": f1[:, best_i] if len(classes) else np.zeros((0,)),
            "pr_curves": pr_curves,
            "conf_axis": xs,
        }


class ConfusionMatrix:
    """Detection confusion matrix (utils/mAP.py:279-365 rebuild).

    (num_class + 1) square matrix; the extra row/col is background
    (missed gt / spurious prediction). Predictions below ``conf_thres`` are
    dropped; matches require IoU >= ``iou_thres`` with greedy one-to-one
    resolution like compute_tp.
    """

    def __init__(self, num_class: int, conf_thres: float = 0.25,
                 iou_thres: float = 0.45):
        self.nc = num_class
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.matrix = np.zeros((num_class + 1, num_class + 1), dtype=np.int64)

    def add_image(self, gt, pred):
        """gt (N, 5) [x1,y1,x2,y2,cls]; pred (M, 6) [x1,y1,x2,y2,conf,cls]."""
        gt = np.asarray(gt, np.float64) if gt is not None else np.zeros((0, 5))
        pred = (
            np.asarray(pred, np.float64) if pred is not None else np.zeros((0, 6))
        )
        if len(pred):
            pred = pred[pred[:, 4] >= self.conf_thres]

        if len(gt) == 0:
            for p in pred:
                self.matrix[int(p[5]), self.nc] += 1  # false positive
            return
        if len(pred) == 0:
            for g in gt:
                self.matrix[self.nc, int(g[4])] += 1  # missed
            return

        ious = pairwise_iou_np(gt[:, :4], pred[:, :4])
        mask = ious >= self.iou_thres
        gt_i, pred_i = np.nonzero(mask)
        if len(gt_i):
            match = np.stack([gt_i, pred_i, ious[mask]], axis=1)
            if len(match) > 1:
                match = match[match[:, 2].argsort()[::-1]]
                match = match[np.unique(match[:, 1], return_index=True)[1]]
                match = match[np.unique(match[:, 0], return_index=True)[1]]
        else:
            match = np.zeros((0, 3))

        matched_gt = set(match[:, 0].astype(int)) if len(match) else set()
        matched_pred = set(match[:, 1].astype(int)) if len(match) else set()
        for gi, pi, _ in match:
            self.matrix[int(pred[int(pi), 5]), int(gt[int(gi), 4])] += 1
        for gi in range(len(gt)):
            if gi not in matched_gt:
                self.matrix[self.nc, int(gt[gi, 4])] += 1
        for pi in range(len(pred)):
            if pi not in matched_pred:
                self.matrix[int(pred[pi, 5]), self.nc] += 1

    def plot(self, save_path, names=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 10))
        ax.imshow(self.matrix, cmap="Blues")
        labels = (names or [str(i) for i in range(self.nc)]) + ["background"]
        ax.set_xticks(range(self.nc + 1))
        ax.set_yticks(range(self.nc + 1))
        ax.set_xticklabels(labels, rotation=90)
        ax.set_yticklabels(labels)
        ax.set_xlabel("ground truth")
        ax.set_ylabel("prediction")
        for i in range(self.nc + 1):
            for j in range(self.nc + 1):
                if self.matrix[i, j]:
                    ax.text(j, i, str(self.matrix[i, j]), ha="center", va="center")
        fig.tight_layout()
        fig.savefig(str(save_path), dpi=150)
        plt.close(fig)


def plot_metrics(metrics: dict, save_dir, cls2lab=None):
    """The reference's PR curve (``PRCurve.png``: each class's 101-point
    curve at IoU .5 and their mean) and per-class AP bars
    (``AP_Per_Class.png``) of a ``DetectionMetrics.compute`` result, in
    ``save_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pathlib import Path

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    xs = metrics["conf_axis"]
    if metrics["pr_curves"]:
        fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
        ys = np.stack(metrics["pr_curves"], axis=1)
        ax.plot(xs, ys, linewidth=1, color="grey")
        ax.plot(xs, ys.mean(axis=1), linewidth=2, color="red",
                label=f"all classes {metrics['map50']:.2f} mAP@0.5")
        ax.set_ylabel("Precision")
        ax.set_xlabel("Recall")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_title("Precision-Recall")
        ax.legend(loc=0)
        fig.savefig(str(save_dir / "PRCurve.png"), dpi=150)
        plt.close(fig)

    ap = metrics["ap"]
    if len(ap):
        apm = ap.mean(axis=1)
        order = np.argsort(apm)
        fig = plt.figure(figsize=[10, 10])
        labels = [(cls2lab[int(metrics["unique_cls"][i])] if cls2lab
                   else str(int(metrics["unique_cls"][i]))) for i in order]
        plt.barh(labels, apm[order], height=0.8, align="center")
        plt.xlabel("mAP")
        plt.ylabel("Category")
        plt.title(f"mAP {apm.mean():.3f}")
        plt.tight_layout()
        plt.savefig(str(save_dir / "AP_Per_Class.png"), dpi=150)
        plt.close(fig)

"""mAP validation of a checkpoint with the port.

    python -m yoloseries_tpu_torch.cli.val --model yolov5s --ckpt-dir runs/checkpoints \
        --val-img-dir ... --val-lab-dir ... [--tta] [--device cpu]

The arguments of the JAX package's ``cli/val.py``, plus ``--device``
(default ``cuda``: no card is an error unless ``--device cpu``). The newest
checkpoint that the port's ``cli/train.py`` wrote under ``--ckpt-dir`` is
restored into a train state; its EMA weights (``--params ema``, the
default) or its trained ones (``raw``) are scored at the protocol
thresholds (conf .001, iou .65, K=4096 unless the ``--cfg`` hyp says
otherwise), predictions and ground truth un-letterboxed to the original
images. ``--save-pkl-dir`` pickles both, per image. A hyp with
``s2d_stem: true`` builds the space-to-depth stem the checkpoint was trained
with. ``--plot-dir`` needs the curve plots, which are not ported yet
(ROADMAP A10).
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default=None, help="YAML config (reference format)")
    p.add_argument("--model", default="yolov5s")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--val-img-dir", required=True)
    p.add_argument("--val-lab-dir", required=True)
    p.add_argument("--name-path", default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--plot-dir", default=None, help="P/R/F1/PR curves (not ported yet)")
    p.add_argument("--params", choices=["ema", "raw"], default="ema",
                   help="score the EMA weights (default) or the trained ones")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--save-pkl-dir", default=None,
                   help="write pred_bbox_<size>_<model>.pkl and gt_bbox.pkl here")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.plot_dir:
        raise NotImplementedError("--plot-dir: the metric plots are not ported yet (ROADMAP A10)")

    from ..configs import load_hyp
    from ..data import DataLoader, DetectionDataset
    from ..device import resolve_device
    from ..evaluation import EvalConfig, Evaluator
    from ..families import get_family
    from ..models import create_model
    from ..ops.metrics import DetectionMetrics
    from ..train.checkpoint import restore_weights

    device = resolve_device(args.device)
    hyp = load_hyp(args.cfg) if args.cfg else {}
    hyp.setdefault("use_tta", args.tta)
    input_size = (args.input_size, args.input_size)

    dataset = DetectionDataset(args.val_img_dir, args.val_lab_dir, args.name_path,
                               input_size=input_size, enable_aug=False)
    num_class = dataset.num_class
    # s2d_stem changes the stem kernel's layout in the checkpoint: build the
    # model with the knob the training run used
    model_kw = {"s2d_stem": True} if hyp.get("s2d_stem") else {}
    model = create_model(args.model, num_class=num_class, device="cpu", **model_kw)
    family = get_family(args.model)
    step = restore_weights(model, args.ckpt_dir, params=args.params, device=device)
    if step is None:
        raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
    print(f"loaded checkpoint at step {step}")

    eval_cfg = EvalConfig(
        conf_threshold=hyp.get("compute_metric_conf_threshold", 0.001),
        cls_threshold=hyp.get("compute_metric_cls_threshold", 0.001),
        iou_threshold=hyp.get("compute_metric_iou_threshold", 0.65),
        num_candidates=hyp.get("eval_num_candidates", hyp.get("pre_nms_topk", 4096)),
        max_keep=hyp.get("max_predictions_per_img", 300),
        use_tta=hyp.get("use_tta", False),
    )
    eval_cfg = family.apply_eval_overrides(eval_cfg, hyp)
    select_builder = (family.make_select(hyp, num_class, input_size)
                      if family.make_select else None)
    evaluator = Evaluator(model, family.make_decode(hyp, num_class, input_size), eval_cfg,
                          select_fn=select_builder(eval_cfg) if select_builder else None,
                          device=device)

    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False, infinite=False,
                        enable_aug=False)
    metrics = DetectionMetrics()
    all_preds, all_gts = [], []
    try:
        for bi, batch in enumerate(loader):
            if args.max_batches is not None and bi >= args.max_batches:
                break
            preds = Evaluator.to_host_detections(evaluator(batch["img"]), batch["info"])
            for i, pred in enumerate(preds):
                valid = batch["ann"][i][:, 4] >= 0
                gt = batch["ann"][i][valid]
                scale, pl, pt, ow, oh = batch["info"][i]
                g = np.zeros((int(valid.sum()), 5))
                g[:, 0] = ((gt[:, 0] - pl) / scale).clip(0, ow)
                g[:, 1] = ((gt[:, 1] - pt) / scale).clip(0, oh)
                g[:, 2] = ((gt[:, 2] - pl) / scale).clip(0, ow)
                g[:, 3] = ((gt[:, 3] - pt) / scale).clip(0, oh)
                g[:, 4] = gt[:, 4]
                metrics.add_image(g, pred)
                if args.save_pkl_dir:
                    all_preds.append(np.zeros((0, 6)) if pred is None else np.asarray(pred))
                    all_gts.append(g)
    finally:
        loader.stop()

    if args.save_pkl_dir:
        pkl_dir = Path(args.save_pkl_dir)
        pkl_dir.mkdir(parents=True, exist_ok=True)
        with open(pkl_dir / f"pred_bbox_{args.input_size}_{args.model}.pkl", "wb") as f:
            pickle.dump(all_preds, f)
        with open(pkl_dir / "gt_bbox.pkl", "wb") as f:
            pickle.dump(all_gts, f)
        print(f"prediction/gt pickles saved to {pkl_dir}")

    out = metrics.compute()
    print(f"mAP@0.5:0.95 {out['map']:.4f}  mAP@0.5 {out['map50']:.4f}  "
          f"P {out['mp']:.4f}  R {out['mr']:.4f}")
    return out


if __name__ == "__main__":
    main()

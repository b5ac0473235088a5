"""Folder inference with the port.

    python -m yoloseries_tpu_torch.cli.detect --ckpt-dir runs/checkpoints \
        --img-dir photos/ --name-path names.txt [--conf 0.3] [--iou 0.2] [--device cpu]

Weights come from exactly one of ``--ckpt-dir`` (the EMA weights of the
newest checkpoint that the port's ``cli/train.py`` wrote) and ``--weights``:
a port ``state_dict`` saved with ``torch.save`` (``.pt``) or the JAX
package's trees in an ``.npz`` whose keys are ``params/...`` and
``batch_stats/...`` paths joined by ``/``. The class count comes from
``--name-path``, else ``--num-class``. Images are letterboxed on the host,
run through ``Evaluator`` with the decode and the fused selection of the
model's family (``families.py``: every family of the JAX package) and
class-aware NMS
on the card, and the detections, in original-image pixels, are written as
JSON.

Each conv+BN pair is folded into one biased conv before inference
(``nn/deploy.py::fold_conv_bn``), and YOLOv7's RepConvs then into their
deploy form (``fold_repconv``); ``--no-fuse`` keeps the BN passes and the
three RepConv branches. A model without BN (FCOS's GroupNorm ResNet) has
nothing to fold.
``--s2d-stem`` builds the space-to-depth stem (a checkpoint trained with
``s2d_stem: true``; YOLOv5 and YOLOX on the CSP trunk); ``--bf16`` computes
in bfloat16. A flag the model has no knob for raises ``ValueError``. Not ported yet:
drawing the boxes on the images (ROADMAP A10).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..evaluation import EvalConfig, Evaluator
from ..families import get_family
from ..models import create_model
from ..nn.deploy import fold_conv_bn, fold_repconv
from ..utils.weights import state_dict_from_jax, unflatten_tree

__all__ = ["detect_batch", "load_weights", "main"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_weights(model: torch.nn.Module, path) -> None:
    """Load a ``.pt`` port ``state_dict`` or an ``.npz`` of JAX trees."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            tree = unflatten_tree({tuple(k.split("/")): data[k] for k in data.files})
        sd = state_dict_from_jax(tree["params"], tree.get("batch_stats", {}))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)


def detect_batch(evaluator: Evaluator, batch_u8, infos=None) -> list:
    """Letterboxed uint8 batch (B, H, W, 3) -> per-image (n, 6) numpy arrays
    [x1, y1, x2, y2, conf, cls] (None where nothing is detected), mapped to
    original-image pixels when ``infos`` (B, 5) is given."""
    dets = evaluator(batch_u8)
    return Evaluator.to_host_detections(dets, infos)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="yolov5s")
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--ckpt-dir", default=None, help="the EMA weights of the newest step")
    source.add_argument("--weights", default=None, help="a .pt state_dict or an .npz of JAX trees")
    p.add_argument("--img-dir", required=True)
    p.add_argument("--save-dir", default="detect_out")
    p.add_argument("--name-path", default=None)
    p.add_argument("--num-class", type=int, default=None,
                   help="required when --name-path is absent")
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--iou", type=float, default=0.2)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--s2d-stem", action="store_true",
                   help="the checkpoint was trained with s2d_stem: true")
    p.add_argument("--no-fuse", dest="fuse", action="store_false",
                   help="keep the BN passes (no conv+BN fold before inference)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image  # only the CLI reads image files

    from ..data.dataset import load_names
    from ..device import resolve_device
    from ..ops.letterbox import letterbox_image
    from ..train.checkpoint import restore_weights

    device = resolve_device(args.device)
    if args.name_path:
        num_class = max(load_names(args.name_path)) + 1
    elif args.num_class:
        num_class = args.num_class
    else:
        raise SystemExit("pass --name-path or --num-class")
    model_kw = {"dtype": torch.bfloat16} if args.bf16 else {}
    if args.s2d_stem:
        model_kw["s2d_stem"] = True
    model = create_model(args.model, num_class=num_class, device="cpu", **model_kw)
    if args.ckpt_dir:
        step = restore_weights(model, args.ckpt_dir, device=device)
        if step is None:
            raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
        print(f"loaded checkpoint at step {step}")
    else:
        load_weights(model, args.weights)
    if args.fuse and any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        fold_conv_bn(model.eval())
        print("fused conv+bn for deploy (BN running stats folded into conv weights and biases)")
        if getattr(model, "deploy", None) is False:  # YOLOv7's RepConvs
            fold_repconv(model)
            print("reparameterized RepConv branches for deploy")
    family = get_family(args.model)
    size = (args.input_size, args.input_size)
    cfg = family.apply_eval_overrides(EvalConfig(conf_threshold=args.conf,
                                                 cls_threshold=args.conf,
                                                 iou_threshold=args.iou, merge_boxes=True))
    select_builder = family.make_select({}, num_class, size) if family.make_select else None
    evaluator = Evaluator(model, family.make_decode({}, num_class, size), cfg,
                          select_builder(cfg) if select_builder else None, device=device)

    paths = sorted(p for p in Path(args.img_dir).iterdir()
                   if p.suffix.lower() in IMG_EXTENSIONS)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for start in range(0, len(paths), args.batch_size):
        chunk = paths[start:start + args.batch_size]
        batch = np.zeros((args.batch_size, *size, 3), np.uint8)
        infos = np.ones((args.batch_size, 5), np.float32)  # padding rows: identity
        for i, p in enumerate(chunk):
            raw = np.asarray(Image.open(p).convert("RGB"))
            batch[i], info = letterbox_image(raw, size, stride=32)
            infos[i] = info.as_array()
        t0 = time.perf_counter()
        preds = detect_batch(evaluator, batch, infos)[:len(chunk)]
        dt = time.perf_counter() - t0
        for p, det in zip(chunk, preds):
            n = 0 if det is None else len(det)
            results[p.name] = [] if det is None else det.tolist()
            print(f"{p.name}: {n} boxes ({dt / len(chunk):.3f}s/img)")
    out = save_dir / "detections.json"
    out.write_text(json.dumps(results))
    print(f"saved to {out}")
    return results


if __name__ == "__main__":
    main()

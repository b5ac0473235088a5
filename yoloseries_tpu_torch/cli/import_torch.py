"""Import a reference PyTorch checkpoint into the port's checkpoint layout,
so that ``cli/val.py --ckpt-dir`` and ``cli/detect.py --ckpt-dir`` read it.

    python -m yoloseries_tpu_torch.cli.import_torch --model yolov5s \
        --pth yolov5_small.pth --num-class 80 --out runs_import [--s2d-stem] [--device cpu]

The arguments of the JAX package's ``cli/import_torch.py``, plus
``--device`` (default ``cuda``: no card is an error unless ``--device
cpu``). The blob is the reference's ``Training.save_model`` dict
(``model_state_dict``, ``ema``, ``hyp``, ``step``) or a bare
``state_dict``; DDP's ``module.`` prefixes are stripped
(``utils/weights.py::read_torch_blob``). The raw weights fill the model,
the EMA weights (what the reference validates with) the EMA slot, a copy of
the raw ones when the blob has none; ``hyp`` and ``step`` are recorded. The
port's modules carry the reference's ``state_dict`` names, so each blob
loads strictly as it is: a name the port lacks, or one it lacks in the blob,
raises. A YOLOv7 blob in the deploy form (``rbr_reparam``) builds the model
with ``deploy=True``. ``--s2d-stem`` maps the 6x6 stem kernel to the
space-to-depth layout (``nn/deploy.py::fold_stem_to_s2d``) and records
``s2d_stem: true`` in the hyp.

The accepted names are those that have a reference layout: the YOLOv5
specs, YOLOX s/m/l, YOLOv7, YOLOv8, RetinaNet and FCOS. YOLOX on DarkNet
and FCOS on the CSP trunk have none (their names are the JAX module paths).
"""

from __future__ import annotations

import argparse
from pathlib import Path

__all__ = ["main", "parse_args", "check_reference_layout"]

# models whose name prefix has a converter in the JAX package but whose
# modules follow no reference layout
_NO_REFERENCE = ("yolox_darknet", "fcos_cspnet")
_PREFIXES = ("yolov5", "yolox", "yolov7", "yolov8", "retinanet", "fcos")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="yolov5s/m/l/x, yolox_s/m/l, yolov7, yolov8, retinanet, fcos")
    p.add_argument("--pth", required=True, help="reference .pth checkpoint")
    p.add_argument("--num-class", type=int, required=True)
    p.add_argument("--out", required=True, help="run dir (checkpoints/ is made inside)")
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--s2d-stem", action="store_true",
                   help="map the 6x6/2 stem to the space-to-depth layout (pair with "
                        "`s2d_stem: true` at train and val time)")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p.parse_args(argv)


def check_reference_layout(model_name: str) -> None:
    """Raise ``SystemExit`` unless ``model_name`` has a reference layout."""
    if model_name.startswith(_NO_REFERENCE):
        raise SystemExit(f"{model_name} has no reference state_dict layout (its names are the "
                         "JAX module paths); import its weights from the JAX package as .npz")
    if not model_name.startswith(_PREFIXES):
        raise SystemExit(f"no converter for {model_name}")


def main(argv=None):
    args = parse_args(argv)
    check_reference_layout(args.model)
    from ..device import resolve_device, set_numeric_mode
    from ..families import get_family
    from ..models import create_model
    from ..nn.deploy import fold_stem_to_s2d
    from ..train.checkpoint import save_checkpoint
    from ..train.optim import OptimizerConfig
    from ..train.state import create_train_state
    from ..utils.weights import read_torch_blob

    device = resolve_device(args.device)
    set_numeric_mode()
    blob = read_torch_blob(args.pth)
    raw, ema, hyp, step = blob["raw"], blob["ema"], blob["hyp"], blob["step"]
    model_kw = {}
    if args.s2d_stem:
        raw, ema = fold_stem_to_s2d(raw), None if ema is None else fold_stem_to_s2d(ema)
        hyp["s2d_stem"] = True
        model_kw["s2d_stem"] = True
    if any("rbr_reparam" in k for k in raw):
        model_kw["deploy"] = True
    model = create_model(args.model, num_class=args.num_class, device="cpu", **model_kw)
    model.load_state_dict(raw)
    size = (args.input_size, args.input_size)
    _, balances0 = get_family(args.model).make_loss(hyp, args.num_class, size)
    state = create_train_state(model, OptimizerConfig(batch_size=int(hyp.get("batch_size", 8) or 8)),
                               balances=balances0, device=device)
    if ema is not None:
        model_keys = set(state.ema)
        if set(ema) != model_keys:
            raise KeyError(f"the EMA's names differ from the model's: "
                           f"{sorted(set(ema) ^ model_keys)[:8]}")
        for k, v in ema.items():
            state.ema[k].copy_(v)
    state.step = step
    ckpt_dir = Path(args.out) / "checkpoints"
    save_checkpoint(ckpt_dir, state, max(step, 1), hyp=hyp)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {args.pth} -> {ckpt_dir} (step {max(step, 1)}, {n_params:,} params, "
          f"ema={'yes' if ema is not None else 'copy'})")
    return ckpt_dir


if __name__ == "__main__":
    main()

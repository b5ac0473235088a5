"""Train a detector with the port.

    python -m yoloseries_tpu_torch.cli.train --model yolov5s \
        --cfg yoloseries_tpu_torch/configs/presets/train_yolov5.yaml \
        --train-img-dir ... --train-lab-dir ... [--val-img-dir ... --val-lab-dir ...] \
        [--device cpu]

The arguments of the JAX package's ``cli/train.py``, plus ``--device``
(default ``cuda``: no card is an error unless ``--device cpu``). The class
count comes from ``--name-path``, else from the train set's labels.
Checkpoints go to ``<output-dir>/checkpoints/<step>/state.pt``; ``cli/val.py``
and ``cli/detect.py --ckpt-dir`` read them. ``--bf16`` computes in bfloat16
(parameters stay f32); ``--set remat=true`` recomputes each CSP block in the
backward; ``--set s2d_stem=true`` trains the space-to-depth stem (then pass
the same hyp to ``val`` and ``--s2d-stem`` to ``detect``).
"""

from __future__ import annotations

import argparse

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default=None, help="YAML config (reference format)")
    p.add_argument("--model", default="yolov5s")
    p.add_argument("--train-img-dir", required=True)
    p.add_argument("--train-lab-dir", required=True)
    p.add_argument("--val-img-dir", default=None)
    p.add_argument("--val-lab-dir", default=None)
    p.add_argument("--name-path", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--total-epoch", type=int, default=None)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--output-dir", default="runs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any flattened hyp key (YAML-typed), e.g. "
                        "--set data_aug_mixup_p=0.5")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..configs import TrainConfig, load_hyp
    from ..data.dataset import DetectionDataset, load_names
    from ..device import resolve_device
    from ..train import Trainer

    device = resolve_device(args.device)
    hyp = load_hyp(args.cfg) if args.cfg else {}
    if args.batch_size:
        hyp["batch_size"] = args.batch_size
    if args.total_epoch:
        hyp["total_epoch"] = args.total_epoch
    if args.input_size:
        hyp["input_img_size"] = [args.input_size, args.input_size]
    for kv in args.set:
        import yaml

        key, _, value = kv.partition("=")
        hyp[key.strip()] = yaml.safe_load(value)

    if args.name_path:
        num_class = max(load_names(args.name_path)) + 1
    else:
        num_class = DetectionDataset(args.train_img_dir, args.train_lab_dir).num_class
    cfg = TrainConfig.from_hyp(hyp, num_class=num_class, model=args.model,
                               output_dir=args.output_dir)
    trainer = Trainer(
        cfg, (args.train_img_dir, args.train_lab_dir),
        val_dirs=(args.val_img_dir, args.val_lab_dir) if args.val_img_dir else None,
        names_path=args.name_path,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device,
    )
    if args.resume:
        trainer.load()
    eval_fn = (lambda tr: tr.evaluate()) if trainer.val_dataset is not None else None
    try:
        trainer.train(eval_fn=eval_fn)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()

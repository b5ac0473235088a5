"""The ``Trainer``'s update body, with augmentation closed or rendered on
the card.

Set-up writes a training set drawn from the seed under the run's temporary
directory (``core/data.py``), builds the port's ``Trainer`` as
``cli/train.py`` does (``TrainConfig.from_hyp`` over the traffic file's
``hyp``, the loader's seed the run's seed, the image cache on) and loads the
seeded weights. With ``"augmentation": "closed"`` it closes augmentation
(``DataLoader.close_data_aug``) and drops the batches made before the close
took effect (``skip_batches``); with ``"device"`` the loader's workers plan
every sample and ``_device_batch`` renders the plans on the card from the
image cache there. Each update is the body of ``Trainer.train``:
``next(train_loader)``, ``_device_batch`` (the pinned H2D copy, and the
render), then the step of the input size. Set-up drives the first
``checked_updates`` through that same call; the window then runs updates
for ``--seconds`` and ends on a device sync.

Output check, once the window has closed and the program is freed
(``reference/train.py``): the batches of the checked updates worked out
again (``data_mismatch``: differing bytes and label entries, exact): from
the image files, or rendered from the plans the loader handed over
(``reference/render.py``) against an image cache made again from the
files; and the reference's updates on them from the same weights: each
update's loss (``loss_gap``, relative), the first update's gradient as the
optimizer took it, read from its momentum trace (``grad_gap``), the
parameters' change over the checked updates (``change_gap``) and the EMA's
change over them, running statistics included (``ema_gap``), by the worst
leaf of their norms (``reference/train.py::leaf_gap``). Parameters whose
first reference gradient is under a thousandth of the median leaf's are
left out of the change and of the EMA.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core import data, roofline, weights
from ..reference import render
from ..reference import train as rtrain

CLIP_GRAD_NORM = 10.0  # the recipe's global-norm clip (optax's clip_by_global_norm)
TINY_GRAD = 1e-3  # leaves under this share of the median first gradient: out of the change
NUMBERS = ("data_mismatch", "loss_gap", "grad_gap", "change_gap", "ema_gap")


def workdir(cell_name: str) -> Path:
    """A fixed directory of the cell under the run's temporary directory."""
    return Path(tempfile.gettempdir()) / "port_bench" / cell_name


def build_program(cfg, t, seed, root, device):
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = data.synthetic_set(root / "data", t["images"], seed,
                                                 t["image_size"])
    tcfg = TrainConfig.from_hyp(dict(t["hyp"], random_seed=seed), num_class=cfg["nc"],
                                model=cfg["program_model"], output_dir=str(root / "out"))
    trainer = Trainer(tcfg, (str(img_dir), str(lab_dir)), names_path=str(names),
                      device=device, log_fn=lambda *a: None)
    return trainer, img_dir, lab_dir


def optimizer_settings(t):
    hyp = t["hyp"]
    spe = max(t["images"] // hyp["accumulate_loss_step"], 1)
    return {"basic_lr_per_img": hyp["basic_lr_per_img"], "batch_size": hyp["batch_size"],
            "weight_decay": hyp["weight_decay"], "momentum": hyp["momentum"],
            "scheduler_type": hyp["scheduler_type"], "lr_max_ds_scale": hyp["lr_max_ds_scale"],
            "total_epochs": hyp["total_epoch"], "steps_per_epoch": spe,
            "warmup_steps": max(hyp["warmup_epoch"] * spe, 1000),
            "warmup_bias_max_lr": hyp["warmup_bias_max_lr"],
            "warmup_momentum": hyp["warmup_momentum"], "clip_grad_norm": CLIP_GRAD_NORM}


def reference(sd, cfg, t, seed, img_dir, lab_dir, device, tf32=False, half=False, plans=None):
    """The reference's checked updates from ``sd``: {"batches": host (images,
    ann) per update, "losses", "grad": first update's trace by leaf,
    "change": parameter change by leaf, "ema": the EMA's change by floating
    entry}. ``plans``: the loader's plan batches of the checked updates,
    rendered instead of reading the files; ``tf32``: the control's
    precision; ``half``: each micro-batch's second half left out (a
    fault)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False
    try:
        hyp, size = t["hyp"], t["image_size"]
        acc = hyp["accumulate_loss_step"] // hyp["batch_size"]
        params = {k: v.clone() for k, v in sd.items() if k in _param_keys(sd)}
        bufs = {k: v.clone() for k, v in sd.items() if k not in params}
        ema = {k: v.clone() for k, v in sd.items()}
        opt = rtrain.SGD(params, optimizer_settings(t))
        loss_fn, balances = rtrain.family_loss(cfg, hyp, size, device)
        cache = render.cache_from_files(img_dir, size, device) if plans else None
        keep = slice(0, hyp["batch_size"] // 2) if half else None
        out = {"batches": [], "losses": []}
        for i in range(t["checked_updates"]):
            if plans:
                fill = hyp["data_aug_fill_value"]
                plan = {k: torch.from_numpy(v).to(device) for k, v in plans[i]["plan"].items()}
                imgs = render.render(cache, plan, plans[i]["dst_hw"], (size, size), fill,
                                     fill).cpu().numpy()
                ann = plans[i]["ann"]
            else:
                imgs, ann = rtrain.batch(img_dir, lab_dir, seed, t["skip_batches"] + i, size,
                                         hyp["accumulate_loss_step"], 300)
            out["batches"].append((imgs, ann))
            loss, balances = rtrain.update(bufs, params, opt, cfg, loss_fn,
                                           torch.from_numpy(imgs).to(device),
                                           torch.from_numpy(ann).to(device), balances, acc, keep)
            rtrain.ema_step(ema, {**bufs, **params}, i + 1)
            out["losses"].append(loss)
            if i == 0:
                out["grad"] = {k: v.clone() for k, v in opt.trace.items()}
        out["change"] = {k: params[k] - sd[k] for k in params}
        out["ema"] = {k: v - sd[k] for k, v in ema.items() if v.is_floating_point()}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


def plan_copy(host):
    """The plan fields, targets and output size of a loader's plan batch."""
    return {"plan": {k: np.array(v) for k, v in host["plan"].items()},
            "ann": np.array(host["ann"]), "dst_hw": tuple(host["dst_hw"])}


def _param_keys(sd):
    return {k for k in sd if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def numbers(got, want):
    """The compared numbers of ``got`` (the program's readings, or a control's
    reference run) against the reference's ``want``."""
    mism = 0
    for (gi, ga), (wi, wa) in zip(got["batches"], want["batches"]):
        mism += int(np.count_nonzero(np.asarray(gi) != wi)) + int(
            np.count_nonzero(np.asarray(ga) != wa))
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    g_norm = {k: float(v.norm()) for k, v in want["grad"].items()}
    med = float(np.median(list(g_norm.values())))
    moving = [k for k, n in g_norm.items() if n >= TINY_GRAD * med]
    grad_gap, grad_leaf = rtrain.leaf_gap(got["grad"], want["grad"])
    change_gap, change_leaf = rtrain.leaf_gap(got["change"], want["change"], moving)
    ema_keys = [k for k in want["ema"] if k not in g_norm or k in moving]
    ema_gap, ema_leaf = rtrain.leaf_gap(got["ema"], want["ema"], ema_keys)
    return {"data_mismatch": float(mism), "loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "ema_gap": ema_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf, "ema_leaf": ema_leaf,
            "left_out": len(g_norm) - len(moving)}


def run(cell, cfg, t, seed, seconds, trace, device, t0, log, limits):
    from yoloseries_tpu_torch.device import set_numeric_mode

    set_numeric_mode()
    dev = torch.device(device)
    root = workdir(cell["name"])
    marks = [("imports", time.perf_counter())]
    try:
        trainer, img_dir, lab_dir = build_program(cfg, t, seed, root, dev)
        marks.append(("data and Trainer", time.perf_counter()))
        try:
            sd = weights.seeded_state(cfg, seed, dev, t["image_size"])
            marks.append(("weights", time.perf_counter()))
            got, out = _measure(trainer, sd, t, seconds, trace, dev, t0, log, marks)
        finally:
            trainer.close()
        trainer = None  # the program's state is freed before the reference runs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        want = reference(sd, cfg, t, seed, img_dir, lab_dir, dev, plans=got.get("plans"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nums = numbers(got, want)
    log(f"check: {t['checked_updates']} updates against the reference, "
        f"{time.perf_counter() - t_ref:.3f} s; losses {got['losses']} vs {want['losses']}; "
        f"worst leaves: gradient {nums['grad_leaf']}, change {nums['change_leaf']}, "
        f"EMA {nums['ema_leaf']}; "
        f"{nums['left_out']} leaves out of the change")
    out["checks"] = [(k, nums[k], limits.get(k)) for k in NUMBERS]
    out["correct"] = all(lim is not None and np.isfinite(v) and v <= lim
                         for _, v, lim in out["checks"])
    out["ctx"]["cfg"] = cfg
    return out


def _measure(trainer, sd, t, seconds, trace, dev, t0, log, marks):
    """Set-up's checked updates and the window. Returns (the program's
    readings of the checked updates, the result without its check)."""
    from ..core.trace import profile_calls

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = trainer.state.model
    model.load_state_dict(sd, strict=True)
    trainer.state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loader = trainer.train_loader
    if t["augmentation"] == "closed":
        loader.close_data_aug()
        for _ in range(t["skip_batches"]):  # made before the close took effect
            next(loader)
        marks.append(("augmented batches dropped", time.perf_counter()))
    step = trainer._step_fn_for(tuple(trainer.cfg.input_size))
    waits, render_ms = [], []

    def update():
        t1 = time.perf_counter()
        host = next(loader)
        waits.append(time.perf_counter() - t1)
        if "plan" in host:
            render_ms.append(roofline.render_bound_ms(host))
        batch = trainer._device_batch(host)
        trainer.state, metrics = step(trainer.state, batch)
        return host, batch, metrics

    names = {id(p): n for n, p in model.named_parameters()}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = {"batches": [], "losses": []}
    for i in range(t["checked_updates"]):
        host, batch, metrics = update()
        got["batches"].append((batch["img"].cpu().numpy(), batch["ann"].cpu().numpy()))
        if "plan" in host:
            got.setdefault("plans", []).append(plan_copy(host))
        got["losses"].append(float(metrics["tot_loss"]))
        if i == 0:
            opt = trainer.state.optimizer
            got["grad"] = {names[id(p)]: tr.clone() for g in opt.groups
                           for p, tr in zip(opt.groups[g], opt.state[g]["trace"])}
    got["change"] = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
    got["ema"] = {k: v - sd[k] for k, v in trainer.state.ema.items() if v.is_floating_point()}
    del host, batch, metrics
    sync()
    gc.collect()
    gc.freeze()  # set-up's objects are not scanned again in the window
    waits.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    setup_s = start - t0
    marks.append(("checked updates", start))
    log(f"setup: imports {marks[0][1] - t0:.3f} s, " + ", ".join(
        f"{name} {t2 - t1:.3f} s" for (_, t1), (name, t2) in zip(marks, marks[1:])))
    n = 0
    while True:
        update()
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    b = t["hyp"]["accumulate_loss_step"]
    wait_ms = 1e3 * sum(waits) / len(waits)
    log(f"window: {n} updates of {b} images in {window_s:.3f} s ({window_s / n * 1e3:.1f} ms "
        f"an update), loader wait {wait_ms:.3f} ms an update; setup {setup_s:.3f} s; "
        f"peak {peak} bytes")
    summary, traced = None, []
    if trace:
        def traced_update():
            update()

        summary, traced = profile_calls(traced_update, t["trace_calls"], log)
    e2e = {"train_img_per_s": (n * b / window_s, "img/s"),
           "peak_mem_gib": (peak / 2**30, "GiB"),
           "setup_s": (setup_s, "s")}
    ctx = {"traffic": t, "img_per_s": n * b / window_s, "summary": summary,
           "loader_wait_ms": wait_ms,
           "render_bound_ms": render_ms[len(render_ms) - len(traced):] if traced else []}
    return got, {"e2e": e2e, "ctx": ctx, "attempted": n * b, "failed": 0, "peak_bytes": peak}

"""Drive the PyTorch port on one NVIDIA GPU: YOLOv5s serving and training,
the YOLOv5 knobs, the anchor-free YOLOX and YOLOv8 families, and YOLOv7,
RetinaNet and FCOS.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card (nvidia-smi), nvcc;
2. build: every kernel of ``yoloseries_tpu_torch/csrc`` with nvcc for
   sm_90a, timed, with the ``-Xptxas -v`` register and shared-memory use
   and B1's dynamic shared memory by K (the kernel's formula; phase 3
   launches it at K=8192, the most a block may hold);
3. kernels vs their plain PyTorch twins on the card, index for index
   (exact ties, zero-area boxes, all-dead rows and images, class offset,
   sorted and shuffled input; B1 at the path's shapes, at K=8192 and with
   max_keep cut inside a tile; B3 where the carry fills early, inside a
   strip, and at K not a multiple of 1024), the relation words bit for bit,
   with ``torch.cuda.synchronize()`` after each launch;
4. model: yolov5s at nc=80 from a seeded generator (7,235,389 parameters),
   640x640 B=1 f32 on the card against the same module on the CPU;
5. serving: the port ``Evaluator`` on seeded uint8 batches (serving config
   at B=8 and B=256, serving TTA at B=2, whose three sorted branches reach
   B1 unsorted, protocol config at B=64, protocol TTA at B=2) and
   ``detect_batch`` once; each path's kernel launch counter is zeroed
   before the path and must have grown after it; img/s and peak memory;
6. kernel timings (CUDA events, and the device time per call from
   torch.profiler beside them) at the candidates the serving path produced
   (B2 also at a TTA strip's own inputs), beside the plain twins, the
   bytes/operations bound (the IoUs these inputs need) and the
   dependent-chain bound (steps these inputs need x the measured time of
   one dependent step, ``csrc/step_probe.cu``: a decision in one warp's
   registers for B1, block-wide for B2 and B3), B1's own block-wide steps
   (the tiles its scan walks, a diagnostic); the run fails where B1's
   device time is under the larger of its bound and its chain; the strips
   of the TTA batch that did work; B1 and B2 side by side over B in
   {1, 8, 16, 32, 64} x K in {512, 1024};
7. a torch.profiler breakdown of one serving, one protocol and one TTA
   batch: device-busy and idle share, the heaviest kernels, the NMS
   kernels' share;
8. training: the port's ``Trainer`` on a seeded synthetic folder set of PNGs
   (written here, PIL; labels as txt), YOLOv5s nc=80 at 640, f32, the
   preset's batch 64 x accumulate 2 (128 images an update), augmentation
   closed, warmup active: 8 updates, then ``evaluate()`` over 2 val batches
   of 64 at the protocol config, whose NMS is B1 (``nms_greedy``, K=4096).
   The launch counters are zeroed before ``train()`` and read after
   ``evaluate()``; B1 is held index for index against its twin at the val
   pass's own candidates and timed there. Prints ms per update (CUDA events
   between update ends, the median after the first two), img/s, peak
   memory, every update's loss dict, mAP and mAP50, and the phase's wall
   time; fails on a loss that is not finite. Then one update of YOLOv5s at
   256 px (B=4, accumulate 2, warmup active) on the card and on the CPU
   from the same weights and batch (tot_loss within 1e-3 relative, every
   parameter within 1e-3 * max(1, |p|)), and a profiler split of one
   training update (convolution forward and backward, BN, the loss and its
   winner step, the optimizer, the EMA, the H2D copy). The loaders here run
   the loader's default, worker processes; the loader alone is also timed
   with threads (the batches must be byte-identical), and one thread's time
   per sample in ``get`` and in the collate;
9. the recipe: the host's core count, then a sha256 of one augmented batch
   (8 synthetic PNGs at 640 px, the preset's augmentation, the image cache,
   seed 5; ``tests/test_torch_port_augment.py`` makes the same batch with
   the JAX package, so the two cv2 builds can be compared by hand); the
   ``Trainer`` on 128 more synthetic PNGs with the preset's augmentation and
   the image cache (cached canvases), worker processes, 4 one-update epochs
   of B=64 x 2, the last 2 closed (the close saves a checkpoint); the
   augmented loader alone with threads and with processes (ms per batch of
   128; the batches must be byte-identical); ``cli/val.py`` on the
   checkpoint the run wrote (B=16, K=4096: B1, held index for index against
   its twin at its candidates, and timed there); ``cli/detect.py
   --ckpt-dir`` on 6 images (B=8, K=4096: B1, held against its twin). The launch
   counters are zeroed before ``val`` and before ``detect`` and read after;
10. augmentation rendered on the card (``data/device_aug.py``): the digest
   batch of phase 9 as plans (cache plans over the image cache, pixel plans
   over the files) rendered on the card and on the CPU (at most 1 LSB on
   0.1% of the bytes, expected 0), the cache plans' sha256
   (``tests/test_torch_port_device_aug.py`` pins the CPU's), the pixel
   plans' targets against the host pipeline's (exactly) and their pixels
   against the card host's cv2 (at most 5% of bytes off by more than 2,
   mean under 1);
   then the ``Trainer`` with ``device_aug`` and ``device_cache`` on phase
   9's train set, 4 one-update epochs, printed beside phase 9's loop, and
   ``evaluate()`` after them (B1 at K=4096, held against its twin; the
   launch counters zeroed before ``train()``); the planning loader alone
   (cache plans with processes and threads, byte-identical; pixel plans
   with processes); for a batch of 128 of each kind the H2D bytes and ms,
   the render's ms (CUDA events), peak memory and bound in bytes,
   ``repack_tiles`` alone; the host syncs of one update from a plan batch
   (copy, render, step: must be 0) and its profiler split, the render's
   share included;
11. the YOLOv5 knobs (the launch counters zeroed before each path and read
   after it; every NMS call on these paths held against its plain twin):
   all nine specs at 640, nc=80 (seeded, detect convs widened as in phase
   4), raw maps card vs CPU at B=1, the protocol NMS of two images (B1)
   against its twin and protocol img/s at B=64 (B1), the first call's time
   apart; yolov5s folded (``nn/deploy.py``) against
   unfused in turns (serving B=256 and B=8, protocol B=64; raw maps,
   detections matched, a profiler split of serving B=256 each); the s2d
   stem with ``fold_stem_to_s2d`` weights against the 6x6 stem; bf16
   serving B=256 against f32 (share of f32 detections matched); soft-NMS
   (linear, exp) at serving B=8 and protocol B=64, card against CPU on the
   same candidates, and its ms; WBF at serving TTA B=2, card against CPU,
   split into the branches on the card and the fusion on the host; the
   ``Trainer`` (phase 8's set and batch) with ``remat``, ``s2d_stem`` and
   bf16 beside f32, 3 updates each on the default kernels: ms per update,
   peak memory, host syncs (must be 0), remat's peak (must be lower); then,
   untimed, on deterministic kernels (cuDNN's, and torch's deterministic
   mode, which raises where an op has none), f32, a second f32 run (the
   control) and remat: remat's first update and its losses against f32's
   (``TRAIN_TOL``), its parameters after all updates against the
   control's drift;
   ``cli/detect.py`` on phase 9's checkpoint folded (the default),
   ``--no-fuse`` and ``--bf16``, with the checkpoint's bf16 map error in
   ulps and the share of f32 detections whose object bf16 finds;
12. the anchor-free families (YOLOX with SimOTA, YOLOv8 with TAL and DFL;
   the launch counters zeroed before each path and read after it; every NMS
   call on these paths held against its plain twin): all nine new names
   (yolox_s/m/l, yolox_darknet21/53, yolov8, yolov8n/s/m) at 640, nc=80,
   seeded, their output convs widened as phase 4 widens YOLOv5's (random
   weights put every score at the prior), raw maps card vs CPU at B=1, the
   protocol NMS of two images (B1) against its twin and protocol img/s at
   B=64 (B1), the first call apart; yolox_s and yolov8
   through the ``Evaluator`` with their family's decode and selection at
   serving B=256 (B1) and B=8 (B2), protocol B=64 (B1) and protocol TTA B=2
   (B3; for YOLOv8 each branch's boxes held to its maps' own grid), img/s
   and each kernel's times at the path's candidates; each family's
   ``Trainer`` with its preset (``configs/presets/train_yolo{x,v8}.yaml``,
   TTA off in ``evaluate()``) on a synthetic set at the preset's batch
   (YOLOX 4 x 2, YOLOv8 2 x 2), warmup active, 6 updates: ms per update,
   peak memory, host syncs (must be 0), finite losses, then ``evaluate()``
   over 2 val batches of 64 (B1, timed there); the step alone at 128 images
   an update (phase 8's B=64 x 2 for YOLOX; 32 x 4 for YOLOv8, whose
   micro-batch of 64 needs ~76 of the card's 79 GiB) with its ms, peak,
   syncs and profiler split (model forward, the loss and of it the
   assigner, the backward, the optimizer, the EMA);
   ``cli/val.py`` (B1) and ``cli/detect.py --ckpt-dir`` folded and
   ``--no-fuse`` (matched at 0.1 px) on the checkpoint the training wrote;
   one update at 256 px card vs CPU (``TRAIN_TOL``) per family;
13. the last families (YOLOv7 with its OTA refinement, RetinaNet and its
   objectness experiment, FCOS on its GroupNorm ResNet and on the CSP
   trunk; the launch counters zeroed before each path and read after it;
   every NMS call against its plain twin): the five names at 640, nc=80,
   seeded, output convs widened (forward hooks read each conv's raw
   output; RetinaNet's classification tower biases to 0, its focal prior
   kills the tower's ReLUs), with cuDNN's heuristics in place of its
   autotuning (for time), raw maps card vs CPU at B=1 (the largest
   difference over the map's scale) and protocol img/s at B=64, the first
   call apart; yolov7 folded (conv+BN, then RepConv's deploy form) against
   unfolded; yolov7, retinanet and fcos through the ``Evaluator`` with their
   family's eval overrides (the v7 gate, RetinaNet's written-back merge,
   FCOS's sqrt scores) at serving B=256 (B1) and B=8 (B2), protocol B=64
   (B1) and protocol TTA B=2 (B3), each kernel timed at the path's
   candidates; each family's ``Trainer`` with its preset (3 one-update
   epochs at the preset's batch: 4 x 2, 48 x 1, 64 x 1), 0 host syncs,
   ``evaluate()`` over 2 val batches of 64 (B1); the step alone at 128
   images an update (32 x 4) with its profiler split and the assigner's
   share; ``cli/val.py`` and ``cli/detect.py`` folded/``--no-fuse`` on the
   checkpoint; one update at 256 px card vs CPU (RetinaNet with its
   preset's IoU loss); its rows on a ``{"last_families": ...}`` line;
then one ``{"kernels": [...]}`` line, with a summary per kernel of phase
13's rows.

The last lines are the card's ``nvidia-smi`` name and power limit and then
``{"ok": true, "device": {...}}``. TF32 is off throughout (cuDNN and
matmul), so every comparison and time is full f32 but phase 11's bf16.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# cuBLAS's deterministic workspace, which torch's deterministic mode asks
# for (phase 11's drift check); read once, before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

MAX_KEEP = 300
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
IOU_OPS = 14  # min/max/sub/clamp/mul/add/div/compare per IoU evaluation
MODEL_TOL = 1e-3  # f32 raw maps, card vs CPU: summation order over ~60 convs
TRAIN_TOL = 1e-3  # one f32 update, card vs CPU: the same summation orders, then SGD
CUT_IN_TILE = "max_keep cut inside a tile"  # phase-3 cases of B1
ALL_DEAD = "an all-dead image"
WATCHDOG_S = 1100  # the whole script's limit is 1200 s


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def hang():
    """A hang ends the script inside its time limit: every thread's stack,
    then the worker processes it started (they hold its output open), then
    exit 1."""
    import multiprocessing
    import os

    log(f"FAILED: no end after {WATCHDOG_S} s")
    faulthandler.dump_traceback(all_threads=True)
    for child in multiprocessing.active_children():
        child.kill()
    os._exit(1)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# --------------------------------------------------------------- inputs

def candidates(seed, b, k, n_cls=8, shuffle=False, dead=False):
    """Clustered candidate boxes with the class offset already added, exact
    score ties, zero-area boxes, dead tails and (for b > 1) an all-dead row;
    every row dead with ``dead``."""
    rng = np.random.default_rng(seed)
    hot = rng.uniform(0, 600, (b, 32, 2))
    xy = hot[np.arange(b)[:, None], rng.integers(0, 32, (b, k))] + rng.normal(0, 15, (b, k, 2))
    wh = rng.uniform(5, 90, (b, k, 2))
    wh[:, ::37] = 0.0
    cls = rng.integers(0, n_cls, (b, k)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes = boxes + (cls * np.float32(4096.0))[..., None]
    scores = np.sort(rng.uniform(0.01, 1, (b, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[:, 5:9] = scores[:, 5:6]
    for r in range(b):
        scores[r, rng.integers(k // 4, k + 1):] = 0.0
    if b > 1:
        scores[-1] = 0.0
    if dead:
        scores[:] = 0.0
    if shuffle:
        order = rng.permutation(k)
        boxes, scores = boxes[:, order], scores[:, order]
    dev = torch.device("cuda")
    return (torch.from_numpy(np.ascontiguousarray(boxes)).to(dev),
            torch.from_numpy(np.ascontiguousarray(scores)).to(dev))


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phases

def phase_environment():
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    from yoloseries_tpu_torch.kernels._build import _nvcc

    log(run([_nvcc(), "--version"]).splitlines()[-1])
    return smi.splitlines()[0]


def phase_build():
    from yoloseries_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {_build.BUILD_DIR}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.strip().removeprefix("ptxas info    : "))
    log("  nms_greedy dynamic shared memory by K (bytes; a block may hold 232448): "
        + ", ".join(f"{k}: {greedy_smem(k)}" for k in (512, 1536, 4096, 8192)))


def greedy_smem(k):
    """B1's dynamic shared memory at K (``csrc/nms_greedy.cu::greedy_smem``;
    ``ptxas -v`` counts static shared memory only): sort keys over K padded
    to a power of two, five planes, the live words and the tile's rows."""
    return 8 * max(32, 1 << (k - 1).bit_length()) + 4 * 5 * k + 4 * (-(-k // 32) + 34)


def phase_kernels_vs_twins():
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    mismatches = {"nms_relation": 0}
    for i, (b, k, thr, shuffle) in enumerate([(8, 512, 0.45, False), (2, 1024, 0.65, True),
                                              (16, 1024, 0.45, True), (3, 200, 0.5, True)]):
        boxes, scores = candidates(500 * i + k, b, k, shuffle=shuffle)
        want = m.nms_relation_plain(boxes, scores, thr)
        torch.cuda.synchronize()
        got = m.nms_relation(boxes, scores, thr)
        torch.cuda.synchronize()
        n = int((got != want).sum())  # differing words, bit for bit
        mismatches["nms_relation"] += n
        log(f"  nms_relation B={b} K={k} thr={thr} shuffled={shuffle}: "
            f"{int((want != 0).sum())} nonzero words, {n} mismatches")

    greedy = (g.nms_greedy, g.greedy_nms)
    chunked = (m.matrix_nms_chunked, m.matrix_nms_chunked_plain)
    cases = {  # name -> [(kernel, twin, B, K, thr, shuffled, max_keep, what)]
        "nms_greedy": [
            (*greedy, 256, 512, 0.45, False, MAX_KEEP, "the serving B=256 shape"),
            (*greedy, 64, 4096, 0.65, False, MAX_KEEP, "the protocol B=64 shape"),
            (*greedy, 2, 1536, 0.45, True, MAX_KEEP, "the serving-TTA shape"),
            (*greedy, 2, 8192, 0.65, False, MAX_KEEP, "the largest K"),
            (*greedy, 2, 8192, 0.65, True, MAX_KEEP, "the largest K"),
            (*greedy, 8, 4096, 0.65, True, MAX_KEEP, ""),
            (*greedy, 3, 1000, 0.5, True, MAX_KEEP, ""),
            (*greedy, 4, 512, 0.45, False, 20, CUT_IN_TILE),
            (*greedy, 1, 512, 0.45, False, MAX_KEEP, ALL_DEAD),
        ],
        "matrix_nms": [(m.matrix_nms, m.matrix_nms_plain, b, k, 0.45, shuffle, MAX_KEEP, "")
                       for b in (1, 8, 16) for k in (512, 1024) for shuffle in (False, True)],
        "matrix_nms_chunked": [
            (m.matrix_nms_chunked, g.greedy_nms, 2, 12288, 0.65, True, MAX_KEEP,
             "against greedy; image 1 all dead"),
            (*chunked, 2, 12288, 0.65, True, MAX_KEEP, "image 1 all dead"),
            (*chunked, 2, 4096, 0.65, True, 20, "carry fills in strip 0"),
            (*chunked, 3, 9000, 0.65, True, MAX_KEEP, "K not a multiple of 1024"),
            (*chunked, 2, 12288, 0.45, False, 100, "carry fills inside a strip"),
        ],
    }
    for name, shapes in cases.items():
        bad = 0
        for i, (kernel, twin, b, k, thr, shuffle, keep, what) in enumerate(shapes):
            boxes, scores = candidates(1000 * i + k, b, k, shuffle=shuffle,
                                       dead=what == ALL_DEAD)
            if what == CUT_IN_TILE and not cut_inside_tile(boxes, scores, thr, keep):
                fail(f"{name} B={b} K={k}: max_keep={keep} does not fall inside a tile")
            want = twin(boxes, scores, thr, keep)
            torch.cuda.synchronize()
            got = kernel(boxes, scores, thr, keep)
            torch.cuda.synchronize()
            n = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            bad += n
            log(f"  {name} B={b} K={k} thr={thr} shuffled={shuffle} max_keep={keep}"
                f"{' (' + what + ')' if what else ''}: {int(want[1].sum())} keepers, "
                f"{n} mismatches")
        mismatches[name] = bad
    if any(mismatches.values()):
        fail(f"kernel/twin mismatches {mismatches}")
    return mismatches


def keeper_ranks(scores, keep_idx, keep_valid):
    """(B, max_keep) each keeper's position in B1's priority order (score
    descending, ties to the lower index, the live candidates first); -1 in
    empty slots."""
    from yoloseries_tpu_torch.kernels.nms_greedy import priority_order

    rank = torch.argsort(priority_order(scores), dim=1)
    ranks = torch.take_along_dim(rank, keep_idx.clamp_min(0).long(), dim=1)
    return torch.where(keep_valid, ranks, -1)


def keeper_tiles(scores, keep_idx, keep_valid):
    """(B, max_keep) the 32-wide tile of the priority order that holds each
    keeper; -1 in empty slots."""
    return keeper_ranks(scores, keep_idx, keep_valid) // 32


def cut_inside_tile(boxes, scores, thr, keep):
    """Does greedy's keeper number ``keep`` (0-based) share its tile with
    the keeper before it in some image, so that a cut at ``keep`` keepers
    stops inside a tile?"""
    from yoloseries_tpu_torch.kernels.nms_greedy import greedy_nms

    tiles = keeper_tiles(scores, *greedy_nms(boxes, scores, thr, keep + 1))
    return bool(((tiles[:, keep] >= 0) & (tiles[:, keep] == tiles[:, keep - 1])).any())


def design_steps(scores, keep_idx, keep_valid):
    """B1's block-wide steps on these inputs: the tiles its scan walks in
    the longest image, the live prefix of the priority order up to the tile
    of the max_keep-th keeper. A diagnostic of the design, not a bound."""
    full = keep_valid.all(dim=1)
    last = keeper_tiles(scores, keep_idx, keep_valid)[:, -1] + 1
    live = -(-(scores > 0).sum(dim=1) // 32)
    return int(torch.where(full, last, live).max())


def greedy_ious(scores, keep_idx, keep_valid):
    """IoUs exact greedy cannot avoid on these inputs, summed over the
    images: each keeper against every keeper before it (none of them may
    suppress it), and one for each live candidate that an earlier keeper
    suppresses (one IoU >= thr settles it), over the priority order up to
    the max_keep-th keeper (nothing after it is looked at)."""
    n = keep_valid.sum(dim=1)
    last = keeper_ranks(scores, keep_idx, keep_valid)[:, -1] + 1
    seen = torch.where(keep_valid.all(dim=1), last, (scores > 0).sum(dim=1))
    return int((n * (n - 1) // 2 + seen - n).sum())


def widen_head(model, img):
    """Random weights put every score near the detect prior; scale each
    detect conv (bias 0) so its raw map has std 1.5 on ``img``, which
    spreads scores and classes the way a trained head does."""
    with torch.no_grad():
        names = ("detect_small", "detect_mid", "detect_large")
        for name in names:
            getattr(model.detect, name).bias.zero_()
        for name, raw in zip(names, model(img)):
            getattr(model.detect, name).weight.mul_(1.5 / raw.std())


def phase_model():
    from yoloseries_tpu_torch.models import create_model

    model = create_model("yolov5s", num_class=80, device="cpu", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 7_235_389:
        fail(f"yolov5s has {n_params} parameters, want 7,235,389")
    gen = torch.Generator().manual_seed(0)
    calib = torch.randint(0, 256, (2, 3, 320, 320), generator=gen).float() / 255
    widen_head(model, calib)
    x = torch.randint(0, 256, (1, 3, 640, 640), generator=gen).float() / 255
    with torch.no_grad():
        ref = model(x)
        gpu = create_model("yolov5s", num_class=80, device="cpu", seed=0)
        gpu.load_state_dict(model.state_dict())
        gpu = gpu.cuda()
        got = gpu(x.cuda())
        torch.cuda.synchronize()
    err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
    log(f"model: yolov5s {n_params} params; 640x640 B=1 f32 card vs CPU "
        f"max abs diff {err:.3e} (tolerance {MODEL_TOL})")
    if not err <= MODEL_TOL:
        fail("card and CPU raw maps disagree")
    return model


@contextlib.contextmanager
def record_nms_inputs():
    """Record (boxes with class offset, scores, thr) of every NMS wrapper
    call that ``nms_candidates`` makes, by kernel name."""
    from yoloseries_tpu_torch.ops import nms

    rec = {"nms_greedy": [], "matrix_nms": [], "matrix_nms_chunked": []}
    saved = {name: getattr(nms, name) for name in rec}

    def recorder(name):
        def call(boxes, scores, thr, max_keep):
            rec[name].append((boxes.clone(), scores.clone(), thr))
            return saved[name](boxes, scores, thr, max_keep)
        return call

    for name in rec:
        setattr(nms, name, recorder(name))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(nms, name, fn)


def check_detections(out, b):
    if tuple(out.shape) != (b, MAX_KEEP, 6):
        fail(f"detections shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail("non-finite detections")
    conf = out[..., 4]
    if not ((conf >= 0) & (conf <= 1)).all() or not (conf > 0).any():
        fail("detections: conf outside [0, 1] or no detection at all")


def matched_share(got, ref, conf_tol=1e-4, box_tol=1e-2):
    """Share of the reference detections found in ``got`` (same image and
    class, conf within ``conf_tol``, box within ``box_tol`` px), and their
    count. Either side: a (B, K, 6) array or tensor, or per-image (n, 6)
    arrays, lists or None (the WBF and ``detect`` outputs)."""
    found = total = 0
    for g, r in zip(to_rows(got), to_rows(ref)):
        g, r = g[g[:, 4] > 0], r[r[:, 4] > 0]
        free = np.ones(len(g), bool)
        for row in r:
            total += 1
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= conf_tol)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= box_tol))
            if close.any():
                found += 1
                free[np.argmax(close)] = False
    return found / max(total, 1), total


def to_rows(dets):
    if torch.is_tensor(dets):
        dets = dets.detach().cpu().numpy()
    return [np.zeros((0, 6), np.float32) if d is None else np.asarray(d, np.float32).reshape(-1, 6)
            for d in dets]


def phase_serving(model, card):
    from yoloseries_tpu_torch.cli.detect import detect_batch
    from yoloseries_tpu_torch.evaluation import (
        EvalConfig,
        Evaluator,
        yolov5_decode_fn,
        yolov5_select_fn,
    )
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m
    from yoloseries_tpu_torch.ops.letterbox import letterbox_image

    counters = {"nms_greedy": g.nms_greedy, "matrix_nms": m.matrix_nms,
                "matrix_nms_chunked": m.matrix_nms_chunked}
    serving = EvalConfig(conf_threshold=0.25, cls_threshold=0.25, iou_threshold=0.45,
                         num_candidates=512)
    protocol = EvalConfig(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                          num_candidates=4096)
    serving_tta = EvalConfig(conf_threshold=0.25, cls_threshold=0.25, iou_threshold=0.45,
                             num_candidates=512, use_tta=True)
    tta = EvalConfig(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                     num_candidates=4096, use_tta=True)
    paths = [("serving B=8", serving, 8, "matrix_nms"),
             ("serving B=256", serving, 256, "nms_greedy"),
             ("serving TTA B=2", serving_tta, 2, "nms_greedy"),  # K = 3 x 512, unsorted
             ("protocol B=64", protocol, 64, "nms_greedy"),
             ("tta B=2", tta, 2, "matrix_nms_chunked")]
    rng = np.random.default_rng(0)
    launches = {k: 0 for k in counters}
    captured = {}
    for label, cfg, b, kernel in paths:
        ev = Evaluator(model, yolov5_decode_fn(), cfg, yolov5_select_fn(cfg), device="cuda")
        img = rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)
        ev(img)  # warm-up (cuDNN autotune, allocator)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = ev(img)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = {k: c.launches for k, c in counters.items()}
        if counts[kernel] == 0:
            fail(f"{label}: {kernel} was not launched ({counts})")
        for k, n in counts.items():
            launches[k] += n
        check_detections(out, b)
        best = min(times)
        log(f"{label}: {b / best:.1f} img/s (best of 3, {best * 1e3:.1f} ms/batch), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{int((out[..., 4] > 0).sum())} detections, launches {counts} [{card}]")
        with record_nms_inputs() as rec:  # the NMS inputs of this path
            ev(img)
        captured[label] = rec[kernel][0]

    # agreement with the CPU reference (plain twins) on a small input
    small = rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    ev_gpu = Evaluator(model, yolov5_decode_fn(), serving, yolov5_select_fn(serving),
                       device="cuda")
    got = ev_gpu(small).cpu().numpy()
    cpu_model = type(model)(80)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ev_cpu = Evaluator(cpu_model, yolov5_decode_fn(), serving, yolov5_select_fn(serving),
                       device="cpu")
    ref = ev_cpu(small).numpy()
    share, total = matched_share(got, ref)
    log(f"serving B=2 card vs CPU reference: {share * 100:.2f}% of {total} detections "
        "matched (class equal, conf 1e-4, box 1e-2 px; need >= 98%)")
    if share < 0.98:
        fail("card detections disagree with the CPU reference")

    # detect_batch on letterboxed images of assorted sizes
    for c in counters.values():
        c.launches = 0
    batch = np.zeros((8, 640, 640, 3), np.uint8)
    infos = np.ones((8, 5), np.float32)
    for i in range(8):
        h, w = rng.integers(200, 1200, 2)
        raw = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        batch[i], info = letterbox_image(raw, 640, stride=32)
        infos[i] = info.as_array()
    dets = detect_batch(ev_gpu, batch, infos)
    torch.cuda.synchronize()
    if len(dets) != 8 or counters["matrix_nms"].launches == 0:
        fail("detect_batch did not run through matrix_nms")
    launches["matrix_nms"] += counters["matrix_nms"].launches
    log(f"detect_batch B=8: {sum(0 if d is None else len(d) for d in dets)} detections")
    return launches, captured


def bound_ms(boxes, ious):
    """Least time on the card: the larger of bytes over the memory rate
    (boxes, scores read once; keep_idx, keep_valid written once) and f32
    operations over the f32 rate. Returns (ms, "bytes" | "operations")."""
    b, k = boxes.shape[:2]
    n_bytes = b * k * (16 + 4) + b * MAX_KEEP * (4 + 1)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ious * IOU_OPS / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def step_us(probe, lo=2000, hi=20000):
    """Measured time of one dependent step, ``csrc/step_probe.cu``, the
    launch cost cancelled by a difference. ``probe`` "warp": one dependent
    decision in one warp's registers, as B1's tile resolution takes it; a
    thread count: one block-wide step (publish to shared memory, one
    barrier, read a neighbour) in a block of that many threads."""
    from yoloseries_tpu_torch.kernels import _build

    lib = _build.load()
    out = torch.empty(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(steps):
        if probe == "warp":
            err = lib.yst_warp_step_probe(steps, out.data_ptr(), stream)
        else:
            err = lib.yst_step_probe(steps, probe, out.data_ptr(), stream)
        _build.check(err, "step probe")

    t_lo = cuda_ms(lambda: launch(lo), iters=10)
    t_hi = cuda_ms(lambda: launch(hi), iters=10)
    return (t_hi - t_lo) * 1e3 / (hi - lo)


def fixpoint_rounds(boxes, scores, thr):
    """(B,) confirm/kill rounds the exact-greedy fixpoint needs on these
    inputs (the loop of ``matrix_nms_plain``, counted)."""
    from yoloseries_tpu_torch.ops.iou import pairwise_iou

    k = scores.shape[1]
    ids = torch.arange(k, device=scores.device)
    s_j, s_i = scores[:, :, None], scores[:, None, :]
    pri = (s_j > s_i) | ((s_j == s_i) & (ids[:, None] < ids[None, :]))
    sup = (pairwise_iou(boxes, boxes) >= thr) & pri
    und = scores > 0.0
    kept = torch.zeros_like(und)
    rounds = torch.zeros(scores.shape[0], dtype=torch.int64, device=scores.device)
    while bool(und.any()):
        rounds += und.any(dim=1)
        blocked = (sup & und[:, :, None]).any(dim=1)
        kept = kept | (und & ~blocked)
        killed = (sup & kept[:, :, None]).any(dim=1)
        und = und & blocked & ~killed
    return rounds


def strip_inputs(boxes, scores, thr):
    """(boxes, scores) of every strip the chunked twin hands
    ``matrix_nms_plain``, after the carried-keeper kills, with the scores
    of an image that is done (carry full, or the rest dead) zeroed: the
    strips and images the kernel does work for. The twin stops after the
    last strip any image needs."""
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    inner, strips = m.matrix_nms_plain, []

    def record(b, s, t, keep):
        strips.append((b.clone(), s.clone()))
        return inner(b, s, t, keep)

    m.matrix_nms_plain = record
    try:
        m.matrix_nms_chunked_plain(boxes, scores, thr, MAX_KEEP)
    finally:
        m.matrix_nms_plain = inner
    return strips


def chain_steps(name, boxes, scores, thr, keepers, strips=None):
    """Dependent steps these inputs need, and the probe of one step
    (``step_us``). Images run side by side (one block each), so the longest
    image sets the chain. B1 needs one dependent decision per keeper, a
    warp-wide step each (a block need not meet between two). B2 runs two dependent block-wide
    exchanges per fixpoint round (confirm publishes the kept set, kill the
    undecided set); B3 runs the strips its data needs (up to the one where
    the last carry fills) one after another."""
    if name == "nms_greedy":
        return int(keepers.max()), "warp"
    if name == "matrix_nms":
        return 2 * int(fixpoint_rounds(boxes, scores, thr).max()), -(-scores.shape[1] // 32) * 32
    steps = sum(2 * int(fixpoint_rounds(b, s, thr).max()) for b, s in strips)
    return steps, 1024


def profiled_ms(fn, iters=10):
    """Device time per call of ``fn`` (torch.profiler: every kernel and
    copy it enqueues), beside the CUDA-event time, which also holds the
    host's enqueue when that is the longer, and the same split by device
    event name. (None, {}) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy = sum(t for t, _ in events)
    split = {name[:60]: t / iters / 1e3 for t, name in events}
    return (busy / iters / 1e3, split) if busy > 0 else (None, {})


def crossover(card):
    """B1 and B2 timed side by side at clustered candidates over the batch
    sizes and K the dispatch in ``ops/nms.py`` chooses between."""
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    rows = []
    for k in (512, 1024):
        for b in (1, 8, 16, 32, 64):
            boxes, scores = candidates(7 * b + k, b, k)
            t_greedy = cuda_ms(lambda: g.nms_greedy(boxes, scores, 0.45, MAX_KEEP), iters=20)
            t_matrix = cuda_ms(lambda: m.matrix_nms(boxes, scores, 0.45, MAX_KEEP), iters=20)
            rows.append({"B": b, "K": k, "greedy_ms": t_greedy, "matrix_ms": t_matrix})
            log(f"  crossover B={b} K={k} thr=0.45: B1 nms_greedy {t_greedy:.4f} ms, "
                f"B2 matrix_nms {t_matrix:.4f} ms, faster: "
                f"{'B2' if t_matrix < t_greedy else 'B1'} [{card}]")
    return rows


def phase_timings(captured, launches, mismatches, card):
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    tta = captured["tta B=2"]
    strips = strip_inputs(*tta)  # what the TTA batch's strips hand the fixpoint
    boxes, scores, thr = captured["serving B=8"]
    perm = torch.randperm(scores.shape[1], generator=torch.Generator().manual_seed(0))
    perm = perm.to(scores.device)  # the same candidates out of priority order
    captured = dict(captured, **{
        "tta strip 0, B=2": (*strips[0], tta[2]),
        "serving B=8, shuffled": (boxes[:, perm].contiguous(), scores[:, perm].contiguous(),
                                  thr)})
    n_strips = -(-tta[1].shape[1] // 1024)
    busy = sum(int((s > 0).any(dim=1).sum()) for _, s in strips)
    log(f"  tta B=2: {len(strips)} of {n_strips} strips run; (image, strip) pairs with "
        f"work: {busy} of {tta[1].shape[0] * n_strips}")
    b2 = ("yoloseries_tpu_torch/csrc/nms_matrix.cu, yoloseries_tpu_torch/csrc/nms_relation.cu",
          "yoloseries_tpu/kernels/nms_matrix.py:151")
    b1 = ("yoloseries_tpu_torch/csrc/nms_greedy.cu", "yoloseries_tpu/kernels/nms_pallas.py:115")
    specs = [
        ("nms_greedy", "serving B=256", g.nms_greedy, g.greedy_nms, *b1),
        ("nms_greedy", "protocol B=64", g.nms_greedy, g.greedy_nms, *b1),
        ("nms_greedy", "serving TTA B=2", g.nms_greedy, g.greedy_nms, *b1),
        ("matrix_nms", "serving B=8", m.matrix_nms, m.matrix_nms_plain, *b2),
        ("matrix_nms", "tta strip 0, B=2", m.matrix_nms, m.matrix_nms_plain, *b2),
        ("matrix_nms", "serving B=8, shuffled", m.matrix_nms, m.matrix_nms_plain, *b2),
        ("matrix_nms_chunked", "tta B=2", m.matrix_nms_chunked, m.matrix_nms_chunked_plain,
         b2[0], "yoloseries_tpu/kernels/nms_matrix.py:194"),
    ]
    counters = {"nms_greedy": g.nms_greedy, "nms_relation": m.nms_relation,
                "matrix_nms": m.matrix_nms, "matrix_nms_chunked": m.matrix_nms_chunked}
    saved = {k: f.launches for k, f in counters.items()}
    step = {}  # probe ("warp" or a block size) -> us per dependent step
    rows = {}
    for name, label, kernel, twin, source, replaces in specs:
        boxes, scores, thr = captured[label]
        b, k = scores.shape
        ki, kv = kernel(boxes, scores, thr, MAX_KEEP)
        want = twin(boxes, scores, thr, MAX_KEEP)
        torch.cuda.synchronize()
        err = float(max((ki - want[0]).abs().max(), (kv != want[1]).sum()))
        if name == "matrix_nms":  # the relation words, bit for bit
            words = m.nms_relation(boxes, scores, thr)
            err = max(err, float((words != m.nms_relation_plain(boxes, scores, thr)).sum()))
        ms = cuda_ms(lambda: kernel(boxes, scores, thr, MAX_KEEP), iters=20)
        device_ms, split = profiled_ms(lambda: kernel(boxes, scores, thr, MAX_KEEP))
        plain = cuda_ms(lambda: twin(boxes, scores, thr, MAX_KEEP), iters=3, warmup=1)
        keepers = kv.sum(dim=1)
        if name == "nms_greedy":
            ious = greedy_ious(scores, ki, kv)
        else:  # one IoU row per keeper over the candidates the fixpoint
            # looks at (B2 builds the whole relation): all K, and for B3 the
            # strips its data needs
            ious = int(keepers.sum()) * (len(strips) * 1024 if name == "matrix_nms_chunked"
                                         else k)
        bound, by = bound_ms(boxes, ious)
        steps, probe = chain_steps(name, boxes, scores, thr, keepers, strips)
        if probe not in step:
            step[probe] = step_us(probe)
            what = ("warp-wide, a decision in registers" if probe == "warp"
                    else f"block-wide, {probe} threads")
            log(f"  one dependent step (csrc/step_probe.cu, {what}): {step[probe]:.4f} us "
                f"[{card}]")
        chain = steps * step[probe] * 1e-3
        binding = "dependent steps" if chain > bound else by
        row = {"shape": f"{label}: B={b} K={k} thr={thr}", "max_abs_err": err,
               "ms": ms, "device_ms": device_ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "chain_ms": chain, "chain_steps": steps,
               "step_us": step[probe], "binding": binding, "ious": ious}
        if name == "nms_greedy":
            row["design_steps"] = design_steps(scores, ki, kv)
        if name in rows:  # a second shape of the same kernel on the path
            rows[name].setdefault("other_shapes", []).append(row)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        else:
            rows[name] = {"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": launches[name],
                          "mismatches": mismatches[name], **row, "library_ms": None}
        dev = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
        log(f"  {name} [{label}] B={b} K={k}: kernel {ms:.4f} ms (CUDA events), device time "
            f"{dev} (profiler), plain twin {plain:.3f} ms, bound {bound:.6f} ms ({by}; "
            f"{ious} IoUs), "
            f"chain {chain:.6f} ms ({steps} steps x {step[probe]:.4f} us), binding: "
            f"{binding}, mean keepers {float(keepers.float().mean()):.1f}, "
            f"no library yardstick [{card}]")
        if name == "nms_greedy":
            log(f"    design steps (block-wide steps of the tile scan: tiles walked in the "
                f"longest image; a diagnostic, not a bound): {row['design_steps']}")
            if (ms if device_ms is None else device_ms) < max(bound, chain):
                fail(f"{name} [{label}]: measured under the larger of its bound and its chain")
        log("    device time per call by kernel: "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in list(split.items())[:6]))
    rows["matrix_nms"]["relation_mismatches"] = mismatches["nms_relation"]
    rows["matrix_nms"]["crossover"] = crossover(card)
    for k, f in counters.items():
        f.launches = saved[k]  # the timing launches are not the path's
    rows = list(rows.values())
    if any(r["max_abs_err"] for r in rows):
        fail("kernel/twin disagreement at the serving path's candidates")
    return rows


KERNEL_GROUPS = (  # (group, substrings of the device event name), first match wins
    ("NMS kernels", ("nms_kernel", "nms_relation_kernel", "nms_fixpoint_kernel")),
    ("H2D copy", ("Memcpy HtoD",)),
    ("convolution", ("conv", "fprop", "xmma", "implicit_gemm", "cudnn", "gemm")),
    ("sort / top-k", ("sort", "Sort", "radix", "topk")),
    ("elementwise", ("elementwise", "reduce_kernel", "Reduce")),
)


def _device_events(prof):
    """(microseconds, name) of every device-side event (kernels, copies),
    each counted once. The device-side copies of ``record_function`` ranges
    are left out: they span kernels already counted."""
    from torch.autograd import DeviceType

    ranges = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    out = []
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != DeviceType.CUDA or "Activity Buffer" in e.key
                or e.key in ranges):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out.append((float(us), e.key))
    return sorted(out, reverse=True)


def phase_profile(model, card):
    """Where one batch's device time goes (torch.profiler): device-busy
    share of the wall time and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from yoloseries_tpu_torch.evaluation import (
        EvalConfig,
        Evaluator,
        yolov5_decode_fn,
        yolov5_select_fn,
    )

    rng = np.random.default_rng(1)
    for label, b, cfg in (
        ("serving B=256", 256, EvalConfig(conf_threshold=0.25, cls_threshold=0.25,
                                          iou_threshold=0.45, num_candidates=512)),
        ("protocol B=64", 64, EvalConfig(conf_threshold=0.001, cls_threshold=0.001,
                                         iou_threshold=0.65, num_candidates=4096)),
        ("tta B=2", 2, EvalConfig(conf_threshold=0.001, cls_threshold=0.001,
                                  iou_threshold=0.65, num_candidates=4096, use_tta=True)),
    ):
        ev = Evaluator(model, yolov5_decode_fn(), cfg, yolov5_select_fn(cfg), device="cuda")
        img = rng.integers(0, 256, (b, 640, 640, 3), dtype=np.uint8)
        ev(img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev(img)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = _device_events(prof)
        busy = sum(t for t, _ in kernels)
        if busy == 0:
            log(f"{label}: the profiler recorded no device time (not measured)")
            continue
        # unclamped: a negative idle share shows that device events were
        # counted twice
        log(f"{label}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
            f"idle share {(1 - busy / wall_us) * 100:.1f}% [{card}]")
        groups = {g: 0.0 for g, _ in KERNEL_GROUPS} | {"other": 0.0}
        for t, name in kernels:
            group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                         "other")
            groups[group] += t
        log("  by group: " + ", ".join(f"{g} {t / busy * 100:.2f}%" for g, t in groups.items()))
        for t, name in kernels[:6]:
            log(f"  {t / busy * 100:5.1f}%  {t / 1e3:8.3f} ms  {name[:90]}")


# --------------------------------------------------------------- training

TRAIN_UPDATES = 8
TRAIN_BATCH, TRAIN_ACCUMULATE = 64, 2  # the preset's batch_size 64, accumulate_loss_step 128


def synthetic_folder(root, n, seed):
    """``n`` PNGs of COCO-like sizes (the long side ``size``) holding 1-12
    filled boxes of 80 classes on a smooth background, their txt labels,
    and names.txt. Returns (img_dir, lab_dir, names)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 226, (80, 3), dtype=np.uint8)
    jobs = []
    for i in range(n):
        h, w = [(480, 640), (640, 480), (427, 640), (640, 640)][int(rng.integers(0, 4))]
        yy, xx = np.mgrid[0:h, 0:w]
        base = (60 + 40 * np.sin(yy / rng.uniform(20, 90)) * np.cos(xx / rng.uniform(20, 90)))
        img = np.repeat(base[..., None], 3, axis=2).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 13))):
            bw, bh = rng.integers(16, w // 2), rng.integers(16, h // 2)
            x1, y1 = rng.integers(0, w - bw), rng.integers(0, h - bh)
            c = int(rng.integers(0, 80))
            img[y1:y1 + bh, x1:x1 + bw] = colors[c]
            lines.append(f"{c} {x1} {y1} {x1 + bw} {y1 + bh}")
        jobs.append((img, img_dir / f"{i:05d}.png", lab_dir / f"{i:05d}.txt", lines))

    def write(job):
        img, img_path, lab_path, lines = job
        Image.fromarray(img).save(img_path, compress_level=1)
        lab_path.write_text("\n".join(lines) + "\n")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    names = root / "names.txt"
    names.write_text("".join(f"{c} class{c}\n" for c in range(80)))
    return img_dir, lab_dir, names


def train_hyp(updates):
    """The preset's training keys (``configs/presets/train_yolov5.yaml``,
    written out: this script reads no YAML) for a run of ``updates`` one-update
    epochs, augmentation closed for all of them."""
    return {
        "input_img_size": [640, 640], "batch_size": TRAIN_BATCH,
        "accumulate_loss_step": TRAIN_BATCH * TRAIN_ACCUMULATE, "random_seed": 7,
        "num_workers": 8, "total_epoch": updates, "no_data_aug_epoch": updates,
        "do_ema": True, "save_ckpt_every": 1000, "optimizer": "sgd",
        "basic_lr_per_img": 0.000625, "weight_decay": 0.0001, "momentum": 0.937,
        "scheduler_type": "linear", "lr_max_ds_scale": 0.001, "do_warmup": True,
        "warmup_epoch": 3, "warmup_bias_max_lr": 0.1, "warmup_momentum": 0.8,
        "use_focal_loss": True, "compute_metric_conf_threshold": 0.001,
        "compute_metric_iou_threshold": 0.65, "compute_metric_cls_threshold": 0.001,
    }


def settle_bn(model, img):
    """Set every BN layer's running stats to its batch stats on ``img``."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative mean: after one batch, that batch's stats
    with torch.no_grad():
        model.train()(img)
    for m, momentum in zip(bns, saved):
        m.momentum = momentum


def timed_updates(trainer):
    """Wrap the trainer's step so that a CUDA event is recorded at the end
    of every update (no host sync), with the host's clock at the step's
    entry and exit. Returns (events, host (enter, exit) pairs)."""
    ends, host = [], []
    size = tuple(trainer.cfg.input_size)
    inner = trainer._step_fn_for(size)

    def step(state, batch):
        t0 = time.perf_counter()
        out = inner(state, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        host.append((t0, time.perf_counter()))
        return out

    trainer._step_fns[size] = step
    return ends, host


def step_alone_ms(trainer, host_batch, n=3):
    """ms per update of the train step alone, on one batch already on the
    card (no loader, no copy): CUDA events around ``n`` updates after one
    untimed."""
    step = trainer._step_fn_for(tuple(trainer.cfg.input_size))
    batch = trainer._device_batch(host_batch)
    trainer.state, _ = step(trainer.state, batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        trainer.state, _ = step(trainer.state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def batch_digest(batch) -> str:
    """sha256 of every array of a batch in key order, a plan batch's fields
    included."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        for a in ([v[f] for f in sorted(v)] if isinstance(v, dict) else [v]):
            if isinstance(a, np.ndarray):
                h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def loader_alone_ms(dataset, cfg, n=3, use_processes=None, digest=True, **loader_kw):
    """ms per batch of a fresh loader over ``dataset``, built as the Trainer
    builds it (``use_processes`` None: the loader's default; ``loader_kw``:
    ``device_aug``, ``device_cache``), with nothing else running: the
    consumer takes each batch at once, so batches arrive as fast as the
    loader makes them (the median gap between arrivals after the first
    batch). Returns (ms, "processes" or "threads", sha256 of each batch, or
    none without ``digest``: hashing a batch of pixel plans, 1.26 GB at 640
    px, takes longer than making it)."""
    from yoloseries_tpu_torch.data.loader import DataLoader

    loader = DataLoader(dataset, batch_size=cfg.batch_size * cfg.accumulate,
                        max_labels=cfg.max_labels, seed=cfg.seed + 1, workers=cfg.num_workers,
                        use_processes=use_processes, **loader_kw)
    mode = "threads" if loader._proc_pool is None else "processes"
    if use_processes and mode == "threads":
        fail("the loader runs no worker processes")
    try:
        arrivals, digests = [], []
        for _ in range(n + 1):
            batch = next(loader)
            arrivals.append(time.perf_counter())
            if digest:
                digests.append(batch_digest(batch))
    finally:
        loader.stop()
    return float(np.median(np.diff(arrivals))) * 1e3, mode, digests


def host_split(dataset, cfg, n=32):
    """Where a loader's host time goes, one thread, nothing else running:
    ms per sample of ``dataset.get`` (decode, augmentation) and of the
    letterbox collate (in the workers with processes, in the producer
    thread with threads), each over ``n`` samples."""
    from yoloseries_tpu_torch.data.loader import collate_batch

    t0 = time.perf_counter()
    samples = [dataset.get(i % len(dataset), np.random.default_rng(i)) for i in range(n)]
    t1 = time.perf_counter()
    collate_batch(samples, cfg.input_size, cfg.max_labels)
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n


def step_syncs(trainer, host_batch, with_copy=False):
    """Where one update makes the host wait for the card
    (``torch.cuda.set_sync_debug_mode``: a warning per synchronizing call);
    ``with_copy``: the ``Trainer``'s copy of the batch (and its render) too."""
    import traceback
    import warnings

    step = trainer._step_fn_for(tuple(trainer.cfg.input_size))
    batch = None if with_copy else trainer._device_batch(host_batch)
    torch.cuda.synchronize()
    where = []

    def note(message, *args, **kwargs):  # the innermost line of the port that called
        if "prototype feature" in str(message):  # said once when the mode is set
            return
        frames = [f for f in traceback.extract_stack()[:-1] if "yoloseries_tpu_torch" in f.filename]
        where.append(f"{frames[-1].filename.split('yoloseries_tpu_torch/')[-1]}:"
                     f"{frames[-1].lineno}" if frames else str(message)[:80])

    with warnings.catch_warnings():  # restores showwarning
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if with_copy:
                batch = trainer._device_batch(host_batch)
            trainer.state, _ = step(trainer.state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return where


def h2d_ms(copy, n=3):
    """A copy to the card on an idle card (``copy()``, e.g. the
    ``Trainer``'s of one batch): host ms of the call (pinning, enqueue) and
    host ms until the copy has landed (medians of ``n``)."""
    calls, landed = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy()
        calls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        landed.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(calls)), float(np.median(landed))


def card_vs_cpu_update(card):
    """One update of YOLOv5s at 256 px, B=4 x accumulate 2, warmup active,
    on the card and on the CPU from the same weights and batch."""
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    ann = np.full((8, 32, 6), -1.0, np.float32)
    for b in range(8):
        n = int(rng.integers(1, 12))
        xy = rng.uniform(0, 200, (n, 2))
        ann[b, :n, :2] = xy
        ann[b, :n, 2:4] = np.minimum(xy + rng.uniform(8, 120, (n, 2)), 256)
        ann[b, :n, 4] = rng.integers(0, 80, n)
        ann[b, :n, 5] = b
    sd = create_model("yolov5s", num_class=80, device="cpu", seed=1).state_dict()
    loss_fn, _ = get_family("yolov5s").make_loss({}, 80, (256, 256))
    cfg = OptimizerConfig(batch_size=4, steps_per_epoch=1, warmup_steps_override=100)
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(create_model("yolov5s", 80, device="cpu"), cfg,
                                   state_dict=sd, device=dev)
        step = make_train_step(loss_fn, accumulate=2)
        batch = {"img": torch.from_numpy(img).to(dev), "ann": torch.from_numpy(ann).to(dev)}
        state, metrics = step(state, batch)
        out[dev] = (float(metrics["tot_loss"]),
                    {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst = max(float(((out["cuda"][1][k] - p).abs() / p.abs().clamp_min(1.0)).max())
                for k, p in out["cpu"][1].items())
    log(f"card vs CPU, one update of yolov5s at 256 px, B=4 x 2: tot_loss {out['cuda'][0]:.6f} "
        f"vs {out['cpu'][0]:.6f} (relative {rel:.2e}), largest parameter difference "
        f"{worst:.2e} x max(1, |p|) (tolerance {TRAIN_TOL}) [{card}]")
    if not (rel <= TRAIN_TOL and worst <= TRAIN_TOL):
        fail("one update on the card disagrees with the CPU")


TRAIN_GROUPS = (  # (group, how it is found): CPU ops or ranges, device time with children
    ("convolution forward", ("aten::cudnn_convolution",)),
    ("convolution backward", ("aten::convolution_backward",)),
    ("BN (forward + backward)", ("aten::cudnn_batch_norm", "aten::cudnn_batch_norm_backward",
                                 "aten::native_batch_norm", "aten::native_batch_norm_backward")),
    ("loss forward", ("train.loss",)),
    ("  of it the winner step", ("yolov5_loss.winners",)),
    ("optimizer", ("train.optimizer",)),
    ("EMA", ("train.ema",)),
    ("render (device aug)", ("train.render",)),
)


def profile_update(trainer, card, host):
    """Device time of one training update by part (torch.profiler), the
    copy of ``host`` to the card included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = trainer._step_fn_for(tuple(trainer.cfg.input_size))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = step(trainer.state, trainer._device_batch(host))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_events(prof)
    busy = sum(t for t, _ in kernels) / 1e3
    if busy == 0:
        log("training update: the profiler recorded no device time (not measured)")
        return None
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    split = {}
    for group, names in TRAIN_GROUPS:
        split[group] = sum(e.device_time_total for e in events if e.name in names) / 1e3
    split["H2D copy"] = sum(t for t, n in kernels if "Memcpy HtoD" in n) / 1e3
    counted = sum(v for k, v in split.items() if not k.startswith("  "))
    split["other (SiLU, concat, loss backward, ...)"] = busy - counted
    log(f"training update (B={TRAIN_BATCH} x {TRAIN_ACCUMULATE} at 640, profiled): wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{(1 - busy / wall_ms) * 100:.1f}% [{card}]")
    log("  by part: " + ", ".join(f"{k.strip()} {v:.1f} ms ({v / busy * 100:.1f}%)"
                                  for k, v in split.items()))
    for t, name in kernels[:6]:
        log(f"  {t / busy / 10:5.1f}%  {t / 1e3:8.3f} ms  {name[:90]}")
    for t, name in kernels:
        if "Memcpy" in name:
            log(f"  copy: {t / 1e3:8.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **split}


def phase_training(card):
    import tempfile
    from pathlib import Path

    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.data.loader import collate_batch
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m
    from yoloseries_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    counters = {"nms_greedy": g.nms_greedy, "nms_relation": m.nms_relation,
                "matrix_nms": m.matrix_nms, "matrix_nms_chunked": m.matrix_nms_chunked}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        train_dirs = synthetic_folder(tmp / "train", TRAIN_BATCH * TRAIN_ACCUMULATE, seed=0)
        val_dirs = synthetic_folder(tmp / "val", 2 * TRAIN_BATCH, seed=1)
        log(f"synthetic folder set: {TRAIN_BATCH * TRAIN_ACCUMULATE} train and "
            f"{2 * TRAIN_BATCH} val PNGs in {time.perf_counter() - t0:.1f} s")
        cfg = TrainConfig.from_hyp(train_hyp(TRAIN_UPDATES), num_class=80, model="yolov5s",
                                   output_dir=str(tmp / "run"))
        trainer = Trainer(cfg, train_dirs[:2], val_dirs=val_dirs[:2], names_path=train_dirs[2],
                          log_fn=lambda *a: log("  trainer:", *a), device="cuda")
        try:
            # random weights put every score under the protocol's conf .001
            # and evaluate() would hand B1 nothing live: on eight val images,
            # set the BN running stats to their batch stats (train and eval
            # mode then see alike maps) and widen the head as phase 4 does;
            # the EMA restarts from these weights
            calib = collate_batch([trainer.val_dataset.get(i, np.random.default_rng(i))
                                   for i in range(8)], cfg.input_size, cfg.max_labels)["img"]
            calib = torch.from_numpy(calib).cuda().permute(0, 3, 1, 2).float() / 255
            model = trainer.state.model
            settle_bn(model, calib)
            widen_head(model.eval(), calib)
            trainer.state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ends, host = timed_updates(trainer)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            with record_nms_inputs() as rec:
                t0 = time.perf_counter()
                result = trainer.evaluate()
                eval_s = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            per_update = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
            ms = float(np.median(per_update[1:]))  # updates 3.. (the first two: cuDNN tuning)
            # host clock: between one step's exit and the next one's entry the
            # Trainer waits for the loader and copies the batch; inside the
            # step it enqueues the update (and waits wherever the step syncs)
            between = float(np.median([(b[0] - a[1]) * 1e3 for a, b in zip(host, host[1:])][1:]))
            inside = float(np.median([(b - a) * 1e3 for a, b in host[2:]]))
            for i, h in enumerate(trainer.history):
                log(f"  update {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(h.items())))
            bad = [h for h in trainer.history
                   if not all(np.isfinite(v) for v in h.values())]
            if len(trainer.history) != TRAIN_UPDATES or bad:
                fail(f"training: {len(trainer.history)} updates, non-finite losses {bad}")
            log(f"training yolov5s 640 f32, B={TRAIN_BATCH} x {TRAIN_ACCUMULATE}: "
                f"{ms:.1f} ms per update (median of updates 3-{TRAIN_UPDATES}, CUDA events "
                f"between update ends), {TRAIN_BATCH * TRAIN_ACCUMULATE / ms * 1e3:.1f} img/s, "
                f"peak {peak:.2f} GiB, {TRAIN_UPDATES} updates in {train_s:.1f} s (update 2: "
                f"{per_update[0]:.1f} ms) [{card}]")
            log(f"  host, median of updates 3-{TRAIN_UPDATES}: {between:.1f} ms between steps "
                f"(loader wait, pinning, copy enqueue), {inside:.1f} ms inside the step [{card}]")
            log(f"evaluate() on the EMA weights, 2 batches of {TRAIN_BATCH}: mAP "
                f"{result['map']:.6f} mAP50 {result['map50']:.6f} in {eval_s:.1f} s; launches "
                f"{launches} [{card}]")
            if launches["nms_greedy"] == 0:
                fail("evaluate() did not launch nms_greedy")
            mismatches, kept = 0, 0
            for boxes, scores, thr in rec["nms_greedy"]:
                want = g.greedy_nms(boxes, scores, thr, MAX_KEEP)
                got = g.nms_greedy(boxes, scores, thr, MAX_KEEP)
                torch.cuda.synchronize()
                mismatches += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
                kept += int(want[1].sum())
            live = sum(int((s > 0).sum()) for _, s, _ in rec["nms_greedy"])
            log(f"  nms_greedy at the val pass's {len(rec['nms_greedy'])} candidate sets "
                f"{tuple(rec['nms_greedy'][0][1].shape)}: {live} live candidates, {kept} kept, "
                f"{mismatches} mismatches")
            if mismatches:
                fail("nms_greedy disagrees with its twin in evaluate()")
            if kept == 0:
                fail("evaluate() handed nms_greedy no live candidate")
            # the parts of an update apart, each on a quiet host: the loader
            # alone, then (the Trainer's loader stopped) the copy, the step
            # on a batch already on the card, and its host syncs
            loader, mode, digests = loader_alone_ms(trainer.train_dataset, cfg)
            loader_threads, _, digests_threads = loader_alone_ms(trainer.train_dataset, cfg,
                                                                 use_processes=False)
            if digests != digests_threads:
                fail(f"the loader's {mode} and threads made different batches")
            get_ms, collate_ms = host_split(trainer.train_dataset, cfg)
            log(f"  the loader alone with {cfg.num_workers} threads {loader_threads:.1f} ms per "
                f"batch (the same bytes); one thread, per sample: get (PIL decode) {get_ms:.2f} "
                f"ms, collate (letterbox into the batch) {collate_ms:.2f} ms [{card}]")
            host_batch = next(trainer.train_loader)
            trainer.train_loader.stop()
            h2d_call, h2d_landed = h2d_ms(lambda: trainer._device_batch(host_batch))
            alone = step_alone_ms(trainer, host_batch)
            syncs = step_syncs(trainer, host_batch)
            log(f"  apart, on a quiet host: the loader alone {loader:.1f} ms per batch of "
                f"{TRAIN_BATCH * TRAIN_ACCUMULATE} ({cfg.num_workers} {mode}); the Trainer's "
                f"copy of one batch ({host_batch['img'].nbytes / 2**20:.0f} MiB) {h2d_call:.1f} "
                f"ms to return (pinning, enqueue), {h2d_landed:.1f} ms until landed; the step "
                f"alone on a batch already on the card {alone:.1f} ms per update "
                f"({TRAIN_BATCH * TRAIN_ACCUMULATE / alone * 1e3:.1f} img/s), {len(syncs)} host "
                f"syncs in one update [{card}]")
            for where in syncs[:5]:
                log(f"    sync: {where}")
            profile = profile_update(trainer, card, host_batch)
        finally:
            trainer.close()
    card_vs_cpu_update(card)
    wall = time.perf_counter() - t_phase
    log(f"training phase: {wall:.1f} s [{card}]")
    return {"ms_per_update": ms, "img_per_s": TRAIN_BATCH * TRAIN_ACCUMULATE / ms * 1e3,
            "peak_gib": peak, "map": result["map"], "map50": result["map50"],
            "host_between_ms": between, "host_inside_ms": inside, "loader_ms": loader,
            "loader_mode": mode, "loader_threads_ms": loader_threads, "get_ms_per_sample": get_ms,
            "collate_ms_per_sample": collate_ms,
            "step_alone_ms": alone, "step_syncs": len(syncs), "h2d_call_ms": h2d_call,
            "h2d_landed_ms": h2d_landed,
            "launches": launches, "captured": rec["nms_greedy"][0], "profile": profile,
            "phase_s": wall}


# ----------------------------------------------------------- the recipe

RECIPE_EPOCHS, RECIPE_CLOSED = 4, 2  # one-update epochs; augmentation closed for the last 2
DIGEST_SEED = 5
PRESET_AUG = {  # data_hyp of configs/presets/train_yolov5.yaml
    "data_aug_prespective_p": 1.0, "data_aug_scale": 0.5, "data_aug_shear": 0.0,
    "data_aug_translate": 0.1, "data_aug_degree": 0.0, "data_aug_prespective": 0.0005,
    "data_aug_hsv_p": 1.0, "data_aug_hsv_hgain": 0.015, "data_aug_hsv_sgain": 0.7,
    "data_aug_hsv_vgain": 0.4, "data_aug_mixup_p": 0.3, "data_aug_fliplr_p": 0.3,
    "data_aug_flipud_p": 0.0, "data_aug_fill_value": 114, "data_aug_mosaic_p": 1.0,
    "data_aug_cutout_p": 0.3, "data_aug_cutout_iou_thr": 0.3, "data_aug_scale_jitting_p": 0.0,
}


def recipe_hyp():
    """Phase 8's keys with the preset's augmentation and the image cache,
    for 4 one-update epochs, the last 2 closed; a checkpoint every epoch."""
    return {**train_hyp(RECIPE_EPOCHS), **PRESET_AUG, "no_data_aug_epoch": RECIPE_CLOSED,
            "cache_images": True, "save_ckpt_every": 1}


def aug_digest(dataset_cls, loader_cls, img_dir, lab_dir, cache_dir, **loader_kw):
    """sha256 of the images and targets of the first batch of 8 that
    ``loader_cls`` makes over the folder at 640 px, seed 5, with the
    preset's augmentation (the dataset's default) and the image cache. Both
    packages give the same bytes under one cv2 (``dataset_cls`` and
    ``loader_cls`` may be either's)."""
    import hashlib

    ds = dataset_cls(img_dir, lab_dir, input_size=(640, 640), enable_aug=True,
                     cache_images=True, cache_dir=cache_dir)
    loader = loader_cls(ds, batch_size=8, max_labels=300, seed=DIGEST_SEED, **loader_kw)
    try:
        batch = next(loader)
    finally:
        loader.stop()
    return hashlib.sha256(batch["img"].tobytes() + batch["ann"].tobytes()).hexdigest()


def cv2_op_digests():
    """sha256 (first 16 hex digits) of each cv2 call of the augmenters and
    the cache on fixed seeded inputs at 640 px: where two cv2 builds part."""
    import hashlib

    import cv2

    rng = np.random.default_rng(DIGEST_SEED)
    yy, xx = np.mgrid[0:480, 0:640]
    img = np.clip(np.stack([100 + 80 * np.sin(yy / 13.0 + c) * np.cos(xx / 17.0)
                            for c in range(3)], -1) + rng.integers(-30, 30, (480, 640, 3)),
                  0, 255).astype(np.uint8)
    other = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    M = np.array([[0.9, 0.05, 40.0], [-0.03, 1.1, -20.0], [2e-4, -1e-4, 1.0]])
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    lut = np.clip(np.arange(256) * 1.3, 0, 255).astype(np.uint8)
    ops = {
        "resize linear (cache)": lambda: cv2.resize(img, (533, 400),
                                                    interpolation=cv2.INTER_LINEAR),
        "warpPerspective": lambda: cv2.warpPerspective(img, M, dsize=(640, 640),
                                                       borderValue=(114, 114, 114)),
        "warpAffine": lambda: cv2.warpAffine(img, M[:2], dsize=(640, 640),
                                             borderValue=(114, 114, 114)),
        "cvtColor RGB2HSV": lambda: hsv,
        "cvtColor HSV2RGB": lambda: cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
        "LUT": lambda: cv2.LUT(img[..., 0].copy(), lut),
        "addWeighted": lambda: cv2.addWeighted(img, 0.37, other, 0.63, 0.0),
        "blur": lambda: cv2.blur(img, (5, 5)),
        "getRotationMatrix2D": lambda: cv2.getRotationMatrix2D(angle=7.0, center=(0, 0),
                                                               scale=1.3),
    }
    return {k: hashlib.sha256(np.ascontiguousarray(f()).tobytes()).hexdigest()[:16]
            for k, f in ops.items()}


def greedy_mismatches(calls):
    """B1 against its twin at recorded (boxes, scores, thr) calls:
    (mismatched slots, keepers, live candidates)."""
    from yoloseries_tpu_torch.kernels import nms_greedy as g

    bad = kept = live = 0
    saved = g.nms_greedy.launches
    for boxes, scores, thr in calls:
        want = g.greedy_nms(boxes, scores, thr, MAX_KEEP)
        got = g.nms_greedy(boxes, scores, thr, MAX_KEEP)
        torch.cuda.synchronize()
        bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        kept += int(want[1].sum())
        live += int((scores > 0).sum())
    g.nms_greedy.launches = saved
    return bad, kept, live


def phase_recipe(card, keep_dir):
    """The preset's recipe on the port: augmented, cached training through
    the close, the augmented loader alone, then ``cli/val.py`` and
    ``cli/detect.py`` on the checkpoint the run wrote; the checkpoint and
    ``detect``'s images are copied to ``keep_dir`` for phase 11."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import cv2

    from yoloseries_tpu_torch.cli.detect import main as detect_main
    from yoloseries_tpu_torch.cli.val import main as val_main
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.data import DataLoader, DetectionDataset, collate_batch
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m
    from yoloseries_tpu_torch.train import Trainer, latest_step

    t_phase = time.perf_counter()
    cores, usable = os.cpu_count(), len(os.sched_getaffinity(0))
    log(f"host: os.cpu_count() {cores}, usable cores {usable}; cv2 {cv2.__version__}, "
        f"cv2 threads {cv2.getNumThreads()}")
    counters = {"nms_greedy": g.nms_greedy, "nms_relation": m.nms_relation,
                "matrix_nms": m.matrix_nms, "matrix_nms_chunked": m.matrix_nms_chunked}
    batch = TRAIN_BATCH * TRAIN_ACCUMULATE
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        train_dirs = synthetic_folder(tmp / "train", batch, seed=2)
        val_dirs = synthetic_folder(tmp / "val", TRAIN_BATCH, seed=3)
        digest_dirs = synthetic_folder(tmp / "digest", 8, seed=DIGEST_SEED)
        log(f"synthetic folder set: {batch} train, {TRAIN_BATCH} val and 8 digest PNGs in "
            f"{time.perf_counter() - t0:.1f} s")
        digest = aug_digest(DetectionDataset, DataLoader, *digest_dirs[:2], tmp / "digest_cache")
        log(f"augmented batch sha256 (8 x 640 px, preset augmentation, image cache, seed "
            f"{DIGEST_SEED}, cv2 {cv2.__version__}): {digest}")
        op_digests = cv2_op_digests()
        log("  cv2 calls, sha256[:16]: " + ", ".join(f"{k} {v}" for k, v in op_digests.items()))

        cfg = TrainConfig.from_hyp(recipe_hyp(), num_class=80, model="yolov5s",
                                   output_dir=str(tmp / "run"))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, train_dirs[:2], names_path=train_dirs[2],
                          log_fn=lambda *a: log("  trainer:", *a), device="cuda")
        init_s = time.perf_counter() - t0
        ckpt_dir = trainer.ckpt_dir
        try:
            if trainer.train_loader._proc_pool is None:
                fail("the Trainer's loader runs no worker processes")
            if trainer.train_dataset._cache is None or not trainer.train_dataset.cached_canvas:
                fail("the train set serves no cached canvases")
            # as in phase 8: BN stats from a val batch, then the head widened,
            # so that val hands B1 live candidates; the EMA restarts here
            val_ds = DetectionDataset(*val_dirs[:2], input_size=cfg.input_size)
            calib = collate_batch([val_ds.get(i, np.random.default_rng(i)) for i in range(8)],
                                  cfg.input_size, cfg.max_labels)["img"]
            calib = torch.from_numpy(calib).cuda().permute(0, 3, 1, 2).float() / 255
            model = trainer.state.model
            settle_bn(model, calib)
            widen_head(model.eval(), calib)
            trainer.state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ends, host = timed_updates(trainer)
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            trainer.close()
        bad = [h for h in trainer.history if not all(np.isfinite(v) for v in h.values())]
        if len(trainer.history) != RECIPE_EPOCHS or bad:
            fail(f"recipe: {len(trainer.history)} updates, non-finite losses {bad}")
        steps = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
        closed_at = (RECIPE_EPOCHS - RECIPE_CLOSED) * trainer.steps_per_epoch
        if latest_step(ckpt_dir) != RECIPE_EPOCHS or closed_at not in steps:
            fail(f"recipe: checkpoints at steps {steps}, want the close's {closed_at} and "
                 f"the last {RECIPE_EPOCHS}")
        per_update = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        between = [(b[0] - a[1]) * 1e3 for a, b in zip(host, host[1:])]
        for i, h in enumerate(trainer.history):
            log(f"  update {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(h.items())))
        log(f"recipe: yolov5s 640 f32, B={TRAIN_BATCH} x {TRAIN_ACCUMULATE}, preset augmentation "
            f"and the image cache, {RECIPE_EPOCHS} one-update epochs (the last {RECIPE_CLOSED} "
            f"closed): Trainer built in {init_s:.1f} s (cold cache), {train_s:.1f} s for the "
            f"updates; ms between update ends {', '.join(f'{x:.1f}' for x in per_update)}; host "
            f"ms between steps {', '.join(f'{x:.1f}' for x in between)}; checkpoints at steps "
            f"{steps} [{card}]")

        # the augmented loader alone, threads then processes, batch for batch
        loader = {}
        for mode in (False, True):
            ms, name, digests = loader_alone_ms(trainer.train_dataset, cfg, use_processes=mode)
            loader[name] = (ms, digests)
        if loader["threads"][1] != loader["processes"][1]:
            fail("the augmented loader's processes and threads made different batches")
        get_ms, collate_ms = host_split(trainer.train_dataset, cfg)
        log(f"  the augmented loader alone (cached canvases, preset augmentation): "
            f"{loader['threads'][0]:.1f} ms per batch of {batch} with {cfg.num_workers} threads, "
            f"{loader['processes'][0]:.1f} ms with {cfg.num_workers} processes; "
            f"{len(loader['threads'][1])} batches byte-identical; one thread, per sample: get "
            f"(mosaic, mixup, warp, HSV, ...) {get_ms:.2f} ms, collate {collate_ms:.2f} ms "
            f"[{card}]")

        # val on the checkpoint the run wrote: B1 at B=16, K=4096
        for c in counters.values():
            c.launches = 0
        with record_nms_inputs() as rec:
            t0 = time.perf_counter()
            result = val_main(["--ckpt-dir", str(ckpt_dir), "--val-img-dir", str(val_dirs[0]),
                               "--val-lab-dir", str(val_dirs[1]), "--name-path",
                               str(val_dirs[2]), "--device", "cuda"])
            val_s = time.perf_counter() - t0
        val_launches = {k: c.launches for k, c in counters.items()}
        val_calls = rec["nms_greedy"]
        mismatches, kept, live = greedy_mismatches(val_calls)
        log(f"cli/val.py on the step-{RECIPE_EPOCHS} checkpoint (EMA), {TRAIN_BATCH} images at "
            f"B=16: mAP {result['map']:.6f} mAP50 {result['map50']:.6f} in {val_s:.1f} s; "
            f"launches {val_launches}; nms_greedy at its {len(val_calls)} candidate sets "
            f"{tuple(val_calls[0][1].shape) if val_calls else ()}: {live} live "
            f"candidates, {kept} kept, {mismatches} mismatches [{card}]")
        if val_launches["nms_greedy"] == 0:
            fail("cli/val.py did not launch nms_greedy")
        if mismatches:
            fail("nms_greedy disagrees with its twin in cli/val.py")
        if kept == 0:
            fail("cli/val.py handed nms_greedy no live candidate")

        # detect on a few images of the val set, from the same checkpoint
        few = tmp / "few"
        few.mkdir()
        for p in sorted(val_dirs[0].iterdir())[:6]:
            (few / p.name).symlink_to(p)
        for c in counters.values():
            c.launches = 0
        with record_nms_inputs() as rec:
            t0 = time.perf_counter()
            found = detect_main(["--ckpt-dir", str(ckpt_dir), "--img-dir", str(few),
                                 "--name-path", str(val_dirs[2]), "--save-dir",
                                 str(tmp / "detect"), "--device", "cuda"])
            detect_s = time.perf_counter() - t0
        detect_launches = {k: c.launches for k, c in counters.items()}
        bad = greedy_mismatches(rec["nms_greedy"])[0]
        saved = m.matrix_nms.launches
        for boxes, scores, thr in rec["matrix_nms"]:
            want = m.matrix_nms_plain(boxes, scores, thr, MAX_KEEP)
            got = m.matrix_nms(boxes, scores, thr, MAX_KEEP)
            torch.cuda.synchronize()
            bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        m.matrix_nms.launches = saved
        n_boxes = sum(len(v) for v in found.values())
        log(f"cli/detect.py --ckpt-dir on {len(found)} images (B=8, K=4096, conf .3): {n_boxes} "
            f"boxes in {detect_s:.1f} s; launches {detect_launches}; against the twins at its "
            f"candidates: {bad} mismatches [{card}]")
        if len(found) != 6 or sum(detect_launches.values()) == 0 or bad:
            fail("cli/detect.py --ckpt-dir: images missing, no kernel launched or a mismatch")
        shutil.copytree(ckpt_dir, keep_dir / "ckpt")
        shutil.copytree(few, keep_dir / "few")  # the images, not the links
    wall = time.perf_counter() - t_phase
    log(f"recipe phase: {wall:.1f} s [{card}]")
    return {"loss_first": trainer.history[0]["tot_loss"],
            "loss_last": trainer.history[-1]["tot_loss"], "ms_between_update_ends": per_update,
            "host_between_ms": between, "loader_threads_ms": loader["threads"][0],
            "loader_processes_ms": loader["processes"][0], "get_ms_per_sample": get_ms,
            "collate_ms_per_sample": collate_ms, "aug_digest": digest,
            "cv2_op_digests": op_digests,
            "cores": cores, "usable_cores": usable, "cv2": cv2.__version__,
            "val_map": result["map"], "val_map50": result["map50"], "val_s": val_s,
            "val_launches": val_launches, "detect_launches": detect_launches,
            "val_captured": val_calls[0], "phase_s": wall}


# ------------------------------------------- the render on the card (A7)

AUG_UPDATES = 4  # one-update epochs, none closed
RENDER_MAX_DIFF, RENDER_MAX_FRAC = 1, 0.001  # card vs CPU render: per byte, and share differing
HOST_BAD_FRAC, HOST_MEAN = 0.05, 1.0  # render vs cv2: share off by > 2, and mean |diff|


def render_digest_batch(dataset_cls, loader_cls, img_dir, lab_dir, cache_dir, cached=True):
    """The first plan batch of 8 that ``loader_cls`` makes with ``device_aug``
    over ``aug_digest``'s folder, at 640 px, seed 5, with the preset's
    augmentation: cache plans over the image cache, or (``cached`` False)
    pixel plans over the files. Either package's dataset and loader.
    Returns (batch, dataset)."""
    ds = dataset_cls(img_dir, lab_dir, input_size=(640, 640), enable_aug=True,
                     cache_images=cached, cache_dir=cache_dir)
    loader = loader_cls(ds, batch_size=8, max_labels=300, seed=DIGEST_SEED, use_processes=False,
                        device_aug=True, device_cache=cached)
    try:
        batch = next(loader)
    finally:
        loader.stop()
    return batch, ds


def render_plans(batch, dataset, device, cache=None):
    """``batch``'s plans rendered on ``device`` with the port's
    ``render_batch`` and ``dataset``'s knobs; cache plans read ``cache``
    (the dataset's image cache, uploaded here when not given)."""
    from yoloseries_tpu_torch.data.device_aug import render_batch, render_method, render_staged

    aug = dataset.aug
    plan = {k: torch.from_numpy(v).to(device) for k, v in batch["plan"].items()}
    tiles = torch.from_numpy(batch["tiles"]).to(device) if "tiles" in batch else None
    if tiles is None and cache is None:
        cache = torch.from_numpy(np.ascontiguousarray(dataset._cache)).to(device)
    return render_batch(tiles, plan, batch["dst_hw"], dataset.input_size, aug.fill_value,
                        aug.fill_value, render_method(aug), cache, render_staged(aug))


def render_bound_ms(batch):
    """The least time of a render on the card, by bytes: every tile pixel
    that a rect covers read once (both mixup layers), the plan's fields read
    once, the uint8 output written once, over the card's memory rate.
    Returns (ms, bytes)."""
    rects = batch["plan"]["rects"]
    covered = np.clip(rects[..., 2] - rects[..., 0], 0, None) * np.clip(
        rects[..., 3] - rects[..., 1], 0, None)
    n = len(batch["ann"])
    h, w = batch["dst_hw"]
    moved = (float(covered.sum()) * 3 + sum(v.nbytes for v in batch["plan"].values())
             + n * h * w * 3)
    return moved / HBM_BYTES_PER_S * 1e3, moved


def render_vs_cpu(batch, dataset, card_img):
    """The same plans rendered on the CPU: (bytes differing, largest
    |diff|, their share)."""
    cpu = render_plans(batch, dataset, torch.device("cpu")).numpy().astype(np.int16)
    diff = np.abs(card_img.cpu().numpy().astype(np.int16) - cpu)
    return int((diff > 0).sum()), int(diff.max()), float((diff > 0).mean())


def render_profile(render, card, top=6):
    """Device time of one render by kernel (torch.profiler): the launches,
    the busy time and the heaviest kernels. Returns [(ms, launches, name)]
    of the heaviest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  the render's kernels: the profiler recorded no device time (not measured)")
        return None
    log(f"  the render's kernels: {sum(r[1] for r in rows)} launches, {busy:.2f} ms of device "
        f"time [{card}]")
    for ms, n, name in rows[:top]:
        log(f"    {ms / busy * 100:5.1f}%  {ms:8.3f} ms  x{n:<4d} {name[:80]}")
    return [(ms, n, name[:80]) for ms, n, name in rows[:top]]


def phase_device_aug(card, recipe):
    """Augmentation rendered on the card: the digest batch (card against
    CPU, labels against the host pipeline, pixels against its cv2), the
    render at B=128 x 640 in both modes, the planning loader alone, the
    copies, and the ``Trainer`` with ``device_aug`` and ``device_cache``
    for 4 updates, then ``evaluate()`` through B1."""
    import hashlib
    import tempfile
    from pathlib import Path

    import cv2

    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.data import DataLoader, DetectionDataset, collate_batch
    from yoloseries_tpu_torch.data.device_aug import render_batch, render_method, repack_tiles
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m
    from yoloseries_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    counters = {"nms_greedy": g.nms_greedy, "nms_relation": m.nms_relation,
                "matrix_nms": m.matrix_nms, "matrix_nms_chunked": m.matrix_nms_chunked}
    batch = TRAIN_BATCH * TRAIN_ACCUMULATE
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        train_dirs = synthetic_folder(tmp / "train", batch, seed=2)  # phase 9's train set
        val_dirs = synthetic_folder(tmp / "val", TRAIN_BATCH, seed=3)
        digest_dirs = synthetic_folder(tmp / "digest", 8, seed=DIGEST_SEED)
        log(f"synthetic folder set: {batch} train, {TRAIN_BATCH} val and 8 digest PNGs in "
            f"{time.perf_counter() - t0:.1f} s")

        # the digest batch: card against CPU; then, over the files (the
        # cache scales boxes in f64, which the host warps and a plan first
        # rounds to f32, as in the JAX package), targets and pixels against
        # the host pipeline
        checks = {}
        for mode, cached in (("cache", True), ("tiles", False)):
            plans, ds = render_digest_batch(DetectionDataset, DataLoader, *digest_dirs[:2],
                                            tmp / "digest_cache", cached=cached)
            img = render_plans(plans, ds, torch.device("cuda"))
            torch.cuda.synchronize()
            if img.device.type != "cuda" or img.dtype != torch.uint8:
                fail(f"the render gave {img.dtype} on {img.device}")
            checks[mode] = (plans, ds, img, *render_vs_cpu(plans, ds, img))
        digest = hashlib.sha256(checks["cache"][2].cpu().numpy().tobytes()).hexdigest()
        plans, ds, img = checks["tiles"][:3]
        host_loader = DataLoader(ds, batch_size=8, max_labels=300, seed=DIGEST_SEED,
                                 use_processes=False)
        try:
            host = next(host_loader)
        finally:
            host_loader.stop()
        same_ann = host["ann"].tobytes() == plans["ann"].tobytes()
        diff = np.abs(img.cpu().numpy().astype(np.int16) - host["img"].astype(np.int16))
        bad, mean = float((diff > 2).mean()), float(diff.mean())
        log(f"rendered digest batch sha256 (8 x 640 px, preset augmentation, cache plans, seed "
            f"{DIGEST_SEED}, method {render_method(ds.aug)}): {digest}")
        for mode, (*_, n_diff, worst, frac) in checks.items():
            log(f"  {mode} plans, card against CPU: {n_diff} bytes differ (largest {worst}, "
                f"{frac * 100:.4f}%; limits {RENDER_MAX_DIFF} and {RENDER_MAX_FRAC * 100}%)")
        log(f"  pixel plans over the files against the host pipeline: ann equal {same_ann}; "
            f"against the host's cv2 {cv2.__version__}, {bad * 100:.3f}% of bytes off by > 2 "
            f"(limit {HOST_BAD_FRAC * 100}%), mean |diff| {mean:.4f} (limit {HOST_MEAN}) "
            f"[{card}]")
        for mode, (*_, n_diff, worst, frac) in checks.items():
            if worst > RENDER_MAX_DIFF or frac > RENDER_MAX_FRAC:
                fail(f"the {mode} render on the card disagrees with the CPU's")
        if not (same_ann and bad <= HOST_BAD_FRAC and mean < HOST_MEAN):
            fail("the rendered digest batch disagrees with the host pipeline")
        out.update(render_digest=digest, card_vs_cpu={k: v[3:] for k, v in checks.items()},
                   vs_host_bad_frac=bad, vs_host_mean=mean)
        del checks, plans, img

        hyp = {**recipe_hyp(), "total_epoch": AUG_UPDATES, "no_data_aug_epoch": 0,
               "device_aug": True, "device_cache": True, "save_ckpt_every": 1000}
        cfg = TrainConfig.from_hyp(hyp, num_class=80, model="yolov5s",
                                   output_dir=str(tmp / "run"))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, train_dirs[:2], val_dirs=val_dirs[:2], names_path=train_dirs[2],
                          log_fn=lambda *a: log("  trainer:", *a), device="cuda")
        init_s = time.perf_counter() - t0
        try:
            loader = trainer.train_loader
            if not (loader.device_aug and loader.device_cache and loader._proc_pool is not None):
                fail("the Trainer's loader makes no cache plans in worker processes")
            ds = trainer.train_dataset
            cache = trainer._dev_cache
            calib = collate_batch([trainer.val_dataset.get(i, np.random.default_rng(i))
                                   for i in range(8)], cfg.input_size, cfg.max_labels)["img"]
            calib = torch.from_numpy(calib).cuda().permute(0, 3, 1, 2).float() / 255
            model = trainer.state.model
            settle_bn(model, calib)
            widen_head(model.eval(), calib)
            trainer.state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ends, host_t = timed_updates(trainer)
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            with record_nms_inputs() as rec:
                t0 = time.perf_counter()
                result = trainer.evaluate()
                eval_s = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            bad_losses = [h for h in trainer.history
                          if not all(np.isfinite(v) for v in h.values())]
            if len(trainer.history) != AUG_UPDATES or bad_losses:
                fail(f"device aug: {len(trainer.history)} updates, non-finite {bad_losses}")
            mismatches, kept, live = greedy_mismatches(rec["nms_greedy"])
            per_update = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
            between = [(b[0] - a[1]) * 1e3 for a, b in zip(host_t, host_t[1:])]
            for i, h in enumerate(trainer.history):
                log(f"  update {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(h.items())))
            log(f"device aug: yolov5s 640 f32, B={TRAIN_BATCH} x {TRAIN_ACCUMULATE}, preset "
                f"augmentation rendered on the card from the image cache on the card, "
                f"{AUG_UPDATES} one-update epochs: Trainer built in {init_s:.1f} s, "
                f"{train_s:.1f} s for the updates; ms between update ends "
                f"{', '.join(f'{x:.1f}' for x in per_update)} (phase 9, host augmentation, "
                f"same run: {', '.join(f'{x:.1f}' for x in recipe['ms_between_update_ends'])}); "
                f"host ms between steps {', '.join(f'{x:.1f}' for x in between)} [{card}]")
            log(f"  evaluate() after them, {TRAIN_BATCH} val images: mAP {result['map']:.6f} in "
                f"{eval_s:.1f} s; launches {launches}; nms_greedy at its "
                f"{len(rec['nms_greedy'])} candidate sets: {live} live, {kept} kept, "
                f"{mismatches} mismatches [{card}]")
            if launches["nms_greedy"] == 0 or mismatches or kept == 0:
                fail("evaluate() after the device-aug updates: no B1 launch, no keeper or a "
                     "mismatch")

            # the planning loader alone: cache plans with processes and
            # threads (the same bytes), pixel plans with processes
            plan_ms = {}
            for name, kw in (("cache, processes", dict(use_processes=True, device_cache=True)),
                             ("cache, threads", dict(use_processes=False, device_cache=True)),
                             ("tiles, processes", dict(use_processes=True, device_cache=False,
                                                       digest=False))):
                plan_ms[name] = loader_alone_ms(ds, cfg, device_aug=True, **kw)
            if plan_ms["cache, processes"][2] != plan_ms["cache, threads"][2]:
                fail("the planning loader's processes and threads made different batches")
            log("  the planning loader alone, ms per batch of "
                f"{batch}: " + ", ".join(f"{k} {v[0]:.1f}" for k, v in plan_ms.items())
                + f" (phase 9's augmenting loader: processes {recipe['loader_processes_ms']:.1f},"
                f" threads {recipe['loader_threads_ms']:.1f}) [{card}]")

            # one batch of each mode: the copy, the render and its bound
            cache_batch = next(loader)
            loader.stop()
            tiles_loader = DataLoader(ds, batch_size=batch, max_labels=cfg.max_labels,
                                      seed=cfg.seed + 1, workers=cfg.num_workers,
                                      device_aug=True)
            try:
                tiles_batch = next(tiles_loader)
            finally:
                tiles_loader.stop()
            bound, moved = render_bound_ms(cache_batch)
            log(f"  the render's bound: {moved / 1e6:.1f} MB moved (covered tile pixels, plan "
                f"fields, the uint8 output) = {bound:.4f} ms at 3.35 TB/s [{card}]")
            renders = {}
            for mode, hb in (("cache", cache_batch), ("tiles", tiles_batch)):
                arrays = {**hb["plan"], "ann": hb["ann"]}
                if "tiles" in hb:
                    arrays["tiles"] = hb["tiles"]
                nbytes = sum(a.nbytes for a in arrays.values())
                call, landed = h2d_ms(lambda: trainer._to_device(arrays))
                dev = trainer._to_device(arrays)
                tiles = dev.pop("tiles", None)
                args = (hb["dst_hw"], ds.input_size, ds.aug.fill_value, ds.aug.fill_value,
                        render_method(ds.aug), cache if tiles is None else None, False)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                render_batch(tiles, dev, *args)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30
                ms = cuda_ms(lambda: render_batch(tiles, dev, *args), iters=5, warmup=1)
                renders[mode] = {"h2d_bytes": nbytes, "h2d_call_ms": call, "h2d_landed_ms": landed,
                                 "render_ms": ms, "peak_gib": peak}
                repacked = ", repack included" if mode == "cache" else ""
                log(f"  {mode} plans, B={batch} at 640: H2D {nbytes / 2**20:.2f} MiB, "
                    f"{call:.2f} ms to return, {landed:.2f} ms until landed; render "
                    f"{ms:.2f} ms (CUDA events, mean of 5{repacked}), {ms / bound:.0f}x its "
                    f"bound, peak {peak:.2f} GiB above its inputs [{card}]")
                if mode == "cache":
                    cache_render = (dev, *args)
            p = cache_batch["plan"]
            ids, off = (torch.from_numpy(p[k]).cuda() for k in ("img_ids", "tile_off"))
            repack = cuda_ms(lambda: repack_tiles(cache, ids, off), iters=5, warmup=1)
            log(f"  of the cache render, repack_tiles alone {repack:.2f} ms [{card}]")
            render_kernels = render_profile(lambda: render_batch(None, *cache_render), card)
            syncs = step_syncs(trainer, cache_batch, with_copy=True)
            log(f"  one update from a cache-plan batch (copy, render, step): {len(syncs)} host "
                f"syncs [{card}]")
            for where in syncs[:5]:
                log(f"    sync: {where}")
            if syncs:
                fail("the device-aug update makes the host wait for the card")
            profile = profile_update(trainer, card, cache_batch)
        finally:
            trainer.close()
    wall = time.perf_counter() - t_phase
    log(f"device-aug phase: {wall:.1f} s [{card}]")
    out.update(ms_between_update_ends=per_update, host_between_ms=between,
               recipe_ms_between_update_ends=recipe["ms_between_update_ends"],
               loss_first=trainer.history[0]["tot_loss"], loss_last=trainer.history[-1]["tot_loss"],
               map=result["map"], launches=launches, planning_loader_ms={
                   k: v[0] for k, v in plan_ms.items()},
               render=renders, render_bound_ms=bound, render_bound_bytes=moved,
               repack_ms=repack, render_kernels=render_kernels, syncs=len(syncs),
               profile=profile, phase_s=wall)
    return out




# ------------------------------------------- the YOLOv5 knobs (A1, A2)

SPECS = ("s", "m", "l", "x", "s_plain", "s_dw", "m_dw", "l_dw", "x_dw")
SERVING = dict(conf_threshold=0.25, cls_threshold=0.25, iou_threshold=0.45, num_candidates=512)
PROTOCOL = dict(conf_threshold=0.001, cls_threshold=0.001, iou_threshold=0.65,
                num_candidates=4096)
FOLD_TOL = 1e-3  # folded vs unfused raw maps: the BN's multiply moved into the kernel
FOLD_MATCH = S2D_MATCH = SOFT_MATCH = 0.99  # shares of detections / keepers matched
WBF_MATCH = 0.98
BF16_MATCH = 0.90
BF16_CONF_TOL, BF16_BOX_TOL = 0.02, 4.0  # bf16 vs f32 detections: conf, box px
# cli/detect.py --bf16 on phase 9's checkpoint, whose maps reach ~100: the
# f32 model with its kernels rounded to bf16 already errs by 16-34 bf16 ulps
# of each map's largest value, the folded bf16 model by 1.4-2.2x that, and
# --bf16 finds the object of 35-37% of the f32 detections
BF16_KERNEL_RATIO = 3.0  # folded bf16 map error / the bf16-rounded kernels' error, per stage
BF16_OBJECTS = 0.30  # share of f32 detections whose object (class, IoU >= 0.5) --bf16 finds
# remat's drift from f32 after all updates, against the drift of a second f32
# run of the same code (the control): at most this multiple of it
REMAT_DRIFT = 10.0
# folded vs unfused boxes on phase 9's trained checkpoint: its raw maps reach
# |v| ~ 100, where the fold's re-rounded weights move them by up to ~4e-3
# and a box corner by up to ~0.06 px at equal conf
DETECT_BOX_TOL = 0.1
SOFT_SCORE_TOL = 1e-5
SOFT_CPU_ROWS = 8  # soft-NMS card vs CPU on the first images of a batch
KNOB_UPDATES = 3  # per training knob: 1 untimed, then 2 timed
KNOB_HW = 640  # phase 11's input size; its batches:
KNOB_B = {"serving": 256, "small": 8, "protocol": 64, "tta": 2}


def knob_images(seed, b):
    return np.random.default_rng(seed).integers(0, 256, (b, KNOB_HW, KNOB_HW, 3), dtype=np.uint8)


def counters():
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    return {"nms_greedy": g.nms_greedy, "matrix_nms": m.matrix_nms,
            "matrix_nms_chunked": m.matrix_nms_chunked}


def zero_counters():
    for c in counters().values():
        c.launches = 0


def read_counters():
    return {k: c.launches for k, c in counters().items()}


def twin_mismatches(rec):
    """Every recorded NMS call (``record_nms_inputs``) against its kernel's
    plain twin, index for index: (mismatched slots, calls). The launches
    made here are taken off the counters again."""
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    twins = {"nms_greedy": g.greedy_nms, "matrix_nms": m.matrix_nms_plain,
             "matrix_nms_chunked": m.matrix_nms_chunked_plain}
    saved = read_counters()
    bad = calls = 0
    for name, recorded in rec.items():
        for boxes, scores, thr in recorded:
            got = counters()[name](boxes, scores, thr, MAX_KEEP)
            want = twins[name](boxes, scores, thr, MAX_KEEP)
            torch.cuda.synchronize()
            bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            calls += 1
    for k, c in counters().items():
        c.launches = saved[k]
    return bad, calls


def add_launches(total, path):
    for k, n in path.items():
        total[k] = total.get(k, 0) + n


def timed_calls(fn, n=3):
    """(first call's ms, best of ``n`` more, the last call's output), host
    clock around synchronized calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return first, best, out


def seeded_yolov5(name, calib):
    """``name`` at nc=80 from seed 0 on the card, its detect convs widened on
    ``calib`` as phase 4 does."""
    from yoloseries_tpu_torch.models import create_model

    model = create_model(name, num_class=80, device="cpu", seed=0).cuda()
    widen_head(model, calib)
    return model


def cpu_twin(model):
    import copy

    return copy.deepcopy(model).cpu()


def evaluator(model, cfg, device="cuda", name="yolov5s"):
    """An ``Evaluator`` with the decode, the fused selection and the eval
    overrides of ``name``'s family, at nc=80 and 640 px."""
    from yoloseries_tpu_torch.evaluation import Evaluator
    from yoloseries_tpu_torch.families import get_family

    fam = get_family(name)
    hw = (KNOB_HW, KNOB_HW)
    cfg = fam.apply_eval_overrides(cfg, {})
    return Evaluator(model, fam.make_decode({}, 80, hw), cfg, fam.make_select({}, 80, hw)(cfg),
                     device=device)


def EvalConfig(**kw):  # noqa: N802 (the port's EvalConfig, imported where it is called)
    from yoloseries_tpu_torch.evaluation import EvalConfig as config

    return config(**kw)


SPLIT_GROUPS = (  # (group, substrings of the device event name), first match wins
    ("NMS kernels", ("nms_kernel", "nms_relation_kernel", "nms_fixpoint_kernel")),
    ("H2D copy", ("Memcpy HtoD",)),
    ("convolution", ("conv", "fprop", "xmma", "implicit_gemm", "cudnn", "gemm")),
    ("BN affine and residual adds (mul, add)", ("MulFunctor", "AddFunctor", "CUDAFunctor_add")),
    ("SiLU", ("silu",)),
    ("sort / top-k", ("sort", "Sort", "radix", "topk")),
    ("other elementwise", ("elementwise", "reduce_kernel", "Reduce")),
)


def device_split(fn):
    """One call of ``fn`` under torch.profiler: (wall ms, busy ms, share by
    group); (wall ms, None, {}) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = sum(t for t, _ in events) / 1e3
    if busy == 0:
        return wall, None, {}
    groups = {g: 0.0 for g, _ in SPLIT_GROUPS} | {"other": 0.0}
    for t, name in events:
        groups[next((g for g, keys in SPLIT_GROUPS if any(k in name for k in keys)),
                    "other")] += t / 1e3
    return wall, busy, {g: t / busy for g, t in groups.items()}


def knob_specs(card, calib, tol):
    """Every spec at 640: raw maps card vs CPU at B=1, the protocol NMS of
    two images against its twin, protocol img/s at B=64 (B1), the first
    call apart. Returns the launches and yolov5s."""
    launches, keep = {}, None
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (1, 3, KNOB_HW, KNOB_HW), generator=gen).float() / 255
    img = knob_images(11, KNOB_B["protocol"])
    for size in SPECS:
        name = f"yolov5{size}"
        model = seeded_yolov5(name, calib)
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            ref = cpu_twin(model)(x)
            got = model(x.cuda())
        err = max(float((g_.cpu() - r).abs().max()) for g_, r in zip(got, ref))
        ev = evaluator(model, EvalConfig(**PROTOCOL))
        with record_nms_inputs() as rec:
            ev(img[:2])  # the candidates of two images, for the twins
        bad, calls = twin_mismatches(rec)
        torch.cuda.synchronize()
        zero_counters()
        first, best, _ = timed_calls(lambda: ev(img), n=2)
        path = read_counters()
        add_launches(launches, path)
        log(f"  {name}: {n_params} params; raw maps card vs CPU at B=1 max abs diff {err:.3e} "
            f"(tolerance {tol}); protocol B=64 {len(img) / best * 1e3:.1f} img/s ({best:.1f} "
            f"ms, best of 2), first call {first:.1f} ms; launches {path}; {calls} NMS calls "
            f"against the twins: {bad} mismatches [{card}]")
        if not err <= tol:
            fail(f"{name}: card and CPU raw maps disagree")
        if path["nms_greedy"] == 0 or bad:
            fail(f"{name}: the protocol config did not launch nms_greedy, or a twin mismatch")
        if size == "s":
            keep = model
        else:
            del model, ev
            torch.cuda.empty_cache()
    return launches, keep


def knob_fold(model, card):
    """yolov5s folded against unfused in one run: throughput, raw maps,
    detections, a profiler split of serving B=256."""
    import copy

    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn

    launches = {}
    folded = fold_conv_bn(copy.deepcopy(model).eval())
    gen = torch.Generator().manual_seed(12)
    x = (torch.randint(0, 256, (1, 3, KNOB_HW, KNOB_HW), generator=gen).float() / 255).cuda()
    with torch.no_grad():
        err = max(float((a - b).abs().max()) for a, b in zip(model(x), folded(x)))
    rng = np.random.default_rng(12)
    out = {"raw_err": err}
    for label, kw, b in (("serving B=256", SERVING, KNOB_B["serving"]),
                         ("serving B=8", SERVING, KNOB_B["small"]),
                         ("protocol B=64", PROTOCOL, KNOB_B["protocol"])):
        img = rng.integers(0, 256, (b, KNOB_HW, KNOB_HW, 3), dtype=np.uint8)
        evs = {"unfused": evaluator(model, EvalConfig(**kw)),
               "folded": evaluator(folded, EvalConfig(**kw))}
        res = {}
        for which in ("unfused", "folded", "folded", "unfused"):  # in turns
            with record_nms_inputs() as rec:
                zero_counters()
                _, best, dets = timed_calls(lambda: evs[which](img), n=1)
                if which == "folded":
                    add_launches(launches, read_counters())
            bad, calls = twin_mismatches(rec)
            if bad:
                fail(f"fold {label}: an NMS call disagrees with its twin")
            res[which] = (min(best, res.get(which, (float("inf"),))[0]), dets)
        share, total = matched_share(res["folded"][1], res["unfused"][1])
        out[label] = {k: b / v[0] * 1e3 for k, v in res.items()} | {"matched": share}
        log(f"  fold, {label}: unfused {b / res['unfused'][0] * 1e3:.1f} img/s "
            f"({res['unfused'][0]:.1f} ms), folded {b / res['folded'][0] * 1e3:.1f} img/s "
            f"({res['folded'][0]:.1f} ms); {share * 100:.2f}% of {total} detections matched "
            f"(conf 1e-4, box 1e-2 px; need >= {FOLD_MATCH * 100:.0f}%) [{card}]")
        if share < FOLD_MATCH:
            fail(f"fold {label}: folded detections disagree with the unfused ones")
    log(f"  fold: raw maps folded vs unfused at B=1 max abs diff {err:.3e} (tolerance {FOLD_TOL})")
    if not err <= FOLD_TOL:
        fail("fold: folded raw maps disagree with the unfused ones")
    img = rng.integers(0, 256, (KNOB_B["serving"], KNOB_HW, KNOB_HW, 3), dtype=np.uint8)
    for which, m_ in (("unfused", model), ("folded", folded)):
        ev = evaluator(m_, EvalConfig(**SERVING))
        wall, busy, split = device_split(lambda: ev(img))
        out[f"split_{which}"] = {"wall_ms": wall, "busy_ms": busy, **split}
        if busy is None:
            log(f"  {which} serving B=256: the profiler recorded no device time (not measured)")
            continue
        log(f"  {which} serving B=256, profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
            f"idle share {(1 - busy / wall) * 100:.1f}%; "
            + ", ".join(f"{g} {s * 100:.2f}%" for g, s in split.items()) + f" [{card}]")
    return launches, folded, out


def knob_s2d(model, card, tol):
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.nn.deploy import fold_stem_to_s2d

    s2d = create_model("yolov5s", num_class=80, device="cpu", s2d_stem=True)
    s2d.load_state_dict(fold_stem_to_s2d({k: v.cpu() for k, v in model.state_dict().items()}))
    s2d = s2d.cuda().eval()
    gen = torch.Generator().manual_seed(13)
    x = (torch.randint(0, 256, (1, 3, KNOB_HW, KNOB_HW), generator=gen).float() / 255).cuda()
    with torch.no_grad():
        err = max(float((a - b).abs().max()) for a, b in zip(model(x), s2d(x)))
    img = knob_images(13, KNOB_B["serving"])
    evs = {"6x6": evaluator(model, EvalConfig(**SERVING)),
           "s2d": evaluator(s2d, EvalConfig(**SERVING))}
    res, launches = {}, {}
    for which in ("6x6", "s2d", "s2d", "6x6"):
        with record_nms_inputs() as rec:
            zero_counters()
            _, best, dets = timed_calls(lambda: evs[which](img), n=1)
            if which == "s2d":
                add_launches(launches, read_counters())
        if twin_mismatches(rec)[0]:
            fail("s2d: an NMS call disagrees with its twin")
        res[which] = (min(best, res.get(which, (float("inf"),))[0]), dets)
    share, total = matched_share(res["s2d"][1], res["6x6"][1])
    b = len(img)
    log(f"  s2d stem (fold_stem_to_s2d weights): raw maps vs the 6x6 stem at B=1 max abs diff "
        f"{err:.3e} (tolerance {tol}); serving B=256 6x6 {b / res['6x6'][0] * 1e3:.1f} img/s, "
        f"s2d {b / res['s2d'][0] * 1e3:.1f} img/s; {share * 100:.2f}% of {total} detections "
        f"matched [{card}]")
    if not err <= tol or share < S2D_MATCH:
        fail("s2d: the s2d stem's maps or detections disagree with the 6x6 stem's")
    return launches, {"raw_err": err, "img_per_s_6x6": b / res["6x6"][0] * 1e3,
                      "img_per_s_s2d": b / res["s2d"][0] * 1e3, "matched": share}


def knob_bf16(model, card):
    from yoloseries_tpu_torch.models import create_model

    bf = create_model("yolov5s", num_class=80, device="cpu", dtype=torch.bfloat16)
    bf.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    bf = bf.cuda().eval()
    img = knob_images(14, KNOB_B["serving"])
    evs = {"f32": evaluator(model, EvalConfig(**SERVING)),
           "bf16": evaluator(bf, EvalConfig(**SERVING))}
    res, launches, calls = {}, {}, 0
    for which in ("f32", "bf16", "bf16", "f32"):
        with record_nms_inputs() as rec:
            zero_counters()
            _, best, dets = timed_calls(lambda: evs[which](img), n=1)
            if which == "bf16":
                add_launches(launches, read_counters())
        bad, n = twin_mismatches(rec)
        calls += n if which == "bf16" else 0
        if bad:
            fail(f"bf16 serving: an NMS call ({which}) disagrees with its twin")
        res[which] = (min(best, res.get(which, (float("inf"),))[0]), dets)
    share, total = matched_share(res["bf16"][1], res["f32"][1], BF16_CONF_TOL, BF16_BOX_TOL)
    b = len(img)
    log(f"  bf16 serving B=256: {b / res['bf16'][0] * 1e3:.1f} img/s against f32 "
        f"{b / res['f32'][0] * 1e3:.1f}; {share * 100:.2f}% of {total} f32 detections "
        f"matched (conf {BF16_CONF_TOL}, box {BF16_BOX_TOL} px; need >= {BF16_MATCH * 100:.0f}%)"
        f"; B1 launches {launches.get('nms_greedy', 0)}, {calls} calls held against the twin, "
        f"0 mismatches [{card}]")
    if share < BF16_MATCH or launches.get("nms_greedy", 0) == 0:
        fail("bf16 serving: too few f32 detections matched, or B1 not launched")
    return launches, {"img_per_s_bf16": b / res["bf16"][0] * 1e3,
                      "img_per_s_f32": b / res["f32"][0] * 1e3, "matched": share}


def knob_soft_nms(model, card):
    from yoloseries_tpu_torch.evaluation import yolov5_select_fn
    from yoloseries_tpu_torch.ops.nms import CLASS_OFFSET, soft_nms

    out = {}
    rng = np.random.default_rng(15)
    for label, kw, b in (("serving B=8", SERVING, KNOB_B["small"]),
                         ("protocol B=64", PROTOCOL, KNOB_B["protocol"])):
        cfg = EvalConfig(**kw)
        img = rng.integers(0, 256, (b, KNOB_HW, KNOB_HW, 3), dtype=np.uint8)
        x = torch.from_numpy(img).cuda().permute(0, 3, 1, 2).float() / 255
        with torch.no_grad():
            boxes, scores, cls = yolov5_select_fn(cfg)(model(x))
        boxes_off = (boxes + (cls * CLASS_OFFSET)[..., None]).contiguous()
        rows = slice(0, SOFT_CPU_ROWS)  # images are independent: the CPU takes the first
        for mode in ("linear", "exp"):
            args = (kw["iou_threshold"], MAX_KEEP)
            got = [t[rows].cpu() for t in soft_nms(boxes_off, scores, *args, mode=mode)]
            want = soft_nms(boxes_off[rows].cpu(), scores[rows].cpu(), *args, mode=mode)
            valid = want[1] | got[1]
            same = (got[0] == want[0]) & valid
            share = float(same.sum()) / max(int(valid.sum()), 1)
            score_err = float((got[2] - want[2]).abs()[same].max()) if same.any() else 0.0
            ms = cuda_ms(lambda: soft_nms(boxes_off, scores, *args, mode=mode), iters=3,
                         warmup=1)
            ev = evaluator(model, EvalConfig(**kw, nms_mode=f"soft_{mode}"))
            _, batch_ms, dets = timed_calls(lambda: ev(img), n=1)
            check_detections(dets, b)
            out[f"{label} {mode}"] = {"matched": share, "score_err": score_err, "ms": ms,
                                      "batch_ms": batch_ms}
            log(f"  soft-NMS {mode}, {label} (K={scores.shape[1]}): card vs CPU on images "
                f"0-{min(b, SOFT_CPU_ROWS) - 1}, {share * 100:.2f}% of {int(valid.sum())} keeper "
                f"slots equal, scores of the "
                f"equal slots within {score_err:.2e} (need >= {SOFT_MATCH * 100:.0f}% and "
                f"{SOFT_SCORE_TOL}); {ms:.2f} ms per call (CUDA events, {MAX_KEEP} steps), "
                f"the Evaluator's batch {batch_ms:.1f} ms [{card}]")
            if share < SOFT_MATCH or score_err > SOFT_SCORE_TOL:
                fail(f"soft-NMS {mode} {label}: card and CPU keepers disagree")
    return out


def knob_wbf(model, card):
    from yoloseries_tpu_torch.ops.wbf import weighted_boxes_fusion

    cfg = EvalConfig(**SERVING, use_tta=True, use_wbf=True)
    ev = evaluator(model, cfg)
    img = knob_images(16, KNOB_B["tta"])
    ev.detect_wbf(img)  # warm-up
    zero_counters()
    with record_nms_inputs() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ev.detect_wbf(img)
        total = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    bad, calls = twin_mismatches(rec)
    ref = evaluator(cpu_twin(model), cfg, device="cpu").detect_wbf(img)
    share, n = matched_share(got, ref)
    # the split: the branches on the card (one copy to the host), then the
    # fusion on the host, as detect_wbf does them
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        branches = torch.stack([ev._nms(b_) for b_ in
                                ev._branch_outputs(ev._prepare(img), tta=True)]).cpu().numpy()
        t1 = time.perf_counter()
        for i in range(branches.shape[1]):
            weighted_boxes_fusion([br[i][br[i][:, 4] > 0] for br in branches],
                                  iou_thr=cfg.wbf_iou_threshold)
        t2 = time.perf_counter()
    log(f"  WBF, serving TTA B=2: card vs CPU {share * 100:.2f}% of {n} fused detections "
        f"matched (need >= {WBF_MATCH * 100:.0f}%); {total:.1f} ms per batch: the branches on "
        f"the card and their copy {(t1 - t0) * 1e3:.1f} ms, the fusion on the host "
        f"{(t2 - t1) * 1e3:.1f} ms; launches {launches}, {calls} NMS calls against the twins: "
        f"{bad} mismatches [{card}]")
    if share < WBF_MATCH or bad or sum(launches.values()) == 0:
        fail("WBF: card and CPU disagree, a twin mismatch, or no NMS kernel launched")
    return launches, {"matched": share, "ms": total, "branches_ms": (t1 - t0) * 1e3,
                      "fusion_ms": (t2 - t1) * 1e3}


def knob_updates(trainer, host_batch):
    """``KNOB_UPDATES`` updates of ``trainer``'s step on one batch already on
    the card: ms per update (CUDA events over the last ones), peak memory,
    the losses, and the model's ``state_dict`` after the first update."""
    step = trainer._step_fn_for(tuple(trainer.cfg.input_size))
    batch = trainer._device_batch(host_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    trainer.state, metrics = step(trainer.state, batch)
    losses.append(metrics["tot_loss"])
    first = {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(KNOB_UPDATES - 1):
        trainer.state, metrics = step(trainer.state, batch)
        losses.append(metrics["tot_loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (KNOB_UPDATES - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return ms, peak, [float(v) for v in losses], first


@contextlib.contextmanager
def deterministic_kernels():
    """cuDNN's deterministic algorithms and torch's deterministic mode, which
    raises where an op has no deterministic implementation."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def knob_training(card, tmp):
    """The ``Trainer`` with each knob, timed on the default kernels; then
    remat's drift check, untimed, on deterministic kernels."""
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    train_dirs = synthetic_folder(tmp / "train", TRAIN_BATCH * TRAIN_ACCUMULATE, seed=0)
    hyp = train_hyp(1)
    host = None  # phase 8's batch: the first Trainer's loader makes it

    def run(label, extra, dtype, syncs_too):
        nonlocal host
        cfg = TrainConfig.from_hyp({**hyp, **extra}, num_class=80, model="yolov5s",
                                   output_dir=str(tmp / f"run_{label.replace(' ', '_')}"))
        trainer = Trainer(cfg, train_dirs[:2], names_path=train_dirs[2],
                          compute_dtype=dtype, log_fn=lambda *a: None, device="cuda")
        if host is None:
            host = next(trainer.train_loader)
        trainer.train_loader.stop()
        try:
            torch.cuda.empty_cache()
            ms, peak, losses, first = knob_updates(trainer, host)
            syncs = step_syncs(trainer, host) if syncs_too else []
        finally:
            trainer.close()
        return cfg, ms, peak, losses, first, trainer.state.model.state_dict(), syncs

    out = {}
    for label, extra, dtype in (("f32", {}, torch.float32), ("remat", {"remat": True}, None),
                                ("s2d_stem", {"s2d_stem": True}, None),
                                ("bf16", {}, torch.bfloat16)):
        cfg, ms, peak, losses, _, _, syncs = run(label, extra, dtype or torch.float32, True)
        out[label] = {"ms": ms, "peak_gib": peak, "losses": losses, "syncs": len(syncs)}
        log(f"  training {label}: {ms:.1f} ms per update (B={TRAIN_BATCH} x {TRAIN_ACCUMULATE} "
            f"at {cfg.input_size[0]}, CUDA events over updates 2-{KNOB_UPDATES}), peak "
            f"{peak:.2f} GiB, losses {', '.join(f'{v:.6f}' for v in losses)}, {len(syncs)} "
            f"host syncs in one update [{card}]")
        if syncs or not all(np.isfinite(losses)):
            fail(f"training {label}: host syncs {syncs[:3]} or a non-finite loss")
    # remat against no remat, the same batches from the same weights: the
    # parameters and BN buffers after one update and the losses of all
    # updates within TRAIN_TOL; after all updates, remat's drift from f32
    # against the control's, a second f32 run of the same code. On
    # deterministic kernels: with cuDNN's and the index backward's atomics
    # two f32 runs parted by 5.8e-05-1.1e-03 after four updates and remat by
    # 4.5e-04-1.05e-03, which failed this check once (one H100)
    firsts, states, losses = {}, {}, {}
    with deterministic_kernels():
        for label, extra in (("f32", {}), ("f32 control", {}), ("remat", {"remat": True})):
            _, _, _, losses[label], firsts[label], states[label], _ = run(
                f"{label} deterministic", extra, torch.float32, False)

    def worst(a, b):
        return max(float(((b[k].double() - v.double()).abs()
                          / v.double().abs().clamp_min(1.0)).max()) for k, v in a.items())

    one, last = worst(firsts["f32"], firsts["remat"]), worst(states["f32"], states["remat"])
    ctl_one = worst(firsts["f32"], firsts["f32 control"])
    ctl_last = worst(states["f32"], states["f32 control"])
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses["remat"], losses["f32"]))
    log(f"  remat vs no remat, deterministic kernels, untimed: losses within {loss_rel:.2e} "
        f"relative; parameters and BN buffers after one update within {one:.2e} x max(1, |p|) "
        f"(tolerance {TRAIN_TOL}), after all {KNOB_UPDATES} {last:.2e}; the f32 control "
        f"against f32: {ctl_one:.2e} after one, {ctl_last:.2e} after all (remat's may be "
        f"{REMAT_DRIFT:g}x); peak (default kernels) {out['remat']['peak_gib']:.2f} against "
        f"{out['f32']['peak_gib']:.2f} GiB [{card}]")
    if not (one <= TRAIN_TOL and loss_rel <= TRAIN_TOL):
        fail("remat changes the update")
    if not last <= max(TRAIN_TOL, REMAT_DRIFT * ctl_last):
        fail("remat drifts from f32 further than a second f32 run does")
    if not out["remat"]["peak_gib"] < out["f32"]["peak_gib"]:
        fail("remat does not lower the peak memory")
    out["remat_vs_plain"] = {"one_update": one, "all_updates": last, "loss_rel": loss_rel,
                             "control_one_update": ctl_one, "control_all_updates": ctl_last}
    return out


def knob_detect(card, recipe_dir):
    from yoloseries_tpu_torch.cli.detect import main as detect_main

    runs, launches, total_calls = {}, {}, 0
    for label, flags in (("folded", []), ("no-fuse", ["--no-fuse"]), ("bf16", ["--bf16"])):
        zero_counters()
        with record_nms_inputs() as rec:
            t0 = time.perf_counter()
            found = detect_main(["--ckpt-dir", str(recipe_dir / "ckpt"), "--img-dir",
                                 str(recipe_dir / "few"), "--num-class", "80", "--save-dir",
                                 str(recipe_dir / f"detect_{label}"), "--device", "cuda",
                                 *flags])
            wall = time.perf_counter() - t0
        path = read_counters()
        add_launches(launches, path)
        bad, calls = twin_mismatches(rec)
        total_calls += calls
        runs[label] = found
        log(f"  cli/detect.py {' '.join(flags) or '(default: folded)'} on phase 9's checkpoint: "
            f"{sum(len(v) for v in found.values())} boxes on {len(found)} images in {wall:.1f} s; "
            f"launches {path}; {calls} NMS calls against the twins: {bad} mismatches [{card}]")
        if bad or sum(path.values()) == 0:
            fail(f"cli/detect.py {label}: a twin mismatch or no NMS kernel launched")
    names = sorted(runs["no-fuse"])
    share, n = matched_share([runs["folded"][k] for k in names],
                             [runs["no-fuse"][k] for k in names], 1e-4, DETECT_BOX_TOL)
    tight, _ = matched_share([runs["folded"][k] for k in names],
                             [runs["no-fuse"][k] for k in names])
    raw_max, raw_err = checkpoint_fold_error(recipe_dir / "ckpt")
    bf_got, bf_ref = [runs["bf16"][k] for k in names], [runs["no-fuse"][k] for k in names]
    bf_share, _ = matched_share(bf_got, bf_ref, BF16_CONF_TOL, BF16_BOX_TOL)
    # why --bf16 matches few: the checkpoint's bf16 map error in ulps of
    # each map's largest value beside the error of bf16-rounded kernels
    # alone, the f32 detections' confs, and whether bf16 finds the same
    # objects (same class, IoU >= 0.5) with a conf moved past the tolerance
    ulps = checkpoint_bf16_ulps(recipe_dir / "ckpt")
    objects, dconf = object_share(bf_got, bf_ref)
    conf = np.concatenate([r[:, 4] for r in to_rows(bf_ref)])
    confs = np.percentile(conf, [0, 50, 100]) if conf.size else np.zeros(3)
    log(f"  cli/detect.py: folded vs --no-fuse {share * 100:.2f}% of {n} detections matched "
        f"(conf 1e-4, box {DETECT_BOX_TOL} px; need >= {FOLD_MATCH * 100:.0f}%), {tight * 100:.2f}% "
        f"at phase 5's 1e-2 px; the checkpoint's raw maps reach {raw_max:.1f} and move by "
        f"{raw_err:.3e} under the fold; --bf16 vs --no-fuse {bf_share * 100:.2f}% (conf "
        f"{BF16_CONF_TOL}, box {BF16_BOX_TOL} px) [{card}]")
    log(f"  cli/detect.py --bf16: the checkpoint's maps against f32 unfused, max error per "
        f"stage in bf16 ulps of the map's largest value ("
        + ", ".join(f"{m:.1f}" for m in ulps["max"]) + "): "
        + "; ".join(f"{k} " + ", ".join(f"{u:.1f}" for u in ulps[k])
                    for k in ("kernels", "bf16", "folded"))
        + f" (folded may be {BF16_KERNEL_RATIO:g}x kernels); the f32 detections' conf "
        f"min/median/max {confs[0]:.4f}/{confs[1]:.4f}/{confs[2]:.4f}; {objects * 100:.2f}% of "
        f"them have a bf16 detection of their class "
        f"at IoU >= 0.5 (need >= {BF16_OBJECTS * 100:.0f}%), their |conf change| median "
        f"{np.median(dconf) if dconf else 0:.4f}, 90th percentile "
        f"{np.percentile(dconf, 90) if dconf else 0:.4f}, max {max(dconf, default=0):.4f} "
        f"[{card}]")
    if share < FOLD_MATCH:
        fail("cli/detect.py: folded detections disagree with --no-fuse")
    if objects < BF16_OBJECTS:
        fail("cli/detect.py --bf16: too few of the f32 detections' objects found")
    if any(f > BF16_KERNEL_RATIO * k for f, k in zip(ulps["folded"], ulps["kernels"])):
        fail("cli/detect.py --bf16: the bf16 maps err far beyond the bf16 kernels' own rounding")
    return launches, {"matched_fold": share, "matched_fold_1e-2": tight,
                      "matched_bf16": bf_share, "detections": n, "raw_max": raw_max,
                      "raw_fold_err": raw_err, "bf16_ulps": ulps, "bf16_objects": objects,
                      "bf16_dconf_median": float(np.median(dconf)) if dconf else 0.0}


def object_share(got, ref, iou_min=0.5):
    """Share of the reference detections that ``got`` finds as an object: a
    detection of the same image and class at IoU >= ``iou_min`` (one for
    one, the best overlap first), and the |conf change| of each pair."""
    from yoloseries_tpu_torch.ops.metrics import pairwise_iou_np

    found = total = 0
    dconf = []
    for g, r in zip(to_rows(got), to_rows(ref)):
        g, r = g[g[:, 4] > 0], r[r[:, 4] > 0]
        total += len(r)
        if not len(g) or not len(r):
            continue
        iou = pairwise_iou_np(r[:, :4].astype(np.float64), g[:, :4].astype(np.float64))
        iou[r[:, 5][:, None] != g[:, 5][None, :]] = 0.0
        free = np.ones(len(g), bool)
        for i in np.argsort(-iou.max(axis=1), kind="stable"):
            j = int(np.argmax(np.where(free, iou[i], -1.0)))
            if free[j] and iou[i, j] >= iou_min:
                found += 1
                free[j] = False
                dconf.append(float(abs(g[j, 4] - r[i, 4])))
    return found / max(total, 1), dconf


def checkpoint_bf16_ulps(ckpt_dir):
    """Per stage, the max |error| against a checkpoint's unfused f32 raw maps
    in bf16 ulps of the f32 map's largest value, of: the f32 model with its
    conv kernels rounded to bf16 ("kernels"), the bf16 model ("bf16") and
    the folded bf16 model, which ``cli/detect.py --bf16`` runs ("folded");
    and that largest value. Two seeded images."""
    import copy

    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn
    from yoloseries_tpu_torch.train import restore_weights

    model = create_model("yolov5s", num_class=80, device="cpu")
    restore_weights(model, ckpt_dir)
    model = model.cuda().eval()
    rounded = copy.deepcopy(model)
    with torch.no_grad():
        for m in rounded.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(m.weight.bfloat16().float())
    bf = create_model("yolov5s", num_class=80, device="cpu", dtype=torch.bfloat16)
    bf.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    bf = bf.cuda().eval()
    variants = {"kernels": rounded, "bf16": bf, "folded": fold_conv_bn(copy.deepcopy(bf))}
    gen = torch.Generator().manual_seed(17)
    x = torch.rand(2, 3, KNOB_HW, KNOB_HW, generator=gen).cuda()
    with torch.no_grad():
        ref = model(x)
        tops = [float(a.abs().max()) for a in ref]
        ulps = [2.0 ** (np.floor(np.log2(t)) - 7) for t in tops]
        out = {name: [float((b.float() - a).abs().max()) / u
                      for a, b, u in zip(ref, m(x), ulps)] for name, m in variants.items()}
    out["max"] = tops
    return out


def checkpoint_fold_error(ckpt_dir):
    """max |raw map| of a checkpoint's EMA weights on two seeded images, and
    how far the fold moves the maps."""
    import copy

    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn
    from yoloseries_tpu_torch.train import restore_weights

    model = create_model("yolov5s", num_class=80, device="cpu")
    restore_weights(model, ckpt_dir)
    model = model.cuda().eval()
    folded = fold_conv_bn(copy.deepcopy(model))
    gen = torch.Generator().manual_seed(17)
    x = torch.rand(2, 3, KNOB_HW, KNOB_HW, generator=gen).cuda()
    with torch.no_grad():
        pairs = list(zip(model(x), folded(x)))
    return (max(float(a.abs().max()) for a, _ in pairs),
            max(float((a - b).abs().max()) for a, b in pairs))


def phase_knobs(card, recipe_dir):
    """Phase 11: every YOLOv5 spec, the fold, the s2d stem, bf16, soft-NMS,
    WBF, the training knobs and ``cli/detect.py``'s flags."""
    import tempfile
    from pathlib import Path

    t_phase = time.perf_counter()
    launches, out, seconds = {}, {}, {}
    gen = torch.Generator().manual_seed(0)
    calib = (torch.randint(0, 256, (2, 3, KNOB_HW // 2, KNOB_HW // 2), generator=gen).float()
             / 255).cuda()

    def part(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    path, model = part("specs", knob_specs, card, calib, MODEL_TOL)
    add_launches(launches, path)
    path, _, out["fold"] = part("fold", knob_fold, model, card)
    add_launches(launches, path)
    path, out["s2d"] = part("s2d", knob_s2d, model, card, MODEL_TOL)
    add_launches(launches, path)
    path, out["bf16"] = part("bf16", knob_bf16, model, card)
    add_launches(launches, path)
    out["soft_nms"] = part("soft-NMS", knob_soft_nms, model, card)
    path, out["wbf"] = part("WBF", knob_wbf, model, card)
    add_launches(launches, path)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["training"] = part("training", knob_training, card, Path(tmp))
    torch.cuda.empty_cache()
    path, out["detect"] = part("detect", knob_detect, card, recipe_dir)
    add_launches(launches, path)
    wall = time.perf_counter() - t_phase
    log(f"knobs phase: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"); launches {launches} [{card}]")
    out.update(launches=launches, seconds=seconds, phase_s=wall)
    return out


# ----------------------------------- phase 12: the anchor-free families

AF_MODELS = ("yolox_s", "yolox_m", "yolox_l", "yolox_darknet21", "yolox_darknet53",
             "yolov8", "yolov8n", "yolov8s", "yolov8m")
AF_SERVED = ("yolox_s", "yolov8")  # served, trained and validated
AF_PRESETS = {"yolox_s": "train_yolox.yaml", "yolov8": "train_yolov8.yaml",
              "yolov7": "train_yolov7.yaml", "retinanet": "train_retinanet.yaml",
              "fcos": "train_fcos.yaml"}
# each preset's batch_size x accumulate (accumulate_loss_step / batch_size)
PRESET_BATCH = {"yolox_s": (4, 2), "yolov8": (2, 2), "yolov7": (4, 2), "retinanet": (48, 1),
                "fcos": (64, 1)}
AF_UPDATES = 6  # one-update epochs of the presets' batch
AF_VAL_B = 64
AF_STEP_UPDATES = 3  # the step alone at 128 images an update: 1 untimed, then these
# the step alone: phase 8's B=64 x 2 for YOLOX; YOLOv8's micro-batch of 64
# peaks at ~76 of the card's 79 GiB and ran out of memory in one of two
# runs, so it takes the same 128 images as 32 x 4
AF_STEP_BATCH = {"yolox_s": (64, 2), "yolov8": (32, 4), "yolov7": (32, 4), "retinanet": (32, 4),
                 "fcos": (32, 4)}
AF_KERNELS = {"nms_greedy": "yoloseries_tpu/kernels/nms_pallas.py:115",
              "matrix_nms": "yoloseries_tpu/kernels/nms_matrix.py:151",
              "matrix_nms_chunked": "yoloseries_tpu/kernels/nms_matrix.py:194"}
AF_GROUPS = (  # (part, record_function ranges), the profiler's device time with children
    ("model forward", ("train.forward",)),
    ("loss forward (assigner included)", ("train.loss",)),
    ("  of it the assigner", ("yolox_loss.assign", "yolov8_loss.assign", "yolov7_loss.assign",
                              "retinanet_loss.assign", "fcos_loss.assign")),
    ("optimizer", ("train.optimizer",)),
    ("EMA", ("train.ema",)),
)  # the backward runs on autograd's thread, outside the ranges: the rest of the busy time


def output_convs(model):
    """(conv, map index, channel slice, std, bias) of every output conv of a
    YOLOX or YOLOv8 model (A = 1): the raw-map std and the bias that
    ``widen_anchor_free`` gives it."""
    det = model.detect
    if hasattr(det, "pred_small"):
        heads = (det.pred_small, det.pred_middle, det.pred_large)
        box = (0.0, 0.0, math.log(4.0), math.log(4.0))
        return [item for i, h in enumerate(heads)
                for item in ((h.reg, i, slice(0, 4), 0.5, box), (h.cof, i, slice(4, 5), 1.5, 0.0),
                             (h.cls[-1], i, slice(5, None), 1.5, 0.0))]
    out = []
    for i, scale in enumerate(("xsmall", "small", "mid", "large")):
        box = getattr(det, f"detect_{scale}_bbox")[2]
        out += [(box, i, slice(0, box.out_channels), 1.5, 0.0),
                (getattr(det, f"detect_{scale}_cls")[2], i, slice(box.out_channels, None), 1.5,
                 0.0)]
    return out


def widen_anchor_free(model, img):
    """Random weights put every score at the prior (YOLOX ~0.005, YOLOv8
    ~1e-6) and YOLOX's boxes at ~0.1 px: scale each output conv's weight so
    that its channels have std 1.5 on ``img``, as phase 4 does for YOLOv5's
    detect convs, with bias 0; YOLOX's box conv gets std 0.5 and log 4 on w
    and h instead, boxes near their cell and about 4 strides wide, as
    phase 4's anchors make YOLOv5's (with std 1.5 there, wh = exp(p) spreads
    over 20x and the merge finds almost no supporter)."""
    convs = output_convs(model)
    with torch.no_grad():
        for conv, *_ in convs:
            conv.bias.zero_()
        maps = model(img)
        for conv, i, sl, std, bias in convs:
            conv.weight.mul_(std / maps[i][:, sl].float().std())
            conv.bias.copy_(torch.as_tensor(bias, dtype=conv.bias.dtype))


def af_models(card, calib):
    """Every new name at 640, nc=80, seeded, output convs widened: raw maps
    card vs CPU at B=1, the protocol NMS of two images against its twin,
    protocol img/s at B=64 (B1), the first call apart. Returns the launches
    and the served models."""
    from yoloseries_tpu_torch.models import create_model

    launches, keep, out = {}, {}, {}
    gen = torch.Generator().manual_seed(21)
    x = torch.randint(0, 256, (1, 3, KNOB_HW, KNOB_HW), generator=gen).float() / 255
    img = knob_images(21, KNOB_B["protocol"])
    for name in AF_MODELS:
        model = create_model(name, num_class=80, device="cpu", seed=0).cuda()
        widen_anchor_free(model, calib)
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            ref = cpu_twin(model)(x)
            got = model(x.cuda())
        err = max(float((g_.cpu() - r).abs().max()) for g_, r in zip(got, ref))
        ev = evaluator(model, EvalConfig(**PROTOCOL), name=name)
        with record_nms_inputs() as rec:
            ev(img[:2])
        bad, calls = twin_mismatches(rec)
        torch.cuda.synchronize()
        zero_counters()
        first, best, _ = timed_calls(lambda: ev(img), n=2)
        path = read_counters()
        add_launches(launches, path)
        out[name] = {"params": n_params, "raw_err": err, "img_per_s": len(img) / best * 1e3,
                     "first_ms": first}
        log(f"  {name}: {n_params} params; raw maps card vs CPU at B=1 max abs diff {err:.3e} "
            f"(tolerance {MODEL_TOL}); protocol B=64 {len(img) / best * 1e3:.1f} img/s "
            f"({best:.1f} ms, best of 2), first call {first:.1f} ms; launches {path}; {calls} "
            f"NMS calls against the twins: {bad} mismatches [{card}]")
        if not err <= MODEL_TOL:
            fail(f"{name}: card and CPU raw maps disagree")
        if path["nms_greedy"] == 0 or bad:
            fail(f"{name}: the protocol config did not launch nms_greedy, or a twin mismatch")
        if name in AF_SERVED:
            keep[name] = model
        else:
            del model, ev
            torch.cuda.empty_cache()
    return launches, keep, out


def kernel_at(name, captured, where, launches, card):
    """One kernel at a path's candidates: CUDA-event and profiler device
    time beside the plain twin, the bound and the dependent chain, as in
    phase 6; the launches made here are taken off the counters."""
    from yoloseries_tpu_torch.kernels import nms_greedy as g
    from yoloseries_tpu_torch.kernels import nms_matrix as m

    kernel, twin = {"nms_greedy": (g.nms_greedy, g.greedy_nms),
                    "matrix_nms": (m.matrix_nms, m.matrix_nms_plain),
                    "matrix_nms_chunked": (m.matrix_nms_chunked,
                                           m.matrix_nms_chunked_plain)}[name]
    boxes, scores, thr = captured
    saved = read_counters()
    ki, kv = kernel(boxes, scores, thr, MAX_KEEP)
    ms = cuda_ms(lambda: kernel(boxes, scores, thr, MAX_KEEP), iters=20)
    device_ms, _ = profiled_ms(lambda: kernel(boxes, scores, thr, MAX_KEEP))
    plain = cuda_ms(lambda: twin(boxes, scores, thr, MAX_KEEP), iters=3, warmup=1)
    for k, c in counters().items():
        c.launches = saved[k]
    b, k = scores.shape
    keepers = kv.sum(dim=1)
    strips = None
    if name == "nms_greedy":
        ious = greedy_ious(scores, ki, kv)
    elif name == "matrix_nms":
        ious = int(keepers.sum()) * k
    else:
        strips = strip_inputs(boxes, scores, thr)
        ious = int(keepers.sum()) * len(strips) * 1024
    bound, by = bound_ms(boxes, ious)
    steps, probe = chain_steps(name, boxes, scores, thr, keepers, strips)
    chain = steps * step_us(probe) * 1e-3
    live = int((scores > 0).sum())
    log(f"  {name} [{where}] B={b} K={k}: kernel {ms:.4f} ms (CUDA events), device time "
        f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'} (profiler), plain "
        f"twin {plain:.3f} ms, bound {bound:.6f} ms ({by}), chain {chain:.6f} ms, {live} live "
        f"candidates, {int(keepers.sum())} kept, launches on the path {launches} [{card}]")
    return {"shape": f"{where} B={b} K={k} thr={thr}", "launches": launches, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "chain_ms": chain, "live": live}


def v8_branch_grid_check(ev, img):
    """Every YOLOv8 TTA branch's dense boxes against the branch maps' own
    grid: each box holds its cell's centre (DFL distances are 1..16 bins),
    read from the maps' (h, w) and the strides here, not from the decode."""
    from yoloseries_tpu_torch.evaluation.yolov8 import decode_yolov8

    worst = np.inf
    with torch.inference_mode():
        for x, s, _ in ev._branches(ev._prepare(img), True):
            maps = ev.model(x)
            rows = decode_yolov8(maps, 80)
            cx, cy = [], []
            for mp, stride in zip(maps, (4, 8, 16, 32)):
                h, w = mp.shape[2:]
                ys, xs = torch.meshgrid(torch.arange(h, device=mp.device),
                                        torch.arange(w, device=mp.device), indexing="ij")
                cx.append(((xs + 0.5) * stride).reshape(-1))
                cy.append(((ys + 0.5) * stride).reshape(-1))
            cx, cy = torch.cat(cx), torch.cat(cy)
            half = rows[..., 2:4] * 0.5
            margin = torch.minimum(torch.minimum(cx - (rows[..., 0] - half[..., 0]),
                                                 (rows[..., 0] + half[..., 0]) - cx),
                                   torch.minimum(cy - (rows[..., 1] - half[..., 1]),
                                                 (rows[..., 1] + half[..., 1]) - cy))
            worst = min(worst, float(margin.min()))
    return worst


def af_serving(model, name, card):
    """The family's serving paths through the ``Evaluator``: serving B=256
    and B=8, protocol B=64, protocol TTA B=2. Each path's counters are
    zeroed before it and must have grown; every NMS call is held against
    its twin; each kernel is timed at the path's candidates."""
    paths = [("serving B=256", SERVING, 256, "nms_greedy", False),
             ("serving B=8", SERVING, 8, "matrix_nms", False),
             ("protocol B=64", PROTOCOL, 64, "nms_greedy", False),
             ("protocol TTA B=2", PROTOCOL, 2, "matrix_nms_chunked", True)]
    rng = np.random.default_rng(22)
    launches, rows, out = {}, {}, {}
    for label, kw, b, kernel, tta in paths:
        ev = evaluator(model, EvalConfig(**kw, use_tta=tta), name=name)
        img = rng.integers(0, 256, (b, KNOB_HW, KNOB_HW, 3), dtype=np.uint8)
        ev(img)  # warm-up
        torch.cuda.synchronize()
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        _, best, dets = timed_calls(lambda: ev(img), n=3)
        path = read_counters()
        if path[kernel] == 0:
            fail(f"{name} {label}: {kernel} was not launched ({path})")
        add_launches(launches, path)
        check_detections(dets, b)
        with record_nms_inputs() as rec:
            ev(img)
        bad, calls = twin_mismatches(rec)
        if bad:
            fail(f"{name} {label}: a kernel disagrees with its twin")
        out[label] = {"img_per_s": b / best * 1e3, "ms": best, "launches": path,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "detections": int((dets[..., 4] > 0).sum())}
        log(f"  {name} {label}: {b / best * 1e3:.1f} img/s (best of 3, {best:.1f} ms/batch), "
            f"peak {out[label]['peak_gib']:.2f} GiB, {out[label]['detections']} detections, "
            f"launches {path}; {calls} NMS calls against the twins: {bad} mismatches [{card}]")
        rows[f"{name} {label}"] = (kernel, kernel_at(kernel, rec[kernel][0], f"{name} {label}",
                                                     path[kernel], card))
        if tta and name.startswith("yolov8"):
            margin = v8_branch_grid_check(ev, img)
            out[label]["grid_margin_px"] = margin
            log(f"  {name} {label}: every branch's dense box holds its cell's centre on the "
                f"branch maps' own grid, least margin {margin:.3f} px (must be > 0) [{card}]")
            if not margin > 0:
                fail(f"{name}: a TTA branch's boxes are off the branch's grid")
    return launches, rows, out


def af_hyp(name, batch, accumulate, updates):
    """The family's preset (``configs/presets/``) for a run of ``updates``
    one-update epochs at ``batch`` x ``accumulate``, augmentation closed;
    the preset's TTA is off in ``evaluate()``, so that its mAP pass is B1's
    (the TTA path is timed in the serving paths)."""
    import yoloseries_tpu_torch
    from yoloseries_tpu_torch.configs import load_hyp

    presets = Path(yoloseries_tpu_torch.__file__).parent / "configs" / "presets"
    hyp = load_hyp(presets / AF_PRESETS[name])
    hyp.update(batch_size=batch, accumulate_loss_step=batch * accumulate, total_epoch=updates,
               no_data_aug_epoch=updates, save_ckpt_every=2, use_tta=False, num_workers=8,
               save_log_txt=False)
    return hyp


def af_step_split(trainer, step, batch, card, micro, acc):
    """Device time of one update by part (torch.profiler ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = step(trainer.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(t for t, _ in _device_events(prof)) / 1e3
    if busy == 0:
        log("  update profile: the profiler recorded no device time (not measured)")
        return None
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    split = {part: sum(e.device_time_total for e in events if e.name in names) / 1e3
             for part, names in AF_GROUPS}
    split["backward (model and loss) and the rest"] = busy - sum(
        v for k, v in split.items() if not k.startswith("  "))
    log(f"  one update at B={micro} x {acc}, profiled: wall {wall:.1f} ms, "
        f"device busy {busy:.1f} ms: " + ", ".join(
            f"{k.strip()} {v:.1f} ms ({v / busy * 100:.1f}%)" for k, v in split.items())
        + f" [{card}]")
    return {"wall_ms": wall, "busy_ms": busy, **split}


def af_training(name, card, tmp, val_dirs, updates=AF_UPDATES):
    """The ``Trainer`` with the family's preset: ``updates`` one-update
    epochs at the preset's batch, warmup active, then ``evaluate()`` over 2
    val batches of 64 (B1, held against its twin); then the step alone at
    128 images an update (``AF_STEP_BATCH``) with its peak, syncs and split.
    Returns the launches,
    the result, the checkpoint dir and the B1 candidates."""
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.data import DataLoader, DetectionDataset, collate_batch
    from yoloseries_tpu_torch.train import Trainer, make_train_step

    batch, acc = PRESET_BATCH[name]
    train_dirs = synthetic_folder(tmp / "train", batch * acc, seed=30)
    cfg = TrainConfig.from_hyp(af_hyp(name, batch, acc, updates), num_class=80, model=name,
                               output_dir=str(tmp / "run"))
    trainer = Trainer(cfg, train_dirs[:2], val_dirs=val_dirs[:2], names_path=train_dirs[2],
                      log_fn=lambda *a: log("  trainer:", *a), device="cuda")
    out = {}
    try:
        calib = collate_batch([trainer.val_dataset.get(i, np.random.default_rng(i))
                               for i in range(8)], cfg.input_size, cfg.max_labels)["img"]
        calib = torch.from_numpy(calib).cuda().permute(0, 3, 1, 2).float() / 255
        model = trainer.state.model
        settle_bn(model, calib)
        (widen_anchor_free if name in AF_SERVED else widen_outputs)(model.eval(), calib)
        trainer.state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ends, _ = timed_updates(trainer)
        timed = trainer._step_fns[tuple(cfg.input_size)]

        def step_peak(state, batch):  # the peak of updates 3.. (1-2: cuDNN's autotuning)
            if len(ends) == 2:
                torch.cuda.reset_peak_memory_stats()
            return timed(state, batch)

        trainer._step_fns[tuple(cfg.input_size)] = step_peak
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer._val_loader = DataLoader(trainer.val_dataset, batch_size=AF_VAL_B,
                                         max_labels=cfg.max_labels, workers=cfg.num_workers,
                                         shuffle=False, infinite=False, enable_aug=False)
        with record_nms_inputs() as rec:
            t0 = time.perf_counter()
            result = trainer.evaluate(max_batches=2)
            eval_s = time.perf_counter() - t0
        launches = read_counters()
        mismatches, kept, live = greedy_mismatches(rec["nms_greedy"])
        per_update = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        ms = float(np.median(per_update[1:]))
        for i, h in enumerate(trainer.history):
            log(f"  update {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(h.items())))
        bad = [h for h in trainer.history if not all(np.isfinite(v) for v in h.values())]
        if len(trainer.history) != updates or bad:
            fail(f"{name} training: {len(trainer.history)} updates, non-finite losses {bad}")
        host_batch = next(trainer.train_loader)
        trainer.train_loader.stop()
        syncs = step_syncs(trainer, host_batch)
        log(f"{name} trained with its preset, B={batch} x {acc} at 640, f32: {ms:.1f} ms per "
            f"update (median of updates 3-{updates}, CUDA events between update ends), "
            f"peak {peak:.2f} GiB (updates 3-{updates}), {updates} updates in "
            f"{train_s:.1f} s, {len(syncs)} host syncs in one update; evaluate() on the EMA "
            f"weights, 2 batches of {AF_VAL_B}: mAP {result['map']:.6f} in {eval_s:.1f} s; "
            f"launches {launches}; nms_greedy at {len(rec['nms_greedy'])} candidate sets: "
            f"{live} live, {kept} kept, {mismatches} mismatches [{card}]")
        for where in syncs[:5]:
            log(f"    sync: {where}")
        if syncs:
            fail(f"{name} training: host syncs in one update")
        if launches["nms_greedy"] == 0 or mismatches or kept == 0:
            fail(f"{name} evaluate(): B1 not launched, a twin mismatch or nothing kept")
        out.update(ms_per_update=ms, peak_gib=peak, syncs=len(syncs), map=result["map"],
                   map50=result["map50"], eval_s=eval_s,
                   loss_first=trainer.history[0]["tot_loss"],
                   loss_last=trainer.history[-1]["tot_loss"])

        # the step alone at 128 images an update, on the card already
        micro, step_acc = AF_STEP_BATCH[name]
        big = DataLoader(DetectionDataset(*val_dirs[:2], names_path=val_dirs[2],
                                          input_size=cfg.input_size),
                         batch_size=micro * step_acc, max_labels=cfg.max_labels,
                         shuffle=False, infinite=False, enable_aug=False)
        host_big = next(big)
        big.stop()
        step = make_train_step(trainer.family.make_loss(cfg.hyp, 80, cfg.input_size)[0],
                               accumulate=step_acc)
        dev_batch = trainer._device_batch(host_big)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer.state, _ = step(trainer.state, dev_batch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(AF_STEP_UPDATES):
            trainer.state, metrics = step(trainer.state, dev_batch)
        end.record()
        torch.cuda.synchronize()
        alone = start.elapsed_time(end) / AF_STEP_UPDATES
        big_peak = torch.cuda.max_memory_allocated() / 2**30
        trainer._step_fns[tuple(cfg.input_size)] = step
        torch.cuda.empty_cache()
        big_syncs = step_syncs(trainer, host_big)
        log(f"  {name}: the step alone at B={micro} x {step_acc}, 640, f32: "
            f"{alone:.1f} ms per update ({micro * step_acc / alone * 1e3:.1f} "
            f"img/s; CUDA events over {AF_STEP_UPDATES} updates after one), peak "
            f"{big_peak:.2f} GiB, {len(big_syncs)} host syncs, tot_loss "
            f"{float(metrics['tot_loss']):.6g} [{card}]")
        for where in big_syncs[:5]:
            log(f"    sync: {where}")
        split = af_step_split(trainer, step, dev_batch, card, micro, step_acc)
        out.update(step_alone_ms=alone, step_peak_gib=big_peak, step_syncs=len(big_syncs),
                   split=split)
    finally:
        trainer.close()
    return launches, out, trainer.ckpt_dir, rec["nms_greedy"][0]


def af_card_vs_cpu(name, card, hyp=None):
    """One update at 256 px, B=4 x accumulate 2, warmup active, on the card
    and on the CPU from the same weights and batch, the loss built from
    ``hyp``."""
    from yoloseries_tpu_torch.families import get_family
    from yoloseries_tpu_torch.models import create_model
    from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    ann = np.full((8, 32, 6), -1.0, np.float32)
    for b in range(8):
        n = int(rng.integers(1, 12))
        xy = rng.uniform(0, 200, (n, 2))
        ann[b, :n, :2] = xy
        ann[b, :n, 2:4] = np.minimum(xy + rng.uniform(8, 120, (n, 2)), 256)
        ann[b, :n, 4] = rng.integers(0, 80, n)
        ann[b, :n, 5] = b
    sd = create_model(name, num_class=80, device="cpu", seed=1).state_dict()
    loss_fn, bal = get_family(name).make_loss(hyp or {}, 80, (256, 256))
    cfg = OptimizerConfig(batch_size=4, steps_per_epoch=1, warmup_steps_override=100)
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(create_model(name, 80, device="cpu"), cfg, balances=bal,
                                   state_dict=sd, device=dev)
        state, metrics = make_train_step(loss_fn, accumulate=2)(
            state, {"img": torch.from_numpy(img).to(dev), "ann": torch.from_numpy(ann).to(dev)})
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: p.detach().cpu() for k, p in state.model.named_parameters()})
    loss_gpu, loss_cpu = out["cuda"][0]["tot_loss"], out["cpu"][0]["tot_loss"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst = max(float(((out["cuda"][1][k] - p).abs() / p.abs().clamp_min(1.0)).max())
                for k, p in out["cpu"][1].items())
    log(f"  {name}: card vs CPU, one update at 256 px, B=4 x 2: tot_loss "
        f"{out['cuda'][0]['tot_loss']:.6f} vs {out['cpu'][0]['tot_loss']:.6f} (relative "
        f"{rel:.2e}), foreground {out['cuda'][0].get('fg_nums', out['cuda'][0]['tar_nums']):g} "
        f"vs {out['cpu'][0].get('fg_nums', out['cpu'][0]['tar_nums']):g}, largest parameter "
        f"difference {worst:.2e} x max(1, |p|) (tolerance {TRAIN_TOL}) [{card}]")
    if not (rel <= TRAIN_TOL and worst <= TRAIN_TOL):
        fail(f"{name}: one update on the card disagrees with the CPU")
    return {"loss_rel": rel, "param_rel": worst}


def af_entry_points(name, ckpt_dir, val_dirs, tmp, card):
    """``cli/val.py`` (B1 at B=16, K=4096, held against its twin) and
    ``cli/detect.py --ckpt-dir`` folded and ``--no-fuse`` on the checkpoint
    phase 12's training wrote."""
    from yoloseries_tpu_torch.cli.detect import main as detect_main
    from yoloseries_tpu_torch.cli.val import main as val_main

    launches = {}
    zero_counters()
    with record_nms_inputs() as rec:
        t0 = time.perf_counter()
        result = val_main(["--model", name, "--ckpt-dir", str(ckpt_dir), "--val-img-dir",
                           str(val_dirs[0]), "--val-lab-dir", str(val_dirs[1]), "--name-path",
                           str(val_dirs[2]), "--device", "cuda"])
        val_s = time.perf_counter() - t0
    path = read_counters()
    add_launches(launches, path)
    bad, kept, live = greedy_mismatches(rec["nms_greedy"])
    log(f"  {name} cli/val.py on its checkpoint: mAP {result['map']:.6f} in {val_s:.1f} s; "
        f"launches {path}; nms_greedy: {live} live, {kept} kept, {bad} mismatches [{card}]")
    if path["nms_greedy"] == 0 or bad or kept == 0:
        fail(f"{name} cli/val.py: B1 not launched, a twin mismatch or nothing kept")
    few = tmp / "few"
    few.mkdir()
    for p in sorted(val_dirs[0].iterdir())[:6]:
        (few / p.name).symlink_to(p)
    runs = {}
    for label, flags in (("folded", []), ("no-fuse", ["--no-fuse"])):
        zero_counters()
        with record_nms_inputs() as rec:
            runs[label] = detect_main(["--model", name, "--ckpt-dir", str(ckpt_dir), "--img-dir",
                                       str(few), "--name-path", str(val_dirs[2]), "--save-dir",
                                       str(tmp / f"detect_{label}"), "--device", "cuda", *flags])
        path = read_counters()
        add_launches(launches, path)
        bad, calls = twin_mismatches(rec)
        if bad or sum(path.values()) == 0:
            fail(f"{name} cli/detect.py {label}: a twin mismatch or no kernel launched")
    names = sorted(runs["no-fuse"])
    share, n = matched_share([runs["folded"][k] for k in names],
                             [runs["no-fuse"][k] for k in names], 1e-4, DETECT_BOX_TOL)
    log(f"  {name} cli/detect.py --ckpt-dir on 6 images: folded vs --no-fuse {share * 100:.2f}% "
        f"of {n} detections matched (conf 1e-4, box {DETECT_BOX_TOL} px; need >= "
        f"{FOLD_MATCH * 100:.0f}%) [{card}]")
    if n == 0 or share < FOLD_MATCH:
        fail(f"{name} cli/detect.py: no detection, or folded disagrees with --no-fuse")
    return launches, {"val_map": result["map"], "val_s": val_s, "detect_matched": share,
                      "detections": n}


def phase_anchor_free(card):
    """Phase 12: YOLOX and YOLOv8 (see the module docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches, out, seconds, kernel_rows = {}, {}, {}, {}
    gen = torch.Generator().manual_seed(0)
    calib = (torch.randint(0, 256, (2, 3, KNOB_HW // 2, KNOB_HW // 2), generator=gen).float()
             / 255).cuda()

    def part(label, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[label] = time.perf_counter() - t0
        log(f"  ({label}: {seconds[label]:.1f} s)")
        return result

    path, served, out["models"] = part("models", af_models, card, calib)
    add_launches(launches, path)
    for name in AF_SERVED:
        path, rows, out[f"{name} serving"] = part(f"{name} serving", af_serving, served[name],
                                                  name, card)
        add_launches(launches, path)
        for label, (kernel, row) in rows.items():
            kernel_rows.setdefault(kernel, {})[label] = row
    del served
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val_dirs = synthetic_folder(tmp / "val", 2 * AF_VAL_B, seed=31)
        for name in AF_SERVED:
            path, out[f"{name} training"], ckpt, captured = part(
                f"{name} training", af_training, name, card, tmp / name, val_dirs)
            add_launches(launches, path)
            kernel_rows["nms_greedy"][f"{name} evaluate()"] = kernel_at(
                "nms_greedy", captured, f"{name} evaluate()", path["nms_greedy"], card)
            torch.cuda.empty_cache()
            path, out[f"{name} entry points"] = part(f"{name} entry points", af_entry_points,
                                                     name, ckpt, val_dirs, tmp / name, card)
            add_launches(launches, path)
    for name in AF_SERVED:
        out[f"{name} card vs CPU"] = part(f"{name} card vs CPU", af_card_vs_cpu, name, card)
    wall = time.perf_counter() - t_phase
    log(f"anchor-free phase: {wall:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                                        seconds.items())
        + f"); launches {launches} [{card}]")
    out.update(launches=launches, seconds=seconds, phase_s=wall, kernels=kernel_rows)
    return out


# ---------------------------- phase 13: YOLOv7, RetinaNet (+experiment), FCOS

LF_MODELS = ("yolov7", "retinanet", "retinanet_experiment", "fcos", "fcos_cspnet")
LF_SERVED = ("yolov7", "retinanet", "fcos")  # served, trained and validated
LF_UPDATES = 3  # one-update epochs of the presets' batch
# the preset's own IoU loss: the family's default CIoU in delta space
# divides by the predicted dw, dh unclamped, as the reference does
LF_LOSS_HYP = {"retinanet": {"iou_type": "iou"}}


def lf_output_convs(model):
    """(conv, std, bias) of each output conv of YOLOv7 (the detect convs),
    RetinaNet (the towers' output convs) and FCOS (cls, ctr, reg)."""
    if hasattr(model, "detect"):
        return [(getattr(model.detect, f"detect_{s}"), 1.5, 0.0) for s in "sml"]
    if hasattr(model, "classification"):
        return [(model.classification.output, 1.5, 0.0), (model.regression.output, 0.5, 0.0)]
    head = model.head
    return [(head.cls_out_layer, 1.5, 0.0), (head.ctr_out_layer, 1.5, 0.0),
            (head.reg_out_layer, 0.5, 1.0)]


def widen_outputs(model, img):
    """Random weights put every score at the prior (YOLOv7 ~1e-3, the focal
    prior 0.01): scale each output conv so that its raw output has ``std``
    on ``img`` (forward hooks read it), with the bias given: scores and
    classes spread as a trained head's do. RetinaNet's classification
    tower has the focal prior on all five biases (as JAX initializes it),
    which leaves its ReLUs dead; those go to 0 too. FCOS's regression
    starts at 1 stride a side (it is ReLU'd)."""
    convs = lf_output_convs(model)
    raw = {}
    hooks = [conv.register_forward_hook(lambda m, i, o: raw.setdefault(m, []).append(o))
             for conv, _, _ in convs]
    with torch.no_grad():
        if hasattr(model, "classification"):
            for conv in model.classification.children():
                conv.bias.zero_()
        for conv, _, _ in convs:
            conv.bias.zero_()
        model(img)
        for h in hooks:
            h.remove()
        for conv, std, bias in convs:
            now = torch.cat([o.float().flatten() for o in raw[conv]]).std()
            conv.weight.mul_(std / now)
            conv.bias.fill_(bias)


def flat_maps(out):
    """A model's raw outputs as a flat list of tensors (RetinaNet's first
    two, FCOS's three lists of levels)."""
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in flat_maps(o)]


def lf_models(card, calib):
    """Every new name at 640, nc=80, seeded, output convs widened: raw maps
    card vs CPU at B=1 (the largest difference over the map's scale),
    protocol img/s at B=64 (the first call apart). Returns the launches and
    the served models."""
    from yoloseries_tpu_torch.models import create_model

    launches, keep, out = {}, {}, {}
    gen = torch.Generator().manual_seed(21)
    x = torch.randint(0, 256, (1, 3, KNOB_HW, KNOB_HW), generator=gen).float() / 255
    img = knob_images(21, KNOB_B["protocol"])
    for name in LF_MODELS:
        model = create_model(name, num_class=80, device="cpu", seed=0).cuda()
        widen_outputs(model.eval(), calib)
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            ref = flat_maps(cpu_twin(model)(x)[:2] if name.startswith("retinanet")
                            else cpu_twin(model)(x))
            got = flat_maps(model(x.cuda())[:2] if name.startswith("retinanet")
                            else model(x.cuda()))
        err = max(float((g_.cpu() - r).abs().max()) / max(1.0, float(r.abs().max()))
                  for g_, r in zip(got, ref))
        ev = evaluator(model, EvalConfig(**PROTOCOL), name=name)
        with record_nms_inputs() as rec:
            ev(img[:2])
        bad, calls = twin_mismatches(rec)
        torch.cuda.synchronize()
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        first, best, _ = timed_calls(lambda: ev(img), n=2)
        path = read_counters()
        add_launches(launches, path)
        out[name] = {"params": n_params, "raw_err": err, "img_per_s": len(img) / best * 1e3,
                     "first_ms": first, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  {name}: {n_params} params; raw maps card vs CPU at B=1 max abs diff over the "
            f"map's scale {err:.3e} (tolerance {MODEL_TOL}); protocol B=64 "
            f"{len(img) / best * 1e3:.1f} img/s ({best:.1f} ms, best of 2), first call "
            f"{first:.1f} ms, peak {out[name]['peak_gib']:.2f} GiB; launches {path}; {calls} "
            f"NMS calls against the twins: {bad} mismatches [{card}]")
        if not err <= MODEL_TOL:
            fail(f"{name}: card and CPU raw maps disagree")
        if path["nms_greedy"] == 0 or bad:
            fail(f"{name}: protocol B=64 did not launch nms_greedy, or a twin mismatch")
        if name in LF_SERVED:
            keep[name] = model
        else:
            del model, ev
            torch.cuda.empty_cache()
    return launches, keep, out


def yolov7_fold_check(model, card):
    """YOLOv7 folded (conv+BN, then RepConv to its deploy form) against the
    unfolded model: raw maps at B=2 and the protocol detections at B=8."""
    from yoloseries_tpu_torch.nn.deploy import fold_conv_bn, fold_repconv

    img = knob_images(24, 8)
    x = torch.from_numpy(img[:2]).cuda().permute(0, 3, 1, 2).float() / 255
    ev = evaluator(model, EvalConfig(**PROTOCOL), name="yolov7")
    with torch.no_grad():
        ref_maps, ref = model(x), ev(img)
        folded = fold_repconv(fold_conv_bn(cpu_twin(model))).cuda().eval()
        got_maps = folded(x)
    got = evaluator(folded, EvalConfig(**PROTOCOL), name="yolov7")(img)
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(got_maps, ref_maps))
    share, n = matched_share(got, ref, 1e-4, DETECT_BOX_TOL)
    log(f"  yolov7 folded (conv+BN, RepConv deploy) vs unfolded: raw maps {err:.3e} of their "
        f"scale (tolerance {FOLD_TOL}), protocol B=8 detections {share * 100:.2f}% of {n} "
        f"matched (conf 1e-4, box {DETECT_BOX_TOL} px; need >= {FOLD_MATCH * 100:.0f}%) "
        f"[{card}]")
    if not (err <= FOLD_TOL and n and share >= FOLD_MATCH):
        fail("yolov7: the folded model disagrees with the unfolded one")
    return {"raw_err": err, "matched": share, "detections": n}


def phase_last_families(card):
    """Phase 13: YOLOv7, RetinaNet (+experiment) and FCOS (+CSPNet) (see
    the module docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # cuDNN's heuristics, not its autotuning: each new shape's first call
    # took 8-40 s (measured on one H100), 180 s of the phase's 475, and
    # the script must stay inside its limit
    torch.backends.cudnn.benchmark = False
    launches, out, seconds, kernel_rows = {}, {}, {}, {}
    gen = torch.Generator().manual_seed(0)
    calib = (torch.randint(0, 256, (2, 3, KNOB_HW // 2, KNOB_HW // 2), generator=gen).float()
             / 255).cuda()

    def part(label, fn, *args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        seconds[label] = time.perf_counter() - t0
        log(f"  ({label}: {seconds[label]:.1f} s)")
        return result

    path, served, out["models"] = part("models", lf_models, card, calib)
    add_launches(launches, path)
    out["yolov7 fold"] = part("yolov7 fold", yolov7_fold_check, served["yolov7"], card)
    for name in LF_SERVED:
        path, rows, out[f"{name} serving"] = part(f"{name} serving", af_serving, served[name],
                                                  name, card)
        add_launches(launches, path)
        for label, (kernel, row) in rows.items():
            kernel_rows.setdefault(kernel, {})[label] = row
    del served
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        val_dirs = synthetic_folder(tmp / "val", 2 * AF_VAL_B, seed=32)
        for name in LF_SERVED:
            path, out[f"{name} training"], ckpt, captured = part(
                f"{name} training", af_training, name, card, tmp / name, val_dirs,
                updates=LF_UPDATES)
            add_launches(launches, path)
            kernel_rows["nms_greedy"][f"{name} evaluate()"] = kernel_at(
                "nms_greedy", captured, f"{name} evaluate()", path["nms_greedy"], card)
            torch.cuda.empty_cache()
            path, out[f"{name} entry points"] = part(f"{name} entry points", af_entry_points,
                                                     name, ckpt, val_dirs, tmp / name, card)
            add_launches(launches, path)
    for name in LF_SERVED:
        out[f"{name} card vs CPU"] = part(f"{name} card vs CPU", af_card_vs_cpu, name, card,
                                          hyp=LF_LOSS_HYP.get(name))
    torch.backends.cudnn.benchmark = True
    wall = time.perf_counter() - t_phase
    log(f"last-families phase (cuDNN autotuning off): {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + f"); launches {launches} [{card}]")
    out.update(launches=launches, seconds=seconds, phase_s=wall, kernels=kernel_rows)
    return out


def kernel_summary(rows):
    """At most one summary per kernel of a phase's per-path rows: the paths,
    the launches on them, the slowest device time and its bound."""
    out = {}
    for name, by_path in rows.items():
        worst = max(by_path.values(), key=lambda r: r["ms"])
        out[name] = {"paths": len(by_path), "launches": sum(r["launches"] for r in
                                                            by_path.values()),
                     "slowest": worst["shape"], "ms": worst["ms"],
                     "device_ms": worst["device_ms"], "bound_ms": worst["bound_ms"]}
    return out


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script drives the port on the card")
    try:
        import yoloseries_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable ({e}); run from the repo root")
    torch.backends.cudnn.allow_tf32 = False  # full f32 everywhere below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    watchdog = threading.Timer(WATCHDOG_S, hang)
    watchdog.daemon = True
    watchdog.start()
    t_start = time.perf_counter()

    log("== 1. environment")
    card = phase_environment()
    log("== 2. build")
    phase_build()
    log("== 3. kernels vs plain twins")
    mismatches = phase_kernels_vs_twins()
    log("== 4. model")
    model = phase_model().cuda().eval()
    log("== 5. serving")
    launches, captured = phase_serving(model, card)
    log("== 6. kernel timings at the serving path's candidates")
    rows = phase_timings(captured, launches, mismatches, card)
    log("== 7. where the device time goes")
    phase_profile(model, card)
    del model
    log("== 8. training")
    train = phase_training(card)
    b1 = next(r for r in rows if r["name"] == "nms_greedy")
    b1["train_val"] = kernel_at("nms_greedy", train["captured"], "train val",
                                train["launches"]["nms_greedy"], card)
    b1["launches"] += train["launches"]["nms_greedy"]
    b1["training"] = {k: train[k] for k in (
        "ms_per_update", "img_per_s", "peak_gib", "map", "map50", "host_between_ms",
        "host_inside_ms", "loader_ms", "loader_mode", "loader_threads_ms", "get_ms_per_sample",
        "collate_ms_per_sample", "step_alone_ms", "step_syncs", "h2d_call_ms",
        "h2d_landed_ms", "profile", "phase_s")}
    log("== 9. the recipe")
    keep = tempfile.TemporaryDirectory()  # phase 9's checkpoint, for phase 11
    recipe = phase_recipe(card, Path(keep.name))
    b1["recipe_val"] = kernel_at("nms_greedy", recipe.pop("val_captured"), "recipe val",
                                 recipe["val_launches"]["nms_greedy"], card)
    b1["launches"] += recipe["val_launches"]["nms_greedy"]
    b1["recipe"] = recipe
    for row in rows:  # detect's launches, whichever kernel its shape reached
        row["launches"] += recipe["detect_launches"][row["name"]]
    log("== 10. augmentation rendered on the card")
    aug = phase_device_aug(card, recipe)
    for row in rows:
        row["launches"] += aug["launches"][row["name"]]
    b1["device_aug"] = aug
    log("== 11. the YOLOv5 knobs: every spec, fold, s2d, bf16, soft-NMS, WBF, training, detect")
    knobs = phase_knobs(card, Path(keep.name))
    keep.cleanup()
    for row in rows:
        row["launches"] += knobs["launches"].get(row["name"], 0)
    b1["knobs"] = knobs
    log("== 12. the anchor-free families: YOLOX and YOLOv8, serving, training, entry points")
    anchor_free = phase_anchor_free(card)
    for row in rows:
        row["launches"] += anchor_free["launches"].get(row["name"], 0)
        row["anchor_free"] = anchor_free["kernels"].get(row["name"], {})
    b1["anchor_free_phase"] = {k: v for k, v in anchor_free.items() if k != "kernels"}
    log("== 13. the last families: YOLOv7, RetinaNet (+experiment), FCOS (+CSPNet), serving, "
        "training, entry points")
    last = phase_last_families(card)
    # the full rows on a line of their own; the kernels line takes a summary
    print(json.dumps({"last_families": {k: v for k, v in last.items()}},
                     separators=(",", ":"), default=str))
    summary = kernel_summary(last["kernels"])
    for row in rows:
        row["launches"] += last["launches"].get(row["name"], 0)
        row["last_families"] = summary.get(row["name"], {})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}, separators=(",", ":")))  # compact: ~20 KB
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The tracing registry's counters and spans of the assigner's padding and
of data parallelism (``utils/trace.py``):

* ``Trainer._device_batch`` counts ``train.gt_slots`` (images x padded gt
  slots) and ``train.gt_boxes`` (valid boxes) from the host's labels,
  before the copy; on the card, with no host sync
  (``torch.cuda.set_sync_debug_mode``);
* two gloo ranks of the global-batch step (``train/ddp.py::GlobalBatch``,
  ``nn/layers.py::BatchNorm`` with ``global_batch`` set), in fresh
  interpreters as ``test_torch_port_ddp.py`` runs its ranks: one
  ``ddp.grads`` span an update, ``ddp.grad_bytes`` the f32 bytes of every
  gradient, and a ``bn.global_sums`` span for each of the two global
  statistics of every BN a micro-batch (the forward's).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yoloseries_tpu_torch.train import Trainer
from yoloseries_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 120  # seconds for each rank's interpreter


def _batch(rows=3, slots=300):
    """Host labels of ``rows`` images: 0, 1, ... valid boxes, -1 padded."""
    ann = np.full((rows, slots, 6), -1.0, np.float32)
    for i in range(rows):
        ann[i, :i, :5] = (1, 2, 30, 40, 7)
    return {"img": np.zeros((rows, 32, 32, 3), np.uint8), "ann": ann}


def _counts():
    c = trace.totals()["counters"]
    return c.get("train.gt_slots", 0), c.get("train.gt_boxes", 0)


def _stub(device):
    """What ``_device_batch`` reads of a ``Trainer``: its shapes seen, and
    the body that copies the batch (recording the counters it finds)."""
    seen = []
    stub = SimpleNamespace(_batch_shapes=set(), device=torch.device(device))
    stub._to_device = Trainer._to_device.__get__(stub)

    def body(batch):
        seen.append((_counts(), type(batch["ann"])))
        return Trainer._device_batch_body(stub, batch)

    stub._device_batch_body = body
    return stub, seen


def test_gt_counters_from_host_labels():
    stub, seen = _stub("cpu")
    before = _counts()
    out = Trainer._device_batch(stub, _batch())
    slots, boxes = (a - b for a, b in zip(_counts(), before))
    assert (slots, boxes) == (3 * 300, 0 + 1 + 2)
    # counted before the copy, from the host's numpy labels
    assert seen == [((before[0] + 900, before[1] + 3), np.ndarray)]
    assert out["ann"].shape == (3, 300, 6)


@pytest.mark.gpu
def test_gt_counters_add_no_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stub, _ = _stub("cuda")
    Trainer._device_batch(stub, _batch())  # the first batch of its shape
    torch.cuda.synchronize()
    before = _counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = Trainer._device_batch(stub, _batch())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["ann"].is_cuda
    assert tuple(a - b for a, b in zip(_counts(), before)) == (900, 3)


_RANK = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig, yolov5_loss
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.nn.layers import BatchNorm
from yoloseries_tpu_torch.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu_torch.parallel import all_reduce_sum, init_from_env, process_index
from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step
from yoloseries_tpu_torch.train.ddp import GlobalBatch, set_sync_bn
from yoloseries_tpu_torch.utils import trace

init_from_env("cpu")
rank = process_index()
model = YOLOv5(3, YOLOv5Spec(8, (1, 1, 1, 1), 1), generator=torch.Generator().manual_seed(0))
set_sync_bn(model)
state = create_train_state(model, OptimizerConfig(batch_size=4, steps_per_epoch=1,
                                                  total_epochs=2), device="cpu")
cfg = YOLOv5LossConfig(num_class=3, input_size=(64, 64))
step = make_train_step(lambda p, t, b: yolov5_loss(p, t, YOLOV5_ANCHORS, b, cfg,
                                                   reduce=all_reduce_sum),
                       accumulate=2, collective=GlobalBatch())
rng = np.random.default_rng(rank)
ann = np.full((4, 4, 6), -1.0, np.float32)
ann[:, 0] = (8, 8, 40, 48, 1, 0)
batch = {"img": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)),
         "ann": torch.from_numpy(ann)}
trace.reset()
step(state, batch)
n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
grad_bytes = sum(p.numel() * 4 for p in model.parameters())
json.dump({"totals": trace.totals(), "n_bn": n_bn, "grad_bytes": grad_bytes},
          open(sys.argv[1] + f"/rank{rank}.json", "w"))
torch.distributed.destroy_process_group()
print("RANK DONE", rank)
'''


def test_ddp_spans_in_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE="2", OMP_NUM_THREADS="1",
               DIST_INIT_METHOD=f"file://{tmp_path / 'rendezvous'}")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path)], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK DONE" in log, f"rank {r}:\n{log[-4000:]}"
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        spans = {}
        for s in out["totals"]["spans"]:
            spans[s["name"]] = spans.get(s["name"], 0) + s["calls"]
        counters = out["totals"]["counters"]
        assert spans["ddp.grads"] == 1  # one update
        assert counters["ddp.grad_bytes"] == out["grad_bytes"] > 0
        # two statistics a BN in the forward, in each of the two micro-batches
        assert spans["bn.global_sums"] == 2 * 2 * out["n_bn"] > 0

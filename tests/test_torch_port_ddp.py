"""Data parallelism on ``torch.distributed`` (``parallel/dist.py``,
``train/ddp.py``) against the JAX package's mesh steps.

Two gloo ranks run on the CPU in fresh interpreters that import no JAX
(``torch.set_num_threads(1)``, a ``file://`` rendezvous, so that test
workers running side by side never meet on a port), each joined with its
own time limit; the JAX side runs on 2 forced host devices in
``run_in_clean_subprocess``, as ``tests/test_sharding.py`` runs its DDP
tests. The model is the narrow YOLOv5 (width 8, depth 1, nc=3) at 64 px,
from one set of JAX-initialised weights (detect heads widened) on every
side; a step's batch is 8 images, B=4 x accumulate 2 (the Trainer's 16,
B=4 x accumulate 4: with less averaging, single-process runs of the two
packages already part by more than 1e-3 within four updates).

* (a) The per-replica step (``per_replica_bn``) against JAX's
  ``make_ddp_train_step``, two updates: the parameters, each rank's BN
  statistics and EMA statistics against JAX's device of the same index,
  within 1e-4 * max(1, |ref|) (``test_torch_port_train.py``'s step
  tolerance); the two ranks' statistics differ on different shards and are
  equal, as JAX's are, on identical ones; after ``sync_replica_stats`` they
  equal JAX's synced statistics.
* (b) The default, global-batch step against JAX's pjit step over the
  sharded batch (the JAX ``Trainer``'s path) and against the port's own
  one-process step on the same 8 images: losses and parameters within 1e-4
  of JAX's, and within 1e-5 of the one-process step.
* (c) The ``Trainer`` with ``per_replica_bn`` over two epochs of a PNG
  folder on two ranks against the JAX ``Trainer`` with ``per_replica_bn``
  on one host of two devices: the same batches on the same replicas, the
  losses of the 4 updates within the Trainer test's rtol 1e-3, equal on
  both ranks; rank 0 alone writes checkpoints; each rank writes its log.
* (d) ``evaluate()`` on two ranks (a contiguous half of the val set each,
  the statistics gathered): the mAP of one process over the whole set on
  the same weights, exactly, and JAX's ``evaluate()`` on them within 1e-6.
* (e) The ``Trainer``'s default, global-batch path on two ranks against the
  ``Trainer`` in one process: every update's losses and the final weights.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_families import rel_diff, write_folder
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.data import DataLoader, DetectionDataset
from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, yolov5_select_fn
from yoloseries_tpu_torch.families import get_family
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu_torch.ops.letterbox import letterbox_image
from yoloseries_tpu_torch.ops.metrics import DetectionMetrics
from yoloseries_tpu_torch.parallel import part_rows
from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step
from yoloseries_tpu_torch.train.trainer import Trainer
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

from conftest import run_in_clean_subprocess

ROOT = Path(__file__).resolve().parent.parent
NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 64
STEP_TOL = 1e-4
WORLD = 2
RANK_TIMEOUT = 300  # seconds for each rank's interpreter
OPTIM = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)
HYP = {"input_img_size": [SIZE, SIZE], "batch_size": 4, "accumulate_loss_step": 16,
       "total_epoch": 2, "no_data_aug_epoch": 2, "warmup_steps": 3, "num_workers": 1,
       "save_ckpt_every": 1, "random_seed": 3, "per_replica_bn": True,
       "compute_metric_conf_threshold": 0.001, "eval_num_candidates": 4096,
       "data_aug_mosaic_p": 0.0, "data_aug_mixup_p": 0.0, "data_aug_prespective_p": 0.0,
       "data_aug_hsv_p": 0.0, "data_aug_cutout_p": 0.0, "data_aug_fliplr_p": 0.0}
MODEL = "yolov5_port_ddp_test"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches():
    """Two updates' batches of 8 images (seeds 20, 21) and one whose halves
    are the same 4 images (seed 22)."""
    out = []
    for seed in (20, 21, 22):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
        ann = np.full((8, 8, 6), -1.0, np.float32)
        for b in range(8):
            k = int(rng.integers(1, 9))
            xy = rng.uniform(0, SIZE - 12, (k, 2))
            wh = rng.uniform(6, SIZE / 2, (k, 2))
            ann[b, :k, :2] = xy
            ann[b, :k, 2:4] = np.minimum(xy + wh, SIZE)
            ann[b, :k, 4] = rng.integers(0, NC, k)
            ann[b, :k, 5] = b
        if seed == 22:
            img[4:], ann[4:] = img[:4], ann[:4]
        out.append((img, ann))
    return out


# ------------------------------------------------------------ the ranks

_RANK = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig, yolov5_loss
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec, register
from yoloseries_tpu_torch.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu_torch.parallel import all_reduce_sum, init_from_env, part_rows, process_index
from yoloseries_tpu_torch.train import OptimizerConfig, Trainer, create_train_state, make_train_step
from yoloseries_tpu_torch.train.ddp import GlobalBatch, PerReplica, set_sync_bn, sync_replica_stats
from yoloseries_tpu_torch.utils.weights import load_blob_weights

work = sys.argv[1]
cfg = json.loads(open(os.path.join(work, "cfg.json")).read())
dev = init_from_env("cpu")
rank = process_index()
assert str(dev) == "cpu" and torch.distributed.get_world_size() == 2
data = np.load(os.path.join(work, "batches.npz"))

def model():
    m = YOLOv5(3, YOLOv5Spec(cfg["narrow"][0], tuple(cfg["narrow"][1]), cfg["narrow"][2]))
    load_blob_weights(m, os.path.join(work, "weights.npz"))
    return m

loss_cfg = YOLOv5LossConfig(num_class=3, input_size=(64, 64))
out = {}

def run(name, collective, rows, loss, batches):
    state = create_train_state(model(), OptimizerConfig(**cfg["optim"]), device="cpu")
    if isinstance(collective, GlobalBatch):
        set_sync_bn(state.model)
    step = make_train_step(loss, accumulate=2, collective=collective)
    losses = []
    for i in batches:
        batch = {"img": torch.from_numpy(data[f"img{i}"][rows]),
                 "ann": torch.from_numpy(data[f"ann{i}"][rows])}
        state, m = step(state, batch)
        losses.append({k: float(v) for k, v in m.items()})
    out[name] = {"model": state.model.state_dict(), "ema": state.ema,
                 "synced": sync_replica_stats(state.model.state_dict()),
                 "synced_ema": sync_replica_stats(state.ema),
                 "balances": state.balances, "losses": losses}

local = lambda p, t, b: yolov5_loss(p, t, YOLOV5_ANCHORS, b, loss_cfg)
reduced = lambda p, t, b: yolov5_loss(p, t, YOLOV5_ANCHORS, b, loss_cfg, reduce=all_reduce_sum)
run("replica", PerReplica(), part_rows(8, rank, 2, 1), local, (0, 1))
run("replica_same", PerReplica(), part_rows(8, rank, 2, 1), local, (2,))
run("global", GlobalBatch(), part_rows(8, rank, 2, 2), reduced, (0, 1))

def port_model(num_class, generator=None):
    return model()

register(cfg["model"])(port_model)
tcfg = TrainConfig.from_hyp(cfg["hyp"], num_class=3, model=cfg["model"], max_labels=8,
                            output_dir=os.path.join(work, "run"))
folder = cfg["folder"]
tr = Trainer(tcfg, (folder + "/img", folder + "/lab"), val_dirs=(folder + "/img", folder + "/val"),
             names_path=folder + "/names.txt", log_fn=lambda *a: None, device="cpu")
try:
    tr.train()
    out["trainer"] = {"history": tr.history, "map": tr.evaluate(),
                      "eval_variables": tr.eval_variables(),
                      "val_images": [p.name for p in tr._val_loader.dataset.img_files]}
finally:
    tr.close()
tcfg = TrainConfig.from_hyp({**cfg["hyp"], "per_replica_bn": False}, num_class=3,
                            model=cfg["model"], max_labels=8,
                            output_dir=os.path.join(work, "run_global"))
tr = Trainer(tcfg, (folder + "/img", folder + "/lab"), names_path=folder + "/names.txt",
             log_fn=lambda *a: None, device="cpu")
try:
    tr.train()
    out["global_trainer"] = {"history": tr.history, "model": tr.state.model.state_dict()}
finally:
    tr.close()
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
print("RANK DONE", rank)
'''


def _run_ranks(work: Path):
    """Start the two ranks, each in its own interpreter, and join each with
    its own time limit; their results are ``rank{r}.pt`` in ``work``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE=str(WORLD),
               DIST_INIT_METHOD=f"file://{work / 'rendezvous'}", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work)], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
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
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# ------------------------------------------------------------- JAX side

_JAX = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
import torch
from functools import partial
assert len(jax.devices()) == 2
from yoloseries_tpu.configs import TrainConfig
from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig, yolov5_loss
from yoloseries_tpu.models.registry import register
from yoloseries_tpu.models.yolov5 import YOLOv5, YOLOv5Spec
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.parallel import batch_sharding, make_mesh, replicate_state
from yoloseries_tpu.train import Trainer
from yoloseries_tpu.train.ddp import make_ddp_train_step, shard_ddp_state, sync_replica_stats
from yoloseries_tpu.train.optim import OptimizerConfig, build_optimizer
from yoloseries_tpu.train.state import create_train_state, make_train_step
from yoloseries_tpu.utils.torch_import import convert_yolov5_state_dict
import yoloseries_tpu.data as jdata

work = WORK
cfg = json.loads(open(os.path.join(work, "cfg.json")).read())
narrow = (cfg["narrow"][0], tuple(cfg["narrow"][1]), cfg["narrow"][2])
w = np.load(os.path.join(work, "weights.npz"))
def tree(prefix):
    out = {}
    for k in w.files:
        if k.startswith(prefix + "/"):
            node = out
            parts = k.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = w[k]
    return out
params, stats = tree("params"), tree("batch_stats")
data = np.load(os.path.join(work, "batches.npz"))
model = YOLOv5(num_class=3, spec=YOLOv5Spec(*narrow))
tx = build_optimizer(OptimizerConfig(**cfg["optim"]), params)
loss_cfg = YOLOv5LossConfig(num_class=3, input_size=(64, 64))
anchors = jnp.asarray(YOLOV5_ANCHORS)
loss_fn = lambda preds, t, bal: yolov5_loss(preds, t, anchors, bal, loss_cfg)
mesh = make_mesh()
shard = batch_sharding(mesh)
put = lambda x: jax.device_put(jnp.asarray(x), shard)

def fresh():
    s = create_train_state(model, tx, jax.random.PRNGKey(0), (1, 64, 64, 3))
    return s.replace(params=params, batch_stats=stats, opt_state=tx.init(params),
                     ema_params=params, ema_batch_stats=stats)

def leaves(t):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(t))[0]}

out = {}
ddp = make_ddp_train_step(loss_fn, mesh, model.apply, tx, accumulate=2)
for name, batches in (("replica", (0, 1)), ("replica_same", (2,))):
    s = shard_ddp_state(fresh(), mesh)
    losses = []
    for i in batches:
        s, m = ddp(s, {"img": put(data[f"img{i}"]), "ann": put(data[f"ann{i}"])})
        losses.append({k: float(v) for k, v in m.items()})
    out[name] = {"params": leaves(s.params), "stats": leaves(s.batch_stats),
                 "ema_stats": leaves(s.ema_batch_stats),
                 "synced": leaves(sync_replica_stats(s.batch_stats)),
                 "synced_ema": leaves(sync_replica_stats(s.ema_batch_stats)),
                 "balances": np.asarray(s.balances), "losses": losses}
step = make_train_step(loss_cfg, YOLOV5_ANCHORS, accumulate=2, donate=False)
s = replicate_state(fresh(), mesh)
losses = []
for i in (0, 1):
    s, m = step(s, {"img": put(data[f"img{i}"]), "ann": put(data[f"ann{i}"])})
    losses.append({k: float(v) for k, v in m.items()})
out["global"] = {"params": leaves(s.params), "stats": leaves(s.batch_stats),
                 "ema_stats": leaves(s.ema_batch_stats), "balances": np.asarray(s.balances),
                 "losses": losses}

# (c) the Trainer per replica on one host of two devices
register(cfg["model"])(lambda num_class, dtype=jnp.float32, **kw:
                       YOLOv5(num_class=num_class, spec=YOLOv5Spec(*narrow), dtype=dtype))
folder = cfg["folder"]
tcfg = TrainConfig.from_hyp(cfg["hyp"], num_class=3, model=cfg["model"], max_labels=8,
                            output_dir=os.path.join(work, "jax_run"))
tr = Trainer(tcfg, (folder + "/img", folder + "/lab"), names_path=folder + "/names.txt",
             log_fn=lambda *a: None)
try:
    tr.state = shard_ddp_state(tr.state.replace(
        params=params, batch_stats=stats, opt_state=tr.tx.init(params), ema_params=params,
        ema_batch_stats=stats), tr.mesh)
    tr.train()
    out["trainer_losses"] = [float(x) for x in tr.meters["tot_loss"]._window]
finally:
    tr.close()

# (d) JAX's evaluate() on the port's synced EMA weights, over the whole set
sd = torch.load(os.path.join(work, "eval_variables.pt"), weights_only=True)
ep, es = convert_yolov5_state_dict(sd, 3)
ecfg = TrainConfig.from_hyp({**cfg["hyp"], "per_replica_bn": False}, num_class=3,
                            model=cfg["model"], max_labels=8,
                            output_dir=os.path.join(work, "jax_eval"))
ev = Trainer(ecfg, (folder + "/img", folder + "/lab"), val_dirs=(folder + "/img", folder + "/val"),
             names_path=folder + "/names.txt", log_fn=lambda *a: None)
try:
    ev.state = replicate_state(ev.state.replace(ema_params=ep, ema_batch_stats=es), ev.mesh)
    res = ev.evaluate()
    out["map"] = {k: float(res[k]) for k in ("map", "map50", "mp", "mr")}
finally:
    ev.close()
np.save(os.path.join(work, "jax_out.npy"), np.asarray(out, dtype=object), allow_pickle=True)
print("JAX DONE")
'''


# ----------------------------------------------------------------- setup

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side run once: the weights, the batches and the PNG folder
    (labelled with the model's own top detections for ``val``), then the
    two ranks, then the JAX subprocess (which scores the ranks' weights)."""
    work = tmp_path_factory.mktemp("port_ddp")
    jm = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(jax.jit(lambda: jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False))())
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(0)
    for head in params["detect"].values():
        head["kernel"] = rng.normal(0, 0.3, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    np.savez(work / "weights.npz",
             **{"/".join(("params",) + k): v for k, v in flatten_tree(params).items()},
             **{"/".join(("batch_stats",) + k): v for k, v in flatten_tree(stats).items()})
    batches = _batches()
    np.savez(work / "batches.npz", **{f"img{i}": b[0] for i, b in enumerate(batches)},
             **{f"ann{i}": b[1] for i, b in enumerate(batches)})
    img_dir, lab_dir, names = write_folder(work / "folder", n=32, seed=5)
    val_dir = work / "folder" / "val"
    val_dir.mkdir()
    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    port.load_state_dict(state_dict_from_jax(params, stats))
    ev = Evaluator(port, None, EvalConfig(), yolov5_select_fn(EvalConfig()), device="cpu")
    paths = sorted(img_dir.iterdir())
    boxed = [letterbox_image(np.asarray(Image.open(p).convert("RGB")), (SIZE, SIZE))
             for p in paths]
    dets = ev.to_host_detections(ev(np.stack([b[0] for b in boxed])),
                                 np.stack([b[1].as_array() for b in boxed]))
    for path, det in zip(paths, dets):
        rows = [] if det is None else det[np.argsort(-det[:, 4])]
        rows = [r for r in rows if min(r[2] - r[0], r[3] - r[1]) > 3][:3]
        assert rows, path
        (val_dir / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[5])} {r[0]:.2f} {r[1]:.2f} {r[2]:.2f} {r[3]:.2f}\n" for r in rows))
    (work / "cfg.json").write_text(json.dumps({"narrow": NARROW, "optim": OPTIM, "hyp": HYP,
                                               "model": MODEL,
                                               "folder": str(work / "folder")}))
    ranks = _run_ranks(work)
    torch.save(ranks[0]["trainer"]["eval_variables"], work / "eval_variables.pt")
    run_in_clean_subprocess(f"WORK = {str(work)!r}\n" + _JAX, n_devices=2, timeout=600)
    jax_out = np.load(work / "jax_out.npy", allow_pickle=True).item()
    return work, ranks, jax_out, params, stats


def _to_port(leaves: dict, kind: str) -> dict:
    """'a/b/leaf' -> array leaves of a JAX params or batch_stats tree ->
    the port's state_dict keys."""
    tree = {}
    for k, v in leaves.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    if kind == "params":
        return state_dict_from_jax(tree, {})
    return {k: v for k, v in state_dict_from_jax({}, tree).items()
            if not k.endswith("num_batches_tracked")}


def _worst(got: dict, want: dict) -> float:
    return max(rel_diff(got[k].detach().numpy(), np.asarray(v)) for k, v in want.items())


# ----------------------------------------------------------------- tests

def test_per_replica_step_matches_jax(runs):
    _, ranks, jax_out, _, _ = runs
    want = jax_out["replica"]
    for r, rank in enumerate(ranks):
        got = rank["replica"]
        assert _worst(got["model"], _to_port(want["params"], "params")) <= STEP_TOL
        per_dev = {k: v[r] for k, v in want["stats"].items()}
        assert _worst(got["model"], _to_port(per_dev, "stats")) <= STEP_TOL
        per_dev = {k: v[r] for k, v in want["ema_stats"].items()}
        assert _worst(got["ema"], _to_port(per_dev, "stats")) <= STEP_TOL
        assert _worst(got["synced"], _to_port(want["synced"], "stats")) <= STEP_TOL
        assert _worst(got["synced_ema"], _to_port(want["synced_ema"], "stats")) <= STEP_TOL
        for g, w in zip(got["losses"], want["losses"]):
            assert abs(g["tot_loss"] - w["tot_loss"]) <= STEP_TOL * abs(w["tot_loss"])
        np.testing.assert_allclose(got["balances"].numpy(), want["balances"], rtol=STEP_TOL)
    # the replicas' parameters agree; their BN statistics follow their shards
    a, b = ranks[0]["replica"]["model"], ranks[1]["replica"]["model"]
    stat_keys = [k for k in a if k.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(a[k], b[k]) for k in a if k not in stat_keys
               and not k.endswith("num_batches_tracked"))
    assert max(float((a[k] - b[k]).abs().max()) for k in stat_keys) > 1e-3
    a, b = ranks[0]["replica_same"]["model"], ranks[1]["replica_same"]["model"]
    assert all(torch.equal(a[k], b[k]) for k in stat_keys)
    same = jax_out["replica_same"]["stats"]
    assert all(np.allclose(v[0], v[1], rtol=1e-5) for v in same.values())


def test_global_batch_step_matches_jax_and_one_process(runs):
    work, ranks, jax_out, params, stats = runs
    # the port's one-process step on the same 8 images
    state = create_train_state(YOLOv5(NC, YOLOv5Spec(*NARROW)), OptimizerConfig(**OPTIM),
                               state_dict=state_dict_from_jax(params, stats), device="cpu")
    step = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                           YOLOV5_ANCHORS, accumulate=2)
    data = np.load(work / "batches.npz")
    one = []
    for i in (0, 1):
        state, m = step(state, {"img": torch.from_numpy(data[f"img{i}"]),
                                "ann": torch.from_numpy(data[f"ann{i}"])})
        one.append({k: float(v) for k, v in m.items()})
    want = jax_out["global"]
    for rank in ranks:
        got = rank["global"]
        for g, o, w in zip(got["losses"], one, want["losses"]):
            for k in ("tot_loss", "iou_loss", "cof_loss", "cls_loss", "grad_norm"):
                assert abs(g[k] - o[k]) <= 1e-5 * abs(o[k]), (k, g[k], o[k])
                assert abs(g[k] - w[k]) <= STEP_TOL * abs(w[k]), (k, g[k], w[k])
            assert g["tar_nums"] == o["tar_nums"] == w["tar_nums"]
        sd = state.model.state_dict()
        assert _worst(got["model"], {k: v.numpy() for k, v in sd.items()
                                     if not k.endswith("num_batches_tracked")}) <= 1e-5
        assert _worst(got["model"], _to_port(want["params"], "params")) <= STEP_TOL
        assert _worst(got["model"], _to_port(want["stats"], "stats")) <= STEP_TOL
        assert _worst(got["ema"], _to_port(want["ema_stats"], "stats")) <= STEP_TOL
        np.testing.assert_allclose(got["balances"].numpy(), want["balances"], rtol=STEP_TOL)
        np.testing.assert_allclose(got["balances"].numpy(), state.balances.numpy(), rtol=1e-5)


def test_trainer_per_replica_matches_jax(runs):
    work, ranks, jax_out, _, _ = runs
    losses = [[h["tot_loss"] for h in rank["trainer"]["history"]] for rank in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == 4  # 2 epochs of 32 images in 16s
    np.testing.assert_allclose(losses[0], jax_out["trainer_losses"], rtol=1e-3)
    assert sorted(p.name for p in (work / "run" / "log").iterdir()) == ["log_rank_0",
                                                                       "log_rank_1"]
    assert sorted(int(p.name) for p in (work / "run" / "checkpoints").iterdir()) == [0, 2, 4]


def test_trainer_global_batch_matches_one_process(runs):
    """(e) The ``Trainer``'s default path on two ranks (each loading its rows
    of every micro-batch) against the ``Trainer`` in one process on the same
    folder and weights: every update's losses within 1e-5 and gradient norm
    within 1e-4 (f32 sums split over two ranks), the weights after the 4
    updates within 1e-5."""
    from yoloseries_tpu_torch.models import register
    from yoloseries_tpu_torch.utils.weights import load_blob_weights

    work, ranks, _, _, _ = runs

    def port_model(num_class, generator=None):
        m = YOLOv5(NC, YOLOv5Spec(*NARROW))
        load_blob_weights(m, work / "weights.npz")
        return m

    register(MODEL)(port_model)
    folder = work / "folder"
    cfg = TrainConfig.from_hyp({**HYP, "per_replica_bn": False}, num_class=NC, model=MODEL,
                               max_labels=8, output_dir=str(work / "one_global"))
    tr = Trainer(cfg, (folder / "img", folder / "lab"), names_path=folder / "names.txt",
                 log_fn=lambda *a: None, device="cpu")
    try:
        tr.train()
    finally:
        tr.close()
    one = tr.history
    assert len(one) == 4  # 2 epochs of 32 images in updates of 16
    sd = {k: v.numpy() for k, v in tr.state.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    for rank in ranks:
        got = rank["global_trainer"]
        assert len(got["history"]) == len(one)
        for u, (g, o) in enumerate(zip(got["history"], one)):
            for k in ("tot_loss", "iou_loss", "cof_loss", "cls_loss"):
                assert abs(g[k] - o[k]) <= 1e-5 * abs(o[k]), (u, k, g[k], o[k])
            assert abs(g["grad_norm"] - o["grad_norm"]) <= 1e-4 * o["grad_norm"], (u, g, o)
            assert g["tar_nums"] == o["tar_nums"]
        assert _worst(got["model"], sd) <= 1e-5


def test_gathered_map_matches_one_process_and_jax(runs):
    work, ranks, jax_out, _, _ = runs
    maps = [rank["trainer"]["map"] for rank in ranks]
    names = sorted(p.name for p in (work / "folder" / "img").iterdir())
    assert [r["trainer"]["val_images"] for r in ranks] == [names[:16], names[16:]]
    for k in ("map", "map50", "mp", "mr"):
        assert maps[0][k] == maps[1][k]
    # one process, the whole set, the same weights and batch
    model = YOLOv5(NC, YOLOv5Spec(*NARROW))
    model.load_state_dict(ranks[0]["trainer"]["eval_variables"])
    family = get_family("yolov5")
    cfg = family.apply_eval_overrides(TrainConfig.from_hyp(HYP, num_class=NC).eval, HYP)
    ev = Evaluator(model, family.make_decode(HYP, NC, (SIZE, SIZE)), cfg,
                   family.make_select(HYP, NC, (SIZE, SIZE))(cfg), device="cpu")
    folder = work / "folder"
    loader = DataLoader(DetectionDataset(folder / "img", folder / "val", folder / "names.txt",
                                         input_size=(SIZE, SIZE)),
                        batch_size=4, max_labels=8, shuffle=False, infinite=False,
                        use_processes=False, workers=1)
    metrics = DetectionMetrics()
    try:
        for batch in loader:
            Trainer._accumulate_eval(None, metrics, ev(batch["img"]), batch)
    finally:
        loader.stop()
    one = metrics.compute()
    assert one["map50"] > 0
    for k in ("map", "map50", "mp", "mr"):
        assert maps[0][k] == one[k], (k, maps[0][k], one[k])
        assert abs(maps[0][k] - jax_out["map"][k]) <= 1e-6, (k, maps[0][k], jax_out["map"][k])


def test_close_data_aug_does_not_depend_on_timing(tmp_path):
    """The loader closes augmentation from a fixed batch on (the consumer's
    position plus the queue and the batch in the making), so a loader closed
    at once and one whose producer ran ahead give the same batches, and a
    rank's rows of them are those rows: otherwise one process and two
    ranks, or two ranks, train on different images."""
    img_dir, lab_dir, names = write_folder(tmp_path / "data", n=8, seed=2)

    def batches(part, run_ahead):
        ds = DetectionDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE), enable_aug=True)
        loader = DataLoader(ds, batch_size=4, max_labels=8, seed=5, workers=2,
                            use_processes=False, part=part)
        try:
            if run_ahead:  # the queue full and the next batch made
                while not loader._queue.full() or loader._sample_counter < 12:
                    time.sleep(0.01)
            loader.close_data_aug()
            return [next(loader)["img"] for _ in range(6)]
        finally:
            loader.stop()

    now, ahead = batches(None, False), batches(None, True)
    assert all(np.array_equal(a, b) for a, b in zip(now, ahead))
    # augmented up to the close's fixed batch, plain after it
    plain = DataLoader(DetectionDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE)),
                       batch_size=4, max_labels=8, seed=5, workers=2, use_processes=False)
    try:
        want = [next(plain)["img"] for _ in range(6)]
    finally:
        plain.stop()
    assert [np.array_equal(a, b) for a, b in zip(now, want)] == [False] * 3 + [True] * 3
    for r in range(WORLD):
        rows = part_rows(4, r, WORLD, 2)
        got = batches((r, WORLD, 2), r == 0)
        assert all(np.array_equal(g, a[rows]) for g, a in zip(got, now))


def test_global_batch_needs_a_family_that_reduces(tmp_path, monkeypatch):
    """Over more than one rank the default step needs a loss that sums its
    batch terms over the ranks (YOLOv5's); another family raises, naming
    ROADMAP A8b, and a batch that does not split over the ranks raises."""
    import yoloseries_tpu_torch.train.trainer as trainer_mod

    img_dir, lab_dir, names = write_folder(tmp_path / "data", n=4, seed=1)
    monkeypatch.setattr(trainer_mod, "process_count", lambda: 2)
    monkeypatch.setattr(trainer_mod, "process_index", lambda: 0)
    hyp = {"input_img_size": [SIZE, SIZE], "batch_size": 2, "num_workers": 1,
           "save_log_txt": False}
    cfg = TrainConfig.from_hyp(hyp, num_class=NC, model="yolox_s", output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        Trainer(cfg, (img_dir, lab_dir), names_path=names, device="cpu")
    cfg = TrainConfig.from_hyp({**hyp, "batch_size": 3}, num_class=NC, output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        Trainer(cfg, (img_dir, lab_dir), names_path=names, device="cpu")

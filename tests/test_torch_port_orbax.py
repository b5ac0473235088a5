"""The port's reader of the JAX package's Orbax checkpoints
(``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/orbax.py``,
``train/checkpoint.py``, ``train/optim.py::optimizer_state_from_jax``)
against zstandard, tensorstore, orbax and the JAX package.

* zstd: frames that ``zstandard`` wrote from hypothesis-drawn bytes and
  float32 arrays at levels -5, 1, 3 and 19, content over 128 KB,
  repetitive data (every block, literals and sequence mode seen), a content
  checksum (and a wrong one refused); the frames inside tensorstore's OCDBT
  files;
* OCDBT: the same keys and bytes as tensorstore's ``ocdbt`` kvstore on a
  checkpoint of ``save_checkpoint`` whose b-tree is split into interior
  nodes (orbax's node limit lowered: at its 100 MB default every tree of
  the repo is one leaf) and on the committed fixture;
* trees: every leaf bit-equal to the JAX package's ``restore_checkpoint``,
  ``None`` exactly at the masked leaves: a narrow YOLOv5 after 2 SGD
  updates, Adam, the ``use_ocdbt=False`` layout, arrays in many chunks, an
  ``s2d_stem`` model; the port's ``restore_checkpoint`` on each holds the
  weights, EMA, counts and balances, and its optimizer takes the next
  update from fixed gradients as optax does (rtol 1e-6);
* resume: the port restored from the JAX directory takes the same next
  train-step update as JAX resumed (``STEP_TOL`` of
  ``test_torch_port_train.py``);
* entry points on a JAX run directory: ``cli/val.py --ckpt-dir`` (the same
  pickles as on the port's layout of the same weights, the JAX main's mAP
  line), ``cli/detect.py --ckpt-dir``, ``cli/train.py --resume`` (resumes
  at ``step // steps_per_epoch`` and keeps the JAX step);
* the committed fixture (``torch_port_orbax_fixture.py``) reads to its
  digests and restores into the port's model of it, and the numpy writer
  (``torch_port_orbax_writer.py``) writes what orbax reads back bit for
  bit (every family's state and the fixture's regeneration:
  ``test_torch_port_orbax_families.py``);
* the reader in a fresh interpreter that refuses ``jax``, ``orbax``,
  ``tensorstore``, ``zstandard`` and ``numcodecs``;
* refusals: an unfinished ``*.orbax-checkpoint-tmp-*`` step, ``use_zarr3``,
  an unknown handler; ``save_checkpoint(keep=1)`` leaves JAX steps.
"""

import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_port_cli import (  # noqa: F401 (the cli tests' fixtures, shared)
    MODEL,
    NC,
    SIZE,
    STEP,
    _jax_val_main,
    _match_detections,
    checkpoints,
    folder,
    weights,
)
from torch_port_orbax_fixture import FIXTURE, state_leaves
from torch_port_orbax_writer import write_step, yolov5_train_state_tree

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig as JaxLossConfig
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.train.checkpoint import _state_to_tree
from yoloseries_tpu.train.checkpoint import restore_checkpoint as jax_restore
from yoloseries_tpu.train.checkpoint import save_checkpoint as jax_save
from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
from yoloseries_tpu.train.state import create_train_state as jax_create_state
from yoloseries_tpu.train.state import make_train_step as jax_make_step
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from yoloseries_tpu_torch.utils import ocdbt, orbax, zstd
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
NARROW = (8, (1, 1, 1, 1), 1)
STEP_TOL = 1e-4  # one update, as tests/test_torch_port_train.py
OPTIM = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)
BANNED = ("jax", "orbax", "tensorstore", "zstandard", "numcodecs")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------- zstd

def _zstd_frame(data: bytes, level: int, checksum: bool = False) -> bytes:
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@settings(max_examples=20, deadline=None, derandomize=True, database=None)
@given(data=st.binary(max_size=4096))
def test_zstd_bytes_match_zstandard(level, data):
    assert zstd.decompress(_zstd_frame(data, level)) == data


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@settings(max_examples=4, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       n=st.one_of(st.integers(0, 1000), st.integers(40_000, 70_000)),
       scale=st.sampled_from([0.02, 1.0, 1e4]))
def test_zstd_float32_match_zstandard(level, seed, n, scale):
    """Weight-like float32 arrays, up to 280 KB (past one 128 KB block)."""
    data = np.random.default_rng(seed).normal(0, scale, n).astype(np.float32).tobytes()
    assert zstd.decompress(_zstd_frame(data, level)) == data


def _repetitive():
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), dtype=np.uint8))
             for _ in range(50)]
    text = b" ".join(words[i] for i in rng.integers(0, 50, 120_000))
    base = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    starts, ends = rng.integers(0, 896, 6000), rng.integers(32, 128, 6000)
    segments = b"".join(b"\x07" + base[o:o + n] for o, n in zip(starts, ends))
    return {
        "zeros": bytes(300_000),  # RLE blocks
        "period 3": b"abc" * 100_000,  # repeat offsets
        "bytes cycle": bytes(range(256)) * 900,
        "text": text,  # several blocks with one literal table (treeless)
        "two symbols": rng.integers(0, 2, 200_000, dtype=np.uint8).tobytes(),
        "floats then zeros": (rng.normal(0, 1, 40_000).astype(np.float32).tobytes()
                              + bytes(200_000)),
        "separated copies": base + segments,  # literals all one byte (RLE) at level 19
    }


def test_zstd_every_mode_on_repetitive_data(monkeypatch):
    """Repetitive data at every level: the frames decode, and between them
    they hold raw, RLE and compressed blocks, raw, RLE, Huffman and treeless
    literals, and sequence tables in predefined, RLE, FSE and repeat
    modes."""
    seen = {"block": set(), "literals": set(), "sequences": set()}
    literals, sequences = zstd._literals, zstd._sequences

    def record_literals(blk, pos, st_):
        seen["literals"].add(blk[pos] & 3)
        return literals(blk, pos, st_)

    def record_sequences(blk, pos, lit, out, st_):
        b0 = blk[pos]
        if b0:
            at = pos + (1 if b0 < 128 else 2 if b0 < 255 else 3)
            seen["sequences"].update((blk[at] >> s) & 3 for s in (6, 4, 2))
        return sequences(blk, pos, lit, out, st_)

    monkeypatch.setattr(zstd, "_literals", record_literals)
    monkeypatch.setattr(zstd, "_sequences", record_sequences)
    noise = np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for level in (-5, 1, 3, 19):
        for name, data in {**_repetitive(), "noise": noise}.items():
            frame = _zstd_frame(data, level)
            seen["block"].update(_block_types(frame))
            assert zstd.decompress(frame) == data, (level, name)
    assert seen["block"] == {0, 1, 2}, seen
    assert seen["literals"] == {0, 1, 2, 3}, seen
    assert seen["sequences"] == {0, 1, 2, 3}, seen


def _block_types(frame: bytes) -> list:
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
    pos += ((1 if fhd & 0x20 else 0), 2, 4, 8)[fhd >> 6]
    kinds = []
    while True:
        h = int.from_bytes(frame[pos:pos + 3], "little")
        kinds.append((h >> 1) & 3)
        pos += 3 + (1 if (h >> 1) & 3 == 1 else h >> 3)
        if h & 1:
            return kinds


def test_zstd_checksum_and_concatenated_frames():
    data = np.random.default_rng(1).normal(0, 1, 70_000).astype(np.float32).tobytes()
    frame = _zstd_frame(data, 3, checksum=True)
    assert frame[4] & 4  # the checksum flag
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame + _zstd_frame(b"tail", 1)) == data + b"tail"
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bad)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"not a frame")


def _encoded_bodies(store_dir: Path):
    """The zstd frames of every OCDBT manifest and node under
    ``store_dir`` (nodes found by their magic)."""
    for path in sorted(store_dir.rglob("*")):
        if not path.is_file() or path.name in ("_METADATA", "_sharding", "process_0"):
            continue
        raw = path.read_bytes()
        at = 0
        while True:
            hits = [i for i in (raw.find(b"\x0c\xdb\x20\xde", at),
                                raw.find(b"\x0c\xdb\x3a\x2a", at)) if i >= 0]
            if not hits:
                break
            i = min(hits)
            n = int.from_bytes(raw[i + 4:i + 12], "little")
            if raw[i + 12:i + 14] == b"\x00\x01" and i + n <= len(raw):
                yield path, raw[i + 14:i + n - 4]
            at = i + 4


def test_zstd_on_tensorstore_frames():
    zstandard = pytest.importorskip("zstandard")
    bodies = list(_encoded_bodies(FIXTURE / "1" / "state"))
    assert len(bodies) >= 3
    for path, body in bodies:
        want = zstandard.ZstdDecompressor().decompressobj().decompress(body)
        assert zstd.decompress(body) == want, path
    store = ocdbt.OcdbtStore(FIXTURE / "1" / "state")
    chunks = [k for k in store.keys() if not k.endswith(".zarray")]
    for k in chunks:
        value = store.get(k)
        assert zstd.decompress(value) == zstandard.ZstdDecompressor().decompress(
            value, max_output_size=1 << 24), k


# ------------------------------------------------------------- JAX runs

def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    ann = np.full((n, 6, 6), -1.0, np.float32)
    for b in range(n):
        k = int(rng.integers(1, 6))
        xy = rng.uniform(0, SIZE - 12, (k, 2))
        ann[b, :k, :2] = xy
        ann[b, :k, 2:4] = np.minimum(xy + rng.uniform(6, SIZE / 2, (k, 2)), SIZE)
        ann[b, :k, 4] = rng.integers(0, NC, k)
        ann[b, :k, 5] = b
    return img, ann


def _as_jax(batch):
    return {"img": jnp.asarray(batch[0]), "ann": jnp.asarray(batch[1])}


def _as_torch(batch):
    return {"img": torch.from_numpy(batch[0]), "ann": torch.from_numpy(batch[1])}


def _fixed_grads(params, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32),
                                  params)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX checkpoints of the narrow YOLOv5 (nc=3, 64 px) and what they
    hold: ``sgd`` after 2 train-step updates (the default layout, OCDBT),
    the same state ``split`` (OCDBT nodes of at most 4 KB), ``plain``
    (``use_ocdbt=False``) and ``chunked`` (chunks of at most 1 KB), ``adam``
    (the optimizer after 2 updates from fixed gradients) and ``s2d`` (the
    space-to-depth stem, 1 update from fixed gradients); the jitted train
    step and the batch of the update after them."""
    import orbax.checkpoint as ocp
    from orbax.checkpoint._src.serialization import tensorstore_utils as ts_utils

    root = tmp_path_factory.mktemp("orbax_runs")
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                        train=False)["params"]
    tx = jax_build_optimizer(JaxOptimizerConfig(**OPTIM), params)
    state = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    step = jax_make_step(JaxLossConfig(num_class=NC, input_size=(SIZE, SIZE)), YOLOV5_ANCHORS,
                         donate=False)
    for seed in (10, 11):
        state, _ = step(state, _as_jax(_batch(seed)))
    runs = {"sgd": (root / "sgd", state)}
    jax_save(runs["sgd"][0], state, 2, hyp={"batch_size": 4})

    add_options = ts_utils.add_ocdbt_write_options

    def small_nodes(spec, target_data_file_size=None):
        add_options(spec, target_data_file_size)
        spec["config"]["max_decoded_node_bytes"] = 4096

    try:
        ts_utils.add_ocdbt_write_options = small_nodes
        jax_save(root / "split", state, 2)
    finally:
        ts_utils.add_ocdbt_write_options = add_options
    runs["split"] = (root / "split", state)

    def orbax_save(name, use_ocdbt, chunk):
        save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(chunk_byte_size=chunk),
                                           _state_to_tree(state))
        handler = ocp.StandardCheckpointHandler(use_ocdbt=use_ocdbt)
        with ocp.CheckpointManager((root / name).absolute(), item_handlers={"state": handler},
                                   options=ocp.CheckpointManagerOptions(create=True)) as mgr:
            mgr.save(2, args=ocp.args.Composite(state=ocp.args.StandardSave(
                _state_to_tree(state), save_args=save_args)))
            mgr.wait_until_finished()
        runs[name] = (root / name, state)

    orbax_save("plain", False, None)
    orbax_save("chunked", True, 1024)

    for name, kind, s2d in (("adam", "adam", False), ("s2d", "sgd", True)):
        m = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW), s2d_stem=s2d)
        p = m.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)), train=False)["params"]
        t = jax_build_optimizer(JaxOptimizerConfig(**OPTIM, optimizer=kind), p)
        s = jax_create_state(m, t, jax.random.PRNGKey(1), (1, SIZE, SIZE, 3))
        opt_state, grads = s.opt_state, _fixed_grads(p)
        for _ in range(2 if kind == "adam" else 1):
            upd, opt_state = jax.jit(t.update)(grads, opt_state, s.params)
            s = s.replace(params=jax.tree_util.tree_map(lambda a, b: a + b, s.params, upd),
                          opt_state=opt_state, step=s.step + 1)
        s = s.replace(ema_params=jax.tree_util.tree_map(lambda a: a * 0.5, s.params),
                      ema_count=jnp.float32(3.0))
        jax_save(root / name, s, int(s.step))
        runs[name] = (root / name, s)
    return SimpleNamespace(runs=runs, step=step, next_batch=_batch(12))


def _port_state(s2d=False, kind="sgd", model=None):
    model = model or YOLOv5(NC, YOLOv5Spec(*NARROW), s2d_stem=s2d)
    return create_train_state(model, OptimizerConfig(**OPTIM, optimizer=kind), device="cpu")


def _check_leaves(got: dict, state):
    """``got`` (read_tree's nested dicts) bit-equal to the JAX state's tree,
    None exactly at its masked leaves and empty states."""
    want = state_leaves(state)
    flat = {"/".join(k): v for k, v in flatten_tree(got).items()}
    assert set(flat) == set(want)
    for k, w in want.items():
        if w is None:
            assert flat[k] is None, k
        else:
            g = flat[k]
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k
    return sum(w is None for w in want.values())


@pytest.mark.parametrize("name", ["sgd", "split", "plain", "chunked", "adam", "s2d"])
def test_tree_matches_orbax_restore(jax_runs, name):
    path, state = jax_runs.runs[name]
    restored, step = jax_restore(path, state)
    assert step == orbax.steps(path)[-1] == latest_step(path)
    tree = orbax.read_tree(path / str(step))
    masked = _check_leaves(tree, restored)
    assert masked > 0  # the optimizer's masked leaves are there
    _check_leaves(tree, state)
    layout = json.loads((path / str(step) / "state" / "_METADATA").read_text())
    if name == "plain":
        assert not layout["use_ocdbt"] and not (path / str(step) / "state" / "manifest.ocdbt"
                                                ).exists()
    if name == "split":
        assert ocdbt.OcdbtStore(path / str(step) / "state").height >= 1
    if name == "chunked":
        chunk = json.loads(ocdbt.OcdbtStore(path / str(step) / "state").get(
            "params.trunk.h4_csp.cv3.conv.kernel/.zarray"))
        assert chunk["chunks"] != chunk["shape"]


def test_ocdbt_matches_tensorstore(jax_runs):
    ts = pytest.importorskip("tensorstore")
    for store_dir in (jax_runs.runs["split"][0] / "2" / "state", FIXTURE / "1" / "state"):
        ours = ocdbt.OcdbtStore(store_dir)
        kv = ts.KvStore.open(f"file://{store_dir}/|ocdbt:").result()  # the OCDBT kvstore
        keys = sorted(k.decode() for k in kv.list().result())
        assert ours.keys() == keys
        for k in keys:
            assert ours.get(k) == kv.read(k).result().value, k
    assert ocdbt.OcdbtStore(jax_runs.runs["split"][0] / "2" / "state").height >= 1


def _optimizer_next_update(jstate, pstate, kind):
    """One more optimizer update from fixed gradients on both sides: the
    restored per-group counts and slots must give optax's parameters."""
    jcfg = JaxOptimizerConfig(**OPTIM, optimizer=kind)
    tx = jax_build_optimizer(jcfg, jstate.params)
    grads = _fixed_grads(jstate.params, seed=5)
    upd, _ = jax.jit(tx.update)(grads, jstate.opt_state, jstate.params)
    want = state_dict_from_jax(jax.device_get(jax.tree_util.tree_map(
        lambda a, b: a + b, jstate.params, upd)), jax.device_get(jstate.batch_stats))
    gsd = state_dict_from_jax(grads, jax.device_get(jstate.batch_stats))
    for name, p in pstate.model.named_parameters():
        p.grad = gsd[name].clone()
    pstate.optimizer.step()
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["sgd", "plain", "adam", "s2d"])
def test_port_restores_a_jax_train_state(jax_runs, name):
    path, jstate = jax_runs.runs[name]
    kind = "adam" if name == "adam" else "sgd"
    pstate, step = restore_checkpoint(path, _port_state(s2d=name == "s2d", kind=kind))
    assert step == int(jstate.step) == pstate.step
    host = jax.device_get(jstate)
    want = state_dict_from_jax(host.params, host.batch_stats)
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    ema = state_dict_from_jax(host.ema_params, host.ema_batch_stats)
    assert all(torch.equal(pstate.ema[k], ema[k]) for k in ema)
    assert pstate.ema_count == float(host.ema_count)
    assert torch.equal(pstate.balances, torch.tensor(np.asarray(host.balances)))
    assert pstate.optimizer.counts == {g: int(jstate.step) for g in ("weight", "other", "bias")}
    if name == "s2d":
        assert pstate.model.focus.conv.weight.shape[1:] == (12, 3, 3)
    _optimizer_next_update(jstate, pstate, kind)


def test_optimizer_group_mismatch_raises(jax_runs):
    """A leaf that the checkpoint's optimizer keeps in another group than
    ``param_group_label`` puts its parameter: the restore raises."""
    from yoloseries_tpu_torch.train.optim import optimizer_state_from_jax

    path, _ = jax_runs.runs["sgd"]
    tree = orbax.read_tree(path / "2")
    groups = tree["opt_state"]["1"]["inner_states"]
    bias_trace = groups["bias"]["inner_state"]["inner_state"]["0"]["trace"]
    weight_trace = groups["weight"]["inner_state"]["1"]["inner_state"]["0"]["trace"]
    conv = bias_trace["trunk"]["stem"]["conv"]
    conv["kernel"] = weight_trace["trunk"]["stem"]["conv"]["kernel"]
    pstate = _port_state()
    with pytest.raises(ValueError, match="group"):
        optimizer_state_from_jax(tree["opt_state"], pstate.optimizer, pstate.model,
                                 tree["params"])
    adam = _port_state(kind="adam")
    with pytest.raises(ValueError, match="not a adam optimizer"):
        optimizer_state_from_jax(orbax.read_tree(path / "2")["opt_state"], adam.optimizer,
                                 adam.model, tree["params"])


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def test_resume_takes_the_jax_next_update(jax_runs):
    path, state = jax_runs.runs["sgd"]
    jstate, _ = jax_restore(path, state)
    jstate, jm = jax_runs.step(jstate, _as_jax(jax_runs.next_batch))
    pstate, step = restore_checkpoint(path, _port_state())
    assert step == 2
    pstep = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                            YOLOV5_ANCHORS)
    pstate, pm = pstep(pstate, _as_torch(jax_runs.next_batch))
    assert pstate.step == int(jstate.step) == 3
    loss, want_loss = float(pm["tot_loss"]), float(jm["tot_loss"])
    assert abs(loss - want_loss) <= STEP_TOL * abs(want_loss)
    host = jax.device_get(jstate)
    want = state_dict_from_jax(host.params, host.batch_stats)
    ema = state_dict_from_jax(host.ema_params, host.ema_batch_stats)
    worst = max(_rel(v.numpy(), want[k].numpy()) for k, v in pstate.model.state_dict().items()
                if not k.endswith("num_batches_tracked"))
    worst_ema = max(_rel(pstate.ema[k].numpy(), ema[k].numpy()) for k in ema
                    if not k.endswith("num_batches_tracked"))
    assert worst <= STEP_TOL and worst_ema <= STEP_TOL, (worst, worst_ema)
    assert _rel(pstate.balances.numpy(), np.asarray(host.balances)) <= STEP_TOL
    assert pstate.ema_count == float(host.ema_count)


# --------------------------------------------------------- entry points

def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("params, max_batches", [("ema", None), ("raw", 1)])
def test_val_ckpt_dir_on_a_jax_run(folder, checkpoints, tmp_path, monkeypatch, capsys, params,
                                   max_batches):
    """The port's ``val --ckpt-dir`` on the JAX directory: the pickles of
    ``val`` on the port's layout of the same weights, byte for byte, and
    the detections (one for one, as ``test_torch_port_cli.py`` matches
    them) and mAP line of the JAX main on the JAX directory."""
    from yoloseries_tpu_torch.cli.val import main as port_main

    img_dir, lab_dir, names = folder
    common = ["--model", MODEL, "--val-img-dir", str(img_dir), "--val-lab-dir", str(lab_dir),
              "--name-path", str(names), "--batch-size", "4", "--input-size", str(SIZE),
              "--params", params]
    if max_batches:
        common += ["--max-batches", str(max_batches)]
    monkeypatch.setattr(jax_data, "DataLoader", _threads(jax_data.DataLoader))
    monkeypatch.setattr(port_data, "DataLoader", _threads(port_data.DataLoader))
    monkeypatch.setattr("sys.argv", ["val.py", "--ckpt-dir", str(checkpoints / "jax"),
                                     "--save-pkl-dir", str(tmp_path / "jax"), *common])
    _jax_val_main()()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    lines = {}
    for side in ("jax", "port"):
        port_main(["--ckpt-dir", str(checkpoints / side), "--save-pkl-dir",
                   str(tmp_path / f"port_on_{side}"), "--device", "cpu", *common])
        printed = capsys.readouterr().out
        assert f"loaded checkpoint at step {STEP}" in printed
        lines[side] = printed.strip().splitlines()[-1]
    assert lines["jax"] == lines["port"] == want_line
    for name in ("gt_bbox.pkl", f"pred_bbox_{SIZE}_{MODEL}.pkl"):
        got, want = _load(tmp_path / "port_on_jax" / name), _load(tmp_path / "port_on_port" / name)
        assert len(got) == len(want) and sum(len(p) for p in want) > 0
        assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(got, want))
    pred = f"pred_bbox_{SIZE}_{MODEL}.pkl"  # and the JAX main's, one for one
    _match_detections(_load(tmp_path / "port_on_jax" / pred), _load(tmp_path / "jax" / pred))


def _threads(loader):
    from functools import partial

    return partial(loader, use_processes=False)  # forking a JAX process can deadlock


def test_detect_ckpt_dir_on_a_jax_run(folder, checkpoints, tmp_path):
    from yoloseries_tpu_torch.cli.detect import main

    img_dir, _, names = folder
    args = ["--model", MODEL, "--img-dir", str(img_dir), "--input-size", str(SIZE),
            "--batch-size", "3", "--conf", "0.05", "--device", "cpu", "--name-path", str(names)]
    on_jax = main(["--ckpt-dir", str(checkpoints / "jax"), "--save-dir", str(tmp_path / "j"),
                   *args])
    on_port = main(["--ckpt-dir", str(checkpoints / "port"), "--save-dir", str(tmp_path / "p"),
                    *args])
    assert on_jax == on_port and sum(len(v) for v in on_jax.values()) > 0
    assert ((tmp_path / "j" / "detections.json").read_text()
            == (tmp_path / "p" / "detections.json").read_text())


def test_train_resume_from_a_jax_run(folder, checkpoints, tmp_path, capsys):
    """``cli/train.py --resume`` on an output directory whose checkpoints
    the JAX package wrote: the port resumes at step 7, epoch 7 // 2 = 3 (4
    images in updates of 2), trains the last epoch and saves its own step
    beside the JAX one."""
    from yoloseries_tpu_torch.cli.train import main

    img_dir, lab_dir, names = folder
    run = tmp_path / "run"
    shutil.copytree(checkpoints / "jax", run / "checkpoints")
    sub = tmp_path / "four"
    (sub / "img").mkdir(parents=True)
    (sub / "lab").mkdir()
    for p in sorted(img_dir.iterdir())[:4]:
        shutil.copy(p, sub / "img" / p.name)
        shutil.copy(lab_dir / f"{p.stem}.txt", sub / "lab" / f"{p.stem}.txt")
    argv = ["--model", MODEL, "--train-img-dir", str(sub / "img"), "--train-lab-dir",
            str(sub / "lab"), "--name-path", str(names), "--output-dir", str(run),
            "--input-size", str(SIZE), "--batch-size", "2", "--total-epoch", "4", "--resume",
            "--device", "cpu"]
    for kv in ("num_workers=1", "save_log_txt=false", "data_aug_mosaic_p=0.0"):
        argv += ["--set", kv]
    trainer = main(argv)
    assert f"resumed from step {STEP} (epoch 3)" in capsys.readouterr().out
    assert trainer.start_epoch == 3 and len(trainer.history) == 2
    # the JAX state's own update counter was 0 (the fixture saved it as step 7)
    assert trainer.state.step == 2 and trainer.state.optimizer.counts["weight"] == 2
    assert orbax.steps(run / "checkpoints") == [STEP]
    assert (run / "checkpoints" / "2" / "state.pt").exists()


# -------------------------------------------------- fixture and writer

def _digest(value):
    value = np.asarray(value, order="C")
    return {"sha256": hashlib.sha256(value.tobytes()).hexdigest(), "shape": list(value.shape),
            "dtype": value.dtype.str}


def test_fixture_reads_to_its_digests():
    digests = json.loads((FIXTURE / "digests.json").read_text())
    tree = orbax.read_tree(FIXTURE / "1")
    got = {"/".join(k): (None if v is None else _digest(v))
           for k, v in flatten_tree(tree).items()}
    assert got == digests
    assert orbax.read_json_item(FIXTURE / "1", "hyp")["num_class"] == 1
    # the port's model of it: width 1, no C3 block, nc=1
    model = YOLOv5(1, YOLOv5Spec(1, (0, 0, 0, 0), 0))
    state, step = restore_checkpoint(FIXTURE, create_train_state(model, OptimizerConfig(
        batch_size=2, steps_per_epoch=1, warmup_steps_override=2), device="cpu"))
    assert step == 1 == state.step and state.ema_count == 1.0
    traces = [t for g in state.optimizer.state.values() for t in g["trace"]]
    assert all(bool(t.abs().sum() > 0) for t in traces)


def test_writer_reads_back_in_orbax(jax_runs, tmp_path):
    """``write_step`` of the JAX state's own tree, in chunks of at most 256
    bytes, and ``yolov5_train_state_tree`` of a port state: the JAX
    package's ``restore_checkpoint`` reads each back bit for bit."""
    _, state = jax_runs.runs["sgd"]
    leaves = state_leaves(state)
    tree: dict = {}
    for path, value in leaves.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    write_step(tmp_path / "a", 2, tree, hyp={"batch_size": 4}, chunk_bytes=256)
    restored, step = jax_restore(tmp_path / "a", state)
    assert step == 2
    _check_leaves(tree, restored)
    _check_leaves(orbax.read_tree(tmp_path / "a" / "2"), state)
    assert orbax.read_json_item(tmp_path / "a" / "2", "hyp") == {"batch_size": 4}

    pstate = _port_state()
    gen = torch.Generator().manual_seed(0)
    for g in pstate.optimizer.state.values():
        for t in g["trace"]:
            t.copy_(torch.randn(t.shape, generator=gen))
    pstate.optimizer.counts = {g: 2 for g in pstate.optimizer.counts}
    pstate.step, pstate.ema_count = 2, 2.0
    write_step(tmp_path / "b", 2, yolov5_train_state_tree(pstate))
    restored, _ = jax_restore(tmp_path / "b", state)
    back, _ = restore_checkpoint(tmp_path / "b", _port_state())
    for g, s in pstate.optimizer.state.items():
        assert all(torch.equal(a, b) for a, b in zip(s["trace"], back.optimizer.state[g]["trace"]))
    want = state_dict_from_jax(jax.device_get(restored.params),
                               jax.device_get(restored.batch_stats))
    assert all(torch.equal(v, want[k]) for k, v in pstate.model.state_dict().items())


def test_missing_chunks(jax_runs, tmp_path):
    """A chunk that is not stored: an error where the item says every chunk
    was stored (``store_array_data_equal_to_fill_value``, as orbax writes
    it), else the fill value (null: zeros), as orbax's restore reads it.
    The writer's plain layout in 256-byte chunks, two chunk files removed."""
    _, state = jax_runs.runs["sgd"]
    tree: dict = {}
    for path, value in state_leaves(state).items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    step_dir = write_step(tmp_path, 2, tree, chunk_bytes=256)
    kernel = step_dir / "state" / "params.trunk.h4_csp.cv3.conv.kernel"
    chunks = sorted(p.name for p in kernel.iterdir() if p.name != ".zarray")
    assert len(chunks) > 2
    (kernel / chunks[1]).unlink()
    (step_dir / "state" / "balances" / "0").unlink()
    with pytest.raises(ValueError, match="balances/0 is missing"):
        orbax.read_tree(step_dir)
    with pytest.raises(Exception) as err:  # orbax wraps tensorstore's NOT_FOUND
        jax_restore(tmp_path, state)
    assert "is missing" in str(err.value.__cause__)
    meta = step_dir / "state" / "_METADATA"
    meta.write_text(meta.read_text().replace('"store_array_data_equal_to_fill_value": true',
                                             '"store_array_data_equal_to_fill_value": false'))
    restored, _ = jax_restore(tmp_path, state)
    got = orbax.read_tree(step_dir)
    _check_leaves(got, restored)
    assert not got["balances"].any()
    want = np.asarray(state.params["trunk"]["h4_csp"]["cv3"]["conv"]["kernel"])
    read = got["params"]["trunk"]["h4_csp"]["cv3"]["conv"]["kernel"]
    assert (read == 0).sum() > (want == 0).sum() and (read == want).mean() > 0.5


# ------------------------------------------------ without the packages

_REFUSING = r'''
import hashlib, importlib.abc, json, sys
BANNED = {banned!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"refused: {{name}}")
sys.meta_path.insert(0, Refuse())
for name in BANNED:
    try:
        __import__(name)
    except ImportError:
        pass
    else:
        sys.exit(f"{{name}} imported")
import numpy as np
from yoloseries_tpu_torch.train import checkpoint
from yoloseries_tpu_torch.utils import orbax, zstd
from yoloseries_tpu_torch.utils.weights import flatten_tree
want = json.load(open({want!r}))
out = {{}}
for name, step_dir in want["dirs"].items():
    tree = orbax.read_tree(step_dir)
    out[name] = {{"/".join(k): None if v is None else hashlib.sha256(
        np.asarray(v, order="C").tobytes()).hexdigest() for k, v in flatten_tree(tree).items()}}
out["frames"] = [hashlib.sha256(zstd.decompress(bytes.fromhex(f))).hexdigest()
                 for f in want["frames"]]
out["latest"] = [checkpoint.latest_step(d) for d in want["ckpt_dirs"]]
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print(json.dumps(out))
'''


def test_reader_without_third_party_packages(jax_runs, tmp_path):
    """The trees read in a fresh interpreter that refuses the packages equal
    the ones read here (which ``test_tree_matches_orbax_restore`` holds to
    orbax's)."""
    dirs = {"fixture": FIXTURE / "1"}
    for name in ("split", "plain", "chunked", "adam"):
        dirs[name] = jax_runs.runs[name][0] / orbax.steps(jax_runs.runs[name][0])[-1].__str__()
    want = {name: {"/".join(k): None if v is None else hashlib.sha256(
        np.asarray(v, order="C").tobytes()).hexdigest()
        for k, v in flatten_tree(orbax.read_tree(d)).items()} for name, d in dirs.items()}
    data = np.random.default_rng(7).normal(0, 0.02, 60_000).astype(np.float32).tobytes()
    frames = [_zstd_frame(data, 1), _zstd_frame(data, 19, checksum=True)]
    spec = {"dirs": {k: str(v) for k, v in dirs.items()}, "frames": [f.hex() for f in frames],
            "ckpt_dirs": [str(FIXTURE), str(jax_runs.runs["plain"][0])]}
    (tmp_path / "want.json").write_text(json.dumps(spec))
    code = _REFUSING.format(banned=BANNED, want=str(tmp_path / "want.json"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    for name in dirs:
        assert got[name] == want[name], name
    assert got["frames"] == [hashlib.sha256(data).hexdigest()] * 2
    assert got["latest"] == [1, 2]


# ------------------------------------------------------------- refusals

def test_refusals_and_mixed_directories(jax_runs, folder, tmp_path):
    from yoloseries_tpu_torch.cli.val import main as val_main

    src, _ = jax_runs.runs["plain"]
    mixed = tmp_path / "ck"
    shutil.copytree(src, mixed)
    # an unfinished save is no step, and neither is a step without metadata
    shutil.copytree(mixed / "2", mixed / "5.orbax-checkpoint-tmp-123")
    shutil.copytree(mixed / "2", mixed / "6")
    (mixed / "6" / "_CHECKPOINT_METADATA").unlink()
    assert orbax.steps(mixed) == [2] and latest_step(mixed) == 2
    # the port's save prunes only its own steps, and the newest of either wins
    state, _ = restore_checkpoint(mixed, _port_state())
    for s in (3, 4):
        save_checkpoint(mixed, state, s, keep=1)
    assert orbax.steps(mixed) == [2] and latest_step(mixed) == 4
    assert sorted(p.name for p in mixed.iterdir() if (p / "state.pt").exists()) == ["4"]
    (mixed / "4" / "state.pt").unlink()
    assert latest_step(mixed) == 2
    # a layout the reader does not know raises, naming it
    zarr3 = tmp_path / "zarr3"
    shutil.copytree(src, zarr3)
    meta = zarr3 / "2" / "state" / "_METADATA"
    meta.write_text(meta.read_text().replace('"use_zarr3": false', '"use_zarr3": true'))
    with pytest.raises(ValueError, match="use_zarr3"):
        restore_checkpoint(zarr3, _port_state())
    with pytest.raises(ValueError, match="use_zarr3"):
        val_main(["--ckpt-dir", str(zarr3), "--model", MODEL, "--val-img-dir", str(folder[0]),
                  "--val-lab-dir", str(folder[1]), "--input-size", str(SIZE), "--device",
                  "cpu"])
    handler = tmp_path / "handler"
    shutil.copytree(src, handler)
    cm = handler / "2" / "_CHECKPOINT_METADATA"
    cm.write_text(cm.read_text().replace("StandardCheckpointHandler", "ProtoCheckpointHandler"))
    with pytest.raises(ValueError, match="ProtoCheckpointHandler"):
        orbax.read_tree(handler / "2")

"""The port's Orbax reader on every family's ``TrainState`` and on the
committed fixture's regeneration, against orbax and the JAX package.

* For YOLOX, YOLOv8, YOLOv7, RetinaNet (and its objectness experiment) and
  FCOS, the models of ``torch_port_ddp_families.py`` (17-44 M parameters):
  a state written by the JAX package's ``save_checkpoint`` (each leaf a
  ramp of period 251 plus its own offset, so that a leaf landing on
  another or transposed shows, and so that zstd stores it as long matches:
  the Huffman-coded literals of random weights decode at ~5 MB/s here, and
  ``test_torch_port_orbax.py`` reads those; the optimizer's traces filled
  so, its counts 1; a distinct EMA). ``utils/orbax.py::read_tree`` gives
  every leaf bit-equal to orbax's restore (``None`` at the masked leaves);
  the port's ``restore_checkpoint`` into the family's port model holds the
  weights, EMA, counts and balances, and each parameter's trace is the one
  the JAX state holds for it, in the group ``param_group_label`` gives it
  (the update's arithmetic from a restored state is held for YOLOv5 in
  ``test_torch_port_orbax.py``).
* ``tests/torch_port_orbax_fixture.py`` regenerates the committed fixture
  with the same arrays (the compressed bytes may differ between versions),
  and the zstd sample with the same content; the fixture stays under 1 MB.
"""

import hashlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_ddp_families import FAMILIES, OPTIM, port_model, spec
from torch_port_orbax_fixture import (
    FIXTURE,
    SAMPLE,
    SAMPLE_SHA256,
    sample_weights,
    state_leaves,
    write_fixture,
    write_sample,
)

from yoloseries_tpu.train.checkpoint import _state_to_tree
from yoloseries_tpu.train.checkpoint import save_checkpoint as jax_save
from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, restore_checkpoint
from yoloseries_tpu_torch.utils import orbax, zstd
from yoloseries_tpu_torch.utils.weights import (
    flatten_tree,
    jax_tree_layout,
    param_from_jax,
    state_dict_from_jax,
    state_dict_key,
)

BALANCES = np.float32([4.0, 1.0, 0.4])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ramps(shapes, scale, offset=0.0, positive=False):
    """Per leaf k of ``shapes``: (i mod 251) * scale + (k + offset) * 0.01."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    out = []
    for k, x in enumerate(leaves):
        v = (np.arange(int(np.prod(x.shape))) % 251) * scale + (k + offset) * 0.01
        out.append(np.asarray(np.abs(v) + 0.5 if positive else v, np.float32).reshape(x.shape))
    return jax.tree_util.tree_unflatten(treedef, out)


def _shapes(name):
    """The JAX model's (params, batch_stats) shapes, without compiling."""
    from yoloseries_tpu.models.fcos import FCOS
    from yoloseries_tpu.models.retinanet import RetinaNet
    from yoloseries_tpu.models.yolov5 import YOLOv5Spec
    from yoloseries_tpu.models.yolov7 import YOLOv7
    from yoloseries_tpu.models.yolov8 import YOLOv8
    from yoloseries_tpu.models.yolox import YOLOX, YOLOXSpec

    s = spec(name)
    model = eval(s["model"], {"YOLOX": YOLOX, "YOLOXSpec": YOLOXSpec,  # noqa: S307
                              "YOLOv5Spec": YOLOv5Spec, "YOLOv7": YOLOv7, "YOLOv8": YOLOv8,
                              "RetinaNet": RetinaNet, "FCOS": FCOS})
    size = s["size"]
    out = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3)), train=False))
    return out["params"], out.get("batch_stats", {})


def _orbax_restore(path, step, tree):
    import orbax.checkpoint as ocp

    with ocp.CheckpointManager(path.absolute()) as mgr:
        out = mgr.restore(step, args=ocp.args.Composite(state=ocp.args.StandardRestore(tree)))
    return SimpleNamespace(**out["state"])


def _filled(opt_state):
    """``tx.init``'s state with every trace leaf a ramp of its own and every
    count 1: the state after one update, without running optax."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(opt_state)
    out = []
    for k, (path, x) in enumerate(leaves):
        names = [str(getattr(p, "name", getattr(p, "key", ""))) for p in path]
        if "trace" in names:
            x = _ramps(jax.ShapeDtypeStruct(x.shape, x.dtype), 2e-4, 100.0 + k)
        elif jnp.issubdtype(x.dtype, jnp.integer):
            x = jnp.ones_like(x)
        out.append(jnp.asarray(x))
    return jax.tree_util.tree_unflatten(treedef, out)


def _trace_slots(opt_state, params) -> dict:
    """Port parameter name -> the trace leaf the JAX state holds for it."""
    family, depth = jax_tree_layout(params)
    slots = {}
    for path, x in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [str(getattr(p, "name", getattr(p, "key", ""))) for p in path]
        if "trace" in names:
            leaf = tuple(names[names.index("trace") + 1:])
            slots[state_dict_key(leaf, family, depth)] = param_from_jax(leaf, x)
    return slots


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_state_reads_and_restores(name, tmp_path):
    param_shapes, stat_shapes = _shapes(name)
    params = _ramps(param_shapes, 1e-3)
    stats = _ramps(stat_shapes, 1e-3, positive=True)
    tx = jax_build_optimizer(JaxOptimizerConfig(**OPTIM), params)
    opt_state = _filled(tx.init(params))
    state = SimpleNamespace(  # jax.Array leaves, as a JAX TrainState holds them
        step=jnp.int32(1), params=params, batch_stats=stats, opt_state=opt_state,
        ema_params=_ramps(param_shapes, 5e-4, 2.0), ema_batch_stats=stats,
        ema_count=jnp.float32(1.0), balances=jnp.asarray(BALANCES))
    for k in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        setattr(state, k, jax.tree_util.tree_map(jnp.asarray, getattr(state, k)))
    jax_save(tmp_path / "ck", state, 1)

    restored = _orbax_restore(tmp_path / "ck", 1, _state_to_tree(state))
    want = state_leaves(restored)
    tree = orbax.read_tree(tmp_path / "ck" / "1")
    got = {"/".join(k): v for k, v in flatten_tree(tree).items()}
    assert set(got) == set(want)
    assert any(v is None for v in want.values())
    for k, w in want.items():
        assert (got[k] is None) if w is None else (
            got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes()), k

    pstate = create_train_state(port_model(name), OptimizerConfig(**OPTIM), device="cpu")
    pstate, step = restore_checkpoint(tmp_path / "ck", pstate)
    assert step == 1 == pstate.step and pstate.ema_count == 1.0
    assert pstate.optimizer.counts == {"weight": 1, "other": 1, "bias": 1}
    assert torch.equal(pstate.balances, torch.from_numpy(BALANCES))
    sd = state_dict_from_jax(params, stats)
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    ema = state_dict_from_jax(state.ema_params, stats)
    assert all(torch.equal(pstate.ema[k], v) for k, v in ema.items())
    # every parameter's trace is its own, in the group param_group_label gives it
    slots = _trace_slots(opt_state, params)
    names = {id(p): n for n, p in pstate.model.named_parameters()}
    assert len(slots) == len(names)
    for g, group in pstate.optimizer.groups.items():
        for p, t in zip(group, pstate.optimizer.state[g]["trace"]):
            assert torch.equal(t, slots[names[id(p)]]), (g, names[id(p)])


def test_fixture_regenerates_to_the_committed_arrays(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    pytest.importorskip("zstandard")
    committed = json.loads((FIXTURE / "digests.json").read_text())
    assert write_fixture(tmp_path / "ck") == committed
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size <= 1_000_000, size
    assert zstd.decompress(write_sample(tmp_path / "sample.zst")) == sample_weights()
    assert zstd.decompress(SAMPLE.read_bytes()) == sample_weights()
    assert hashlib.sha256(sample_weights()).hexdigest() == SAMPLE_SHA256

"""The plain reference finds each detector family by name
(``reference/families/<family>.py``), and moving the two families' code
there changed none of its readings.

* Golden digests: sha256 of the seeded weights, the reference's raw maps,
  its detections and greedy's IoU counts, and one reference update (loss,
  balances, the gradient as SGD takes it, the parameters and running
  statistics after it), for every configuration, on the CPU in one thread.
  ``GOLDEN`` was taken at commit f028f6662db2, before the families' code
  left ``models.py``, ``detect.py`` and ``train.py``.
* A family added as a module under another name runs through ``forward``,
  ``build_state``, ``seeded_state``, ``detect`` and ``family_loss`` with no
  edit of the shared code.
* The shared modules of the harness name no family: no string constant in
  their code is a family's key or one of its spans.
"""

import ast
import hashlib
import importlib
import sys

import pytest
import torch

from port_bench.core import spec
from port_bench.core.weights import images_u8, seeded_state
from port_bench.drivers import train_update
from port_bench.reference import detect, models
from port_bench.reference import train as rtrain
from port_bench.tests._tiny import TINY

SEED = 2**31 + 3
SIZE = 64
BENCH = spec.load_bench()
CONFIGS = [c["name"] for c in BENCH["configs"]]
PARTS = ("state", "maps", "detect", "update")
GOLDEN = {  # at commit f028f6662db2, on the CPU, one thread
    "yolov5s": {
        "state": "f9744044f4eba6b4748a103ad8c36bcd62c4618e274b22b40453b0bdba2bcfa6",
        "maps": "4f69fe0a5b96cd3383aacea6e7dbe6ea4ac015d6854b900c8f5f5722d89810ab",
        "detect": "340a8b3010f9d2941d982f412adf96d072a4fadd084d19c0cb74b67e50866d83",
        "update": "34bcac4f2c530f343531eec16fa22cfc61ecb2d96f9b2d87170ed67610c071f0",
    },
    "yolox_s": {
        "state": "65b9863a2ef7777e877ccd1e92141681d53a6b022cb4ffbb202440bfb60e7b01",
        "maps": "02d8ccf2ac72eb5a65978a9b9773173c9a772fe52e2032b027422d99ed0834ec",
        "detect": "74044b2a74ed5ceed7cdcfdee534b3591e00358b3818a8fcedf637224742f59e",
        "update": "fcecb96e7b3084293438067ecfd1f54d224183bf7bad113198582ebc03687762",
    },
}


def _digest(items) -> str:
    """sha256 over (name, dtype, shape, bytes) of each tensor, in order."""
    h = hashlib.sha256()
    for name, t in items:
        t = torch.as_tensor(t).detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _batch():
    return torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))


def _train_traffic(name):
    """The configuration's training traffic at the tiny run's sizes."""
    for w in BENCH["workloads"]:
        t = spec.traffic(w["traffic"])
        if w["config"] == name and t["kind"] == "train_update":
            tiny = dict(TINY["train_update"])
            hyp = dict(t["hyp"], **tiny.pop("hyp"))
            return dict(t, **tiny, hyp=hyp)
    return None


def _annotations(n_rows, seed):
    """(n_rows, 8, 6) boxes [x1, y1, x2, y2, cls, row], 1-3 a row, padding -1."""
    g = torch.Generator().manual_seed(seed)
    ann = torch.full((n_rows, 8, 6), -1.0)
    for i in range(n_rows):
        n = 1 + i % 3
        xy = torch.randint(0, SIZE - 24, (n, 2), generator=g).float()
        ann[i, :n, :2] = xy
        ann[i, :n, 2:4] = xy + torch.randint(8, 24, (n, 2), generator=g).float()
        ann[i, :n, 4] = torch.randint(0, 80, (n,), generator=g).float()
        ann[i, :n, 5] = i
    return ann


def readings(cfg, part):
    """What the part's digest is taken over, on the CPU at 64 x 64."""
    sd = seeded_state(cfg, SEED, "cpu", SIZE, calib=2)
    if part == "state":
        return sorted(sd.items())
    with torch.no_grad():
        maps = models.forward(sd, _batch(), cfg)
    if part == "maps":
        return [(f"map{i}", m) for i, m in enumerate(maps)]
    if part == "detect":
        t = dict(spec.traffic("serve_b16"), num_candidates=64)
        dets, ious = detect.detect(maps, cfg, t)
        assert int((dets[..., 4] > 0).sum()) > 0  # something to compare
        return [("dets", dets), ("ious", ious)]
    t = _train_traffic(cfg["name"])
    hyp = t["hyp"]
    n = hyp["accumulate_loss_step"]
    params = {k: v.clone() for k, v in sd.items() if k in train_update._param_keys(sd)}
    bufs = {k: v.clone() for k, v in sd.items() if k not in params}
    opt = rtrain.SGD(params, train_update.optimizer_settings(t))
    loss_fn, balances = rtrain.family_loss(cfg, hyp, SIZE, "cpu")
    imgs = images_u8(SEED, 5, (n, SIZE, SIZE, 3), "cpu")
    loss, balances = rtrain.update(bufs, params, opt, cfg, loss_fn, imgs, _annotations(n, 7),
                                   balances, n // hyp["batch_size"])
    return ([("loss", torch.tensor(loss, dtype=torch.float64)), ("balances", balances)]
            + [(f"trace.{k}", v) for k, v in sorted(opt.trace.items())]
            + sorted(params.items()) + sorted(bufs.items()))


def _config(name):
    return spec.config(BENCH, name)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_readings_unchanged_by_the_move(name, part):
    torch.set_num_threads(1)
    assert _digest(readings(_config(name), part)) == GOLDEN[name][part]


def test_a_new_family_needs_no_edit(monkeypatch):
    """A copy of one family's module under another key runs through every
    entry point of the shared code, and reads as the original does."""
    torch.set_num_threads(1)
    cfg = _config(CONFIGS[0])
    original = importlib.import_module(f"port_bench.reference.families.{cfg['family']}")
    copy = type(original)("port_bench.reference.families.throwaway")
    copy.__dict__.update({k: v for k, v in vars(original).items() if not k.startswith("__")})
    monkeypatch.setitem(sys.modules, copy.__name__, copy)
    new = dict(cfg, family="throwaway")
    sd, convs = models.build_state(new, "cpu")
    assert convs == models.build_state(cfg, "cpu")[1]
    for part in PARTS:
        assert _digest(readings(new, part)) == _digest(readings(cfg, part)), part
    with pytest.raises(ModuleNotFoundError):
        models.build_state(dict(cfg, family="no_such_family"), "meta")


def _family_keys():
    folder = spec.PKG / "reference" / "families"
    return ({p.stem for p in folder.glob("*.py") if p.stem != "__init__"}
            | {_config(n)["family"] for n in CONFIGS})


def _code_strings(tree):
    """String constants of the module's code: docstrings left aside."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_shared_code_names_no_family():
    keys = _family_keys()
    assert {"yolov5", "yolox"} <= keys
    exempt = {spec.PKG / "reference" / f"{k}_loss.py" for k in keys}
    shared = [p for p in sorted(spec.PKG.rglob("*.py"))
              if p not in exempt and not p.is_relative_to(spec.PKG / "reference" / "families")
              and not p.is_relative_to(spec.PKG / "tests")]
    assert len(shared) > 30
    for path in shared:
        for s in _code_strings(ast.parse(path.read_text())):
            assert not any(s == k or s.startswith(f"{k}_loss.") for k in keys), (path, s)

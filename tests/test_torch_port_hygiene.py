"""Port hygiene: no JAX in the port, no quiet CPU fall-back, twins on CPU.

* Importing every port module (in a fresh interpreter) leaves ``jax``,
  ``flax`` and the JAX package ``yoloseries_tpu`` (the exact module name:
  it is a prefix of ``yoloseries_tpu_torch``), and the packages beneath the
  JAX package's checkpoints (``orbax``, ``tensorstore``, ``zstandard``,
  ``numcodecs``), out of ``sys.modules``; no source of the port or
  ``chip_smoke.py`` imports them; reading the committed Orbax fixture into
  a port train state loads none of them either.
* Importing the port needs no ``yaml`` and no ``cv2`` (``load_hyp`` imports
  yaml; the augmenters and the image cache import cv2 where they call it).
* Entry points raise when no card is visible unless given ``device="cpu"``.
* A kernel wrapper given CPU tensors runs its plain twin and counts no
  launch; nothing is built.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "yoloseries_tpu_torch"
BANNED = ("jax", "flax", "yoloseries_tpu", "orbax", "tensorstore", "zstandard", "numcodecs")


def _is_banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


_BANNED_LOADED = (f"BANNED = {BANNED!r}\n"
                  "bad = [m for m in sys.modules if m in BANNED\n"
                  "       or m.startswith(tuple(b + '.' for b in BANNED))]\n")


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            + _BANNED_LOADED +
            "bad += [m for m in ('yaml', 'cv2') if m in sys.modules]\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reading_an_orbax_checkpoint_loads_no_jax():
    """``restore_checkpoint`` of the committed fixture (an Orbax step the
    JAX package wrote) into a port train state, in a fresh interpreter."""
    code = ("import sys\n"
            "from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec\n"
            "from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, "
            "restore_checkpoint\n"
            "state = create_train_state(YOLOv5(1, YOLOv5Spec(1, (0, 0, 0, 0), 0)), "
            "OptimizerConfig(), device='cpu')\n"
            "state, step = restore_checkpoint('tests/data/orbax_v5_tiny', state)\n"
            "assert step == 1 == state.step, step\n"
            + _BANNED_LOADED +
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_banned(n)]
        assert not bad, f"{path.name} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from yoloseries_tpu_torch import resolve_device
    from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, yolov5_decode_fn
    from yoloseries_tpu_torch.models import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("yolov5s", num_class=3)
    model = create_model("yolov5s", num_class=3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(model, yolov5_decode_fn(), EvalConfig())
    assert Evaluator(model, yolov5_decode_fn(), EvalConfig(), device="cpu").device.type == "cpu"


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """``Trainer``, ``cli/train.py``, ``cli/val.py`` and ``cli/detect.py``
    resolve the device before they read anything else."""
    from yoloseries_tpu_torch.cli.detect import main as detect_main
    from yoloseries_tpu_torch.cli.train import main
    from yoloseries_tpu_torch.cli.val import main as val_main
    from yoloseries_tpu_torch.configs import TrainConfig
    from yoloseries_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig.from_hyp({}, num_class=3, output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, (tmp_path / "missing", tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--train-img-dir", str(tmp_path / "missing"),
              "--train-lab-dir", str(tmp_path / "missing")])
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        val_main(["--ckpt-dir", missing, "--val-img-dir", missing, "--val-lab-dir", missing])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_main(["--ckpt-dir", missing, "--img-dir", missing, "--num-class", "3"])
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on to read the data
        Trainer(cfg, (tmp_path / "missing", tmp_path / "missing"), device="cpu")
    with pytest.raises(FileNotFoundError):
        val_main(["--ckpt-dir", missing, "--val-img-dir", missing, "--val-lab-dir", missing,
                  "--device", "cpu"])


def test_wrappers_on_cpu_use_the_twins():
    from yoloseries_tpu_torch.kernels import _build, nms_greedy, nms_matrix
    from yoloseries_tpu_torch.utils import trace

    g = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 300, 2, generator=g) * 500
    boxes = torch.cat([xy, xy + 5 + 60 * torch.rand(2, 300, 2, generator=g)], -1)
    scores = torch.rand(2, 300, generator=g)
    trace.reset()
    for wrapper, twin in ((nms_greedy.nms_greedy, nms_greedy.greedy_nms),
                          (nms_matrix.matrix_nms, nms_matrix.matrix_nms_plain)):
        got = wrapper(boxes, scores, 0.5, 100)
        want = twin(boxes, scores, 0.5, 100)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(nms_matrix.nms_relation(boxes, scores, 0.5),
                       nms_matrix.nms_relation_plain(boxes, scores, 0.5))
    got = nms_matrix.matrix_nms_chunked(boxes, scores, 0.5, 100, chunk=128)
    want = nms_matrix.matrix_nms_chunked_plain(boxes, scores, 0.5, 100, chunk=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not any(name.endswith(".launches") for name in trace.totals()["counters"])
    assert _build._lib is None  # nothing was built or loaded

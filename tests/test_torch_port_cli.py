"""Port entry points and their config against the JAX package.

* ``TrainConfig.from_hyp(hyp, num_class, ...)`` from the preset in both
  packages: the same ``aug``, ``loss``, ``optim`` and ``eval`` and run
  settings; a positional class count is the class count;
* ``cli/val.py``: one set of weights written as a JAX Orbax checkpoint and
  as a port checkpoint (through ``utils/weights.py``); both mains give the
  same pickled ground truth (exactly), the same detections (one for one:
  class equal, conf within 1e-5, boxes within 2e-3 px of the original
  image, the raw maps agreeing to ~1e-5 as in ``test_torch_port_serve``),
  the same mAP line and mAP within 1e-6; EMA and raw weights, TTA;
* ``cli/detect.py --ckpt-dir`` on a port checkpoint writes what
  ``--weights`` writes on the same weights;
* the entry points' refusals: no checkpoint, both or neither weight
  source; ``--plot-dir`` writes its plots.
"""

import dataclasses
import importlib.util
import json
import pickle
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
from yoloseries_tpu.configs import load_hyp as jax_load_hyp
from yoloseries_tpu.families import get_family as jax_get_family
from yoloseries_tpu.models import create_model as jax_create_model
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.metrics import DetectionMetrics as JaxMetrics
from yoloseries_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
from yoloseries_tpu.train.state import create_train_state as jax_create_train_state
from yoloseries_tpu_torch.configs import TrainConfig, load_hyp
from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, yolov5_select_fn
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.ops.letterbox import letterbox_image
from yoloseries_tpu_torch.train import OptimizerConfig, create_train_state, save_checkpoint
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
PRESET = ROOT / "yoloseries_tpu_torch" / "configs" / "presets" / "train_yolov5.yaml"
NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 64
MODEL = "yolov5_port_cli_test"
STEP = 7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- config

def _common(port_cfg, jax_cfg):
    """The port dataclass's fields, all of which the JAX one has too."""
    port = dataclasses.asdict(port_cfg)
    jax_fields = dataclasses.asdict(jax_cfg)
    assert set(port) <= set(jax_fields), set(port) - set(jax_fields)
    return port, {k: jax_fields[k] for k in port}


def test_from_hyp_matches_jax():
    hyp = load_hyp(PRESET)
    assert hyp == jax_load_hyp(ROOT / "yoloseries_tpu" / "configs" / "presets" /
                               "train_yolov5.yaml")
    got = TrainConfig.from_hyp(dict(hyp), num_class=80, steps_per_epoch=50, batch_size=32)
    want = JaxTrainConfig.from_hyp(dict(hyp), num_class=80, steps_per_epoch=50, batch_size=32)
    for sub in ("aug", "loss", "optim", "eval"):
        a, b = _common(getattr(got, sub), getattr(want, sub))
        assert a == b, sub
    for f in dataclasses.fields(got):
        if f.name not in ("aug", "loss", "optim", "eval"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.loss.num_class == 80 and got.optim.steps_per_epoch == 50
    positional = TrainConfig.from_hyp(dict(hyp), 80)  # a class count, not steps_per_epoch
    assert positional.loss.num_class == 80 and positional.optim.steps_per_epoch == 1000



@pytest.mark.parametrize("family", ["yolov7", "retinanet", "fcos", "yolox", "yolov8"])
def test_family_presets_match_jax(family):
    """The port's copy of each family preset reads as the JAX package's,
    and the typed configs and the family's eval overrides agree."""
    from yoloseries_tpu.families import get_family as jax_family
    from yoloseries_tpu_torch.families import get_family

    name = f"train_{family}.yaml"
    hyp = load_hyp(PRESET.parent / name)
    assert hyp == jax_load_hyp(ROOT / "yoloseries_tpu" / "configs" / "presets" / name)
    got = TrainConfig.from_hyp(dict(hyp), num_class=80)
    want = JaxTrainConfig.from_hyp(dict(hyp), num_class=80)
    for sub in ("aug", "loss", "optim", "eval"):
        a, b = _common(getattr(got, sub), getattr(want, sub))
        assert a == b, sub
    a, b = _common(get_family(family).apply_eval_overrides(got.eval, hyp),
                   jax_family(family).apply_eval_overrides(want.eval, hyp))
    assert a == b


# ------------------------------------------------------------ weights

@pytest.fixture(scope="module")
def weights():
    """(ema params, raw params, batch stats) of the narrow model: its JAX
    init with the detect heads widened (kernel N(0, 0.3), bias 0) so that
    the protocol thresholds keep real candidates; the raw heads scaled by
    0.8, so that EMA and raw weights detect differently."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False))())
    ema = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(0)
    for head in ema["detect"].values():
        head["kernel"] = rng.normal(0, 0.3, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    raw = jax.tree_util.tree_map(np.copy, ema)
    for head in raw["detect"].values():
        head["kernel"] = head["kernel"] * np.float32(0.8)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxYOLOv5(num_class=num_class, spec=JaxSpec(*NARROW), dtype=dtype))
    port_register(MODEL)(lambda num_class, generator=None:
                         YOLOv5(num_class, YOLOv5Spec(*NARROW), generator=generator))
    return ema, raw, stats


@pytest.fixture(scope="module")
def checkpoints(weights, tmp_path_factory):
    """The same weights as a JAX Orbax checkpoint (built as the JAX
    ``cli/val.py`` builds its state) and as a port checkpoint, both at
    step 7."""
    ema, raw, stats = weights
    root = tmp_path_factory.mktemp("port_cli_ckpt")
    model = jax_create_model(MODEL, num_class=NC)
    _, balances = jax_get_family(MODEL).make_loss({}, NC, (SIZE, SIZE))
    tx = jax_build_optimizer(JaxOptimizerConfig(batch_size=4), model.init(
        jax.random.PRNGKey(0), np.zeros((1, SIZE, SIZE, 3), np.float32), train=False)["params"])
    state = jax_create_train_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3),
                                   balances=balances)
    state = state.replace(params=raw, batch_stats=stats, ema_params=ema, ema_batch_stats=stats)
    jax_save_checkpoint(root / "jax", state, STEP)

    port = YOLOv5(NC, YOLOv5Spec(*NARROW))
    pstate = create_train_state(port, OptimizerConfig(), state_dict=state_dict_from_jax(raw, stats))
    pstate.ema = state_dict_from_jax(ema, stats)
    pstate.step = STEP
    save_checkpoint(root / "port", pstate, STEP)
    torch.save(state_dict_from_jax(ema, stats), root / "ema.pt")
    return root


@pytest.fixture(scope="module")
def folder(weights, tmp_path_factory):
    """8 PNGs of assorted sizes; each labelled with its 3 most confident
    detections at the EMA weights (protocol thresholds), so that mAP
    scores real matches."""
    ema, _, stats = weights
    root = tmp_path_factory.mktemp("port_cli_data")
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(8):
        h, w = int(rng.integers(40, 100)), int(rng.integers(40, 100))
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(3):
            x, y = int(rng.integers(0, w - 12)), int(rng.integers(0, h - 12))
            img[y:y + 12, x:x + 12] = rng.integers(100, 256, 3)
        Image.fromarray(img).save(img_dir / f"{i:03d}.png")
        (lab_dir / f"{i:03d}.txt").write_text("")
    names = root / "names.txt"
    names.write_text("0 a\n1 b\n2 c\n")
    model = YOLOv5(NC, YOLOv5Spec(*NARROW))
    model.load_state_dict(state_dict_from_jax(ema, stats))
    cfg = EvalConfig()
    ev = Evaluator(model, None, cfg, yolov5_select_fn(cfg), device="cpu")
    paths = sorted(img_dir.iterdir())
    boxed = [letterbox_image(np.asarray(Image.open(p).convert("RGB")), (SIZE, SIZE))
             for p in paths]
    imgs = np.stack([b[0] for b in boxed])
    infos = np.stack([b[1].as_array() for b in boxed])
    for path, det in zip(paths, ev.to_host_detections(ev(imgs), infos)):
        rows = [] if det is None else det[np.argsort(-det[:, 4])]
        rows = [r for r in rows if min(r[2] - r[0], r[3] - r[1]) > 3][:3]
        assert rows, path  # every image keeps a label: val never resamples
        (lab_dir / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[5])} {r[0]:.2f} {r[1]:.2f} {r[2]:.2f} {r[3]:.2f}\n" for r in rows))
    return img_dir, lab_dir, names


# ---------------------------------------------------------------- val

def _jax_val_main():
    spec = importlib.util.spec_from_file_location("jax_cli_val", ROOT / "cli" / "val.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _match_detections(got, want, box_tol=2e-3):
    """Per image, the same detections one for one (slots matched: keepers
    whose confs differ by ulps may swap)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        free = np.ones(len(g), bool)
        for row in w:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= 1e-5)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= box_tol))
            assert close.any(), f"no match for {row}"
            free[np.argmax(close)] = False


def _map(preds, gts):
    metrics = JaxMetrics()
    for p, g in zip(preds, gts):
        metrics.add_image(g, p if len(p) else None)
    return metrics.compute()["map"]


@pytest.mark.parametrize("params, tta, max_batches", [
    ("ema", False, None),
    ("raw", False, 1),
    ("ema", True, None),
])
def test_val_mains_agree(folder, checkpoints, tmp_path, monkeypatch, capsys,
                         params, tta, max_batches):
    from yoloseries_tpu_torch.cli.val import main as port_main

    img_dir, lab_dir, names = folder
    common = ["--model", MODEL, "--val-img-dir", str(img_dir), "--val-lab-dir", str(lab_dir),
              "--name-path", str(names), "--batch-size", "4", "--input-size", str(SIZE),
              "--params", params]
    if tta:  # K = 3 x 512 candidates
        cfg = tmp_path / "val.yaml"
        cfg.write_text("val_hyp:\n  eval_num_candidates: 512\n")
        common += ["--tta", "--cfg", str(cfg)]
    if max_batches:
        common += ["--max-batches", str(max_batches)]
    # both loaders on threads: forking a process that holds JAX can deadlock
    monkeypatch.setattr(jax_data, "DataLoader", partial(jax_data.DataLoader, use_processes=False))
    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    monkeypatch.setattr("sys.argv", ["val.py", "--ckpt-dir", str(checkpoints / "jax"),
                                     "--save-pkl-dir", str(tmp_path / "jax"), *common])
    _jax_val_main()()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    out = port_main(["--ckpt-dir", str(checkpoints / "port"), "--save-pkl-dir",
                     str(tmp_path / "port"), "--device", "cpu", *common])
    printed = capsys.readouterr().out
    assert f"loaded checkpoint at step {STEP}" in printed
    assert printed.strip().splitlines()[-1] == want_line

    def load(side, name):
        with open(tmp_path / side / name, "rb") as f:
            return pickle.load(f)

    pred_name = f"pred_bbox_{SIZE}_{MODEL}.pkl"
    got_gt, want_gt = load("port", "gt_bbox.pkl"), load("jax", "gt_bbox.pkl")
    assert len(got_gt) == len(want_gt) == 4 * (max_batches or 2)
    for g, w in zip(got_gt, want_gt):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    got, want = load("port", pred_name), load("jax", pred_name)
    assert sum(len(p) for p in want) > 0
    _match_detections(got, want)
    assert abs(out["map"] - _map(got, got_gt)) <= 1e-12
    assert abs(_map(got, got_gt) - _map(want, want_gt)) <= 1e-6
    if params == "ema" and not tta:
        assert out["map50"] > 0.5, out


def test_val_refusals(folder, checkpoints, tmp_path):
    from yoloseries_tpu_torch.cli.val import main

    img_dir, lab_dir, _ = folder
    args = ["--model", MODEL, "--val-img-dir", str(img_dir), "--val-lab-dir", str(lab_dir),
            "--input-size", str(SIZE), "--device", "cpu"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--ckpt-dir", str(tmp_path / "empty"), *args])
    # --plot-dir once raised (ROADMAP A10); it now writes the plots
    out = main(["--ckpt-dir", str(checkpoints / "port"), "--plot-dir", str(tmp_path / "plots"),
                *args])
    assert out["map50"] > 0
    assert sorted(p.name for p in (tmp_path / "plots").iterdir()) == ["AP_Per_Class.png",
                                                                       "PRCurve.png"]


# ------------------------------------------------------------- detect

def test_detect_reads_port_checkpoints(folder, checkpoints, tmp_path):
    from yoloseries_tpu_torch.cli.detect import main

    img_dir, _, names = folder
    args = ["--model", MODEL, "--img-dir", str(img_dir), "--input-size", str(SIZE),
            "--batch-size", "3", "--conf", "0.05", "--device", "cpu"]
    from_ckpt = main(["--ckpt-dir", str(checkpoints / "port"), "--name-path", str(names),
                      "--save-dir", str(tmp_path / "ckpt"), *args])
    from_pt = main(["--weights", str(checkpoints / "ema.pt"), "--num-class", str(NC),
                    "--save-dir", str(tmp_path / "pt"), *args])
    assert from_ckpt == from_pt and sum(len(v) for v in from_pt.values()) > 0
    assert ((tmp_path / "ckpt" / "detections.json").read_text()
            == (tmp_path / "pt" / "detections.json").read_text())
    assert json.loads((tmp_path / "pt" / "detections.json").read_text()) == from_pt
    for bad in ([], ["--weights", "w.pt", "--ckpt-dir", str(checkpoints / "port")]):
        with pytest.raises(SystemExit):
            main([*bad, "--num-class", str(NC), *args])
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--ckpt-dir", str(tmp_path / "empty"), "--num-class", str(NC), *args])
    with pytest.raises(SystemExit, match="--name-path or --num-class"):
        main(["--ckpt-dir", str(checkpoints / "port"), *args])

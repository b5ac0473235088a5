"""Reference-checkpoint import (``cli/import_torch.py``) against the JAX package's.

* Every family with a reference layout (the narrow YOLOv5, YOLOX, YOLOv8,
  RetinaNet and FCOS of their own tests; the full YOLOv7): a blob of a seeded port
  model written as the reference's ``save_model`` dict (raw weights and a
  distinct EMA, both under DDP's ``module.`` prefix, a hyp and a step) and
  as a bare ``state_dict``. The JAX package's converter (its
  ``cli/import_torch.py::_converter``) and the port's import carry the same
  parameters and BN statistics, exactly; the EMA slot holds the blob's EMA,
  or a copy of the raw weights; the step and the hyp are recorded.
* YOLOv7 in its deploy form (``rbr_reparam``) loads into the deploy model;
  JAX's converter knows only the training form and raises ``KeyError``.
* ``yolox_darknet21`` and ``fcos_cspnet`` have no reference layout: the
  port's import refuses them with ``SystemExit``; JAX's converter, chosen by
  the name's prefix, raises ``KeyError`` on the same blob.
* The narrow YOLOv5 end to end, plain and ``--s2d-stem``: JAX's
  ``cli/import_torch.py`` + ``cli/val.py``, and the port's import +
  ``cli/val.py --ckpt-dir`` and ``cli/val.py --weights`` on the blob give
  the same detections (class equal, conf within 1e-5, boxes within 2e-3 px,
  as in ``test_torch_port_cli.py``) and the same mAP within 1e-6.

Nothing is downloaded: every blob is made here.
"""

import importlib.util
import json
import pickle
import shutil
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloseries_tpu.data as jax_data
import yoloseries_tpu_torch.data as port_data
from torch_port_families import match_detections
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.metrics import DetectionMetrics as JaxMetrics
from yoloseries_tpu_torch.evaluation import EvalConfig, Evaluator, yolov5_select_fn
from yoloseries_tpu_torch.models import (FCOS, YOLOX, RetinaNet, YOLOv5, YOLOv5Spec, YOLOv8,
                                         YOLOXSpec, create_model)
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.nn.deploy import fold_repconv
from yoloseries_tpu_torch.ops.letterbox import letterbox_image
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
NARROW = (8, (1, 1, 1, 1), 1)
LAYERS = (1, 1, 1, 1)
NC = 3
SIZE = 64
STEP = 11
V5 = "yolov5_port_import_test"  # the narrow YOLOv5, registered in both packages

_PORT_MODELS = {
    V5: lambda g: YOLOv5(NC, YOLOv5Spec(*NARROW), generator=g),
    "yolox_port_import_test": lambda g: YOLOX(NC, YOLOXSpec(YOLOv5Spec(*NARROW), 16, 1),
                                              generator=g),
    "yolov7": lambda g: create_model("yolov7", NC, device="cpu", seed=1),
    "yolov8_port_import_test": lambda g: YOLOv8(NC, 0.34, generator=g),
    "retinanet_port_import_test": lambda g: RetinaNet(NC, resnet_layers=LAYERS, generator=g),
    "fcos_port_import_test": lambda g: FCOS(NC, resnet_layers=LAYERS, generator=g),
}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    port_register(V5, knobs=("dtype", "s2d_stem"))(
        lambda num_class, generator=None, **kw: YOLOv5(num_class, YOLOv5Spec(*NARROW),
                                                        generator=generator, **kw))
    for name, make in _PORT_MODELS.items():
        if name.endswith("_test") and name != V5:
            port_register(name, knobs=("dtype",))(
                lambda num_class, generator=None, _make=make, **kw: _make(generator))
    jax_register(V5)(lambda num_class, dtype=jnp.float32, s2d_stem=False, **kw: JaxYOLOv5(
        num_class=num_class, spec=JaxSpec(*NARROW), dtype=dtype, s2d_stem=s2d_stem))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test's blobs and checkpoints (up to ~1 GB for the full-width
    models) are removed when it ends: pytest keeps the temporary folders of
    its last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", ROOT / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _perturbed(sd: dict, seed: int, scale: float) -> dict:
    """Each float tensor times (1 + scale * U(-1, 1)): positive variances
    stay positive."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (v * (1 + scale * (2 * torch.rand(v.shape, generator=gen) - 1))
                if v.is_floating_point() else v.clone()) for k, v in sd.items()}


def _blob(model, form):
    """The reference's save_model dict (raw weights with BN stats away from
    the identity, a distinct EMA, ``module.`` prefixes) or a bare
    state_dict. Returns (blob, raw, ema or None) without the prefixes."""
    raw = _perturbed(model.state_dict(), 1, 0.2)
    if form == "bare":
        return {f"module.{k}": v for k, v in raw.items()}, raw, None
    ema = _perturbed(raw, 2, 0.05)
    blob = {"model_state_dict": {f"module.{k}": v for k, v in raw.items()},
            "ema": {f"module.{k}": v for k, v in ema.items()},
            "hyp": {"batch_size": 4, "total_epoch": 300}, "step": STEP}
    return blob, raw, ema


def _jax_expected(name, sd):
    """The JAX import's (params, batch_stats) of ``sd``, back in the
    port's names."""
    params, stats = _jax_cli("import_torch")._converter(name)(sd, NC)
    return state_dict_from_jax(params, stats)


def _assert_same(got: dict, want: dict):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):  # not carried by the JAX trees
            continue
        assert got[k].dtype == w.dtype and torch.equal(got[k].cpu(), w), k


@pytest.mark.parametrize("form", ["save_model", "bare"])
@pytest.mark.parametrize("name", list(_PORT_MODELS))
def test_import_carries_the_jax_converters_parameters(name, form, tmp_path):
    from yoloseries_tpu_torch.cli.import_torch import main

    model = _PORT_MODELS[name](torch.Generator().manual_seed(0))
    blob, raw, ema = _blob(model, form)
    torch.save(blob, tmp_path / "ref.pth")
    main(["--model", name, "--pth", str(tmp_path / "ref.pth"), "--num-class", str(NC),
          "--out", str(tmp_path / "run"), "--input-size", str(SIZE), "--device", "cpu"])
    step = STEP if form == "save_model" else 1
    saved = torch.load(tmp_path / "run" / "checkpoints" / str(step) / "state.pt",
                       weights_only=True)
    assert saved["step"] == (STEP if form == "save_model" else 0)
    hyp = json.loads((tmp_path / "run" / "checkpoints" / str(step) / "hyp.json").read_text())
    assert hyp == ({"batch_size": 4, "total_epoch": 300} if form == "save_model" else {})
    want_raw = _jax_expected(name, raw)
    _assert_same(saved["model"], want_raw)
    _assert_same(saved["ema"], want_raw if ema is None else _jax_expected(name, ema))
    assert set(saved["model"]) == set(raw)  # the strict load: no name left over
    if ema is not None:
        assert not torch.equal(saved["ema"][next(iter(raw))], saved["model"][next(iter(raw))])


def test_yolov7_deploy_form(tmp_path):
    """A YOLOv7 blob in the deploy form (each RepConv as one ``rbr_reparam``
    conv) builds the deploy model and loads exactly; the JAX converter
    knows only the training form and raises ``KeyError`` on it."""
    from yoloseries_tpu_torch.cli.import_torch import main

    blob, raw, ema = _blob(fold_repconv(create_model("yolov7", NC, device="cpu", seed=1)),
                           "save_model")
    assert any("rbr_reparam" in k for k in raw)
    torch.save(blob, tmp_path / "ref.pth")
    main(["--model", "yolov7", "--pth", str(tmp_path / "ref.pth"), "--num-class", str(NC),
          "--out", str(tmp_path / "run"), "--device", "cpu"])
    saved = torch.load(tmp_path / "run" / "checkpoints" / str(STEP) / "state.pt",
                       weights_only=True)
    _assert_same(saved["model"], raw)
    _assert_same(saved["ema"], ema)
    with pytest.raises(KeyError, match="rbr_reparam"):
        _jax_expected("yolov7", raw)


@pytest.mark.parametrize("name", ["yolox_darknet21", "fcos_cspnet"])
def test_models_without_a_reference_layout_are_refused(name, tmp_path):
    from yoloseries_tpu_torch.cli.import_torch import main

    sd = create_model(name, NC, device="cpu").state_dict()
    torch.save(sd, tmp_path / "ref.pth")
    with pytest.raises(SystemExit, match="no reference state_dict layout"):
        main(["--model", name, "--pth", str(tmp_path / "ref.pth"), "--num-class", str(NC),
              "--out", str(tmp_path / "run"), "--device", "cpu"])
    # what the JAX package does with the same blob: its converter, picked by
    # the name's prefix, does not know the names
    with pytest.raises(KeyError):
        _jax_cli("import_torch")._converter(name)(sd, NC)
    with pytest.raises(SystemExit, match="no converter"):
        main(["--model", "resnet50", "--pth", str(tmp_path / "ref.pth"), "--num-class",
              str(NC), "--out", str(tmp_path / "run"), "--device", "cpu"])


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def v5_blob(tmp_path_factory):
    """The narrow YOLOv5's reference blob: detect heads widened (N(0, 0.3),
    bias 0) in the EMA so that the protocol keeps real candidates, the raw
    heads at 0.8 of them; and a PNG folder labelled with each image's 3
    most confident EMA detections."""
    root = tmp_path_factory.mktemp("port_import")
    model = YOLOv5(NC, YOLOv5Spec(*NARROW), generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for conv in (model.detect.detect_small, model.detect.detect_mid,
                     model.detect.detect_large):
            conv.weight.normal_(0, 0.3, generator=gen)
            conv.bias.zero_()
    ema = {k: v.clone() for k, v in model.state_dict().items()}
    raw = {k: (v * 0.8 if k.startswith("detect.") and k.endswith("weight") else v.clone())
           for k, v in ema.items()}
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in raw.items()},
                "ema": {f"module.{k}": v for k, v in ema.items()},
                "hyp": {"batch_size": 4}, "step": STEP}, root / "ref.pth")

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
    (root / "names.txt").write_text("0 a\n1 b\n2 c\n")
    cfg = EvalConfig()
    ev = Evaluator(model, None, cfg, yolov5_select_fn(cfg), device="cpu")
    paths = sorted(img_dir.iterdir())
    boxed = [letterbox_image(np.asarray(Image.open(p).convert("RGB")), (SIZE, SIZE))
             for p in paths]
    dets = ev.to_host_detections(ev(np.stack([b[0] for b in boxed])),
                                 np.stack([b[1].as_array() for b in boxed]))
    for path, det in zip(paths, dets):
        rows = [] if det is None else det[np.argsort(-det[:, 4])]
        rows = [r for r in rows if min(r[2] - r[0], r[3] - r[1]) > 3][:3]
        assert rows, path
        (lab_dir / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[5])} {r[0]:.2f} {r[1]:.2f} {r[2]:.2f} {r[3]:.2f}\n" for r in rows))
    return root


def _map(preds, gts):
    metrics = JaxMetrics()
    for p, g in zip(preds, gts):
        metrics.add_image(g, p if len(p) else None)
    return metrics.compute()["map"]


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d_stem"])
def test_import_then_val_matches_jax(v5_blob, s2d, tmp_path, monkeypatch, capsys):
    from yoloseries_tpu_torch.cli.import_torch import main as port_import
    from yoloseries_tpu_torch.cli.val import main as port_val

    root = v5_blob
    s2d_arg = ["--s2d-stem"] if s2d else []
    common = ["--model", V5, "--val-img-dir", str(root / "img"), "--val-lab-dir",
              str(root / "lab"), "--name-path", str(root / "names.txt"), "--batch-size", "4",
              "--input-size", str(SIZE)]
    if s2d:
        (tmp_path / "s2d.yaml").write_text("model_hyp:\n  s2d_stem: true\n")
        common += ["--cfg", str(tmp_path / "s2d.yaml")]
    # the loaders on threads: forking a process that holds JAX can deadlock
    monkeypatch.setattr(jax_data, "DataLoader", partial(jax_data.DataLoader, use_processes=False))
    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    monkeypatch.setattr("sys.argv", ["import_torch.py", "--model", V5, "--pth",
                                     str(root / "ref.pth"), "--num-class", str(NC), "--out",
                                     str(tmp_path / "jax"), "--input-size", str(SIZE), *s2d_arg])
    _jax_cli("import_torch").main()
    monkeypatch.setattr("sys.argv", ["val.py", "--ckpt-dir", str(tmp_path / "jax" / "checkpoints"),
                                     "--save-pkl-dir", str(tmp_path / "p_jax"), *common])
    _jax_cli("val").main()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]

    port_import(["--model", V5, "--pth", str(root / "ref.pth"), "--num-class", str(NC),
                 "--out", str(tmp_path / "port"), "--input-size", str(SIZE), "--device", "cpu",
                 *s2d_arg])
    outs = {"ckpt": port_val(["--ckpt-dir", str(tmp_path / "port" / "checkpoints"),
                              "--save-pkl-dir", str(tmp_path / "p_ckpt"), "--device", "cpu",
                              *common])}
    assert capsys.readouterr().out.strip().splitlines()[-1] == want_line
    outs["weights"] = port_val(["--weights", str(root / "ref.pth"), "--save-pkl-dir",
                                str(tmp_path / "p_weights"), "--device", "cpu", *common])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want_line

    def load(side, name):
        with open(tmp_path / side / name, "rb") as f:
            return pickle.load(f)

    pred_name = f"pred_bbox_{SIZE}_{V5}.pkl"
    want, want_gt = load("p_jax", pred_name), load("p_jax", "gt_bbox.pkl")
    assert sum(len(p) for p in want) > 0
    for side in ("p_ckpt", "p_weights"):
        match_detections(load(side, pred_name), want)
        assert abs(_map(load(side, pred_name), want_gt) - _map(want, want_gt)) <= 1e-6
    assert outs["ckpt"]["map"] == outs["weights"]["map"] and outs["ckpt"]["map50"] > 0

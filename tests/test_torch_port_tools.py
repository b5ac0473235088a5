"""What a user of the port's ``val``, ``detect`` and ``train`` sees, against
the JAX package: plots, drawn detections, the model summary, TensorBoard,
the profiler, and the numeric mode the entry points set.

* ``ConfusionMatrix`` and the curves that ``plot_metrics`` draws (the
  per-class AP and 101-point PR curves of ``compute``) equal JAX's to
  1e-12; both packages' plots are written, under the same names;
* ``draw_detections``/``save_detection_image``/``save_pred_vs_gt`` write
  files byte-identical to JAX's on the same detections, and
  ``detection_report`` gives the same strings; ``cli/detect.py --save-dir``
  writes each image drawn with its own detections (byte for byte a JAX
  redraw of its ``detections.json``) and prints the report;
* ``summarize_model``: parameters and parameter bytes equal JAX's exactly
  (the FLOPs count differently: see ``utils/summary.py``), the hyp table is
  JAX's string;
* the event files of the port's and the JAX ``Trainer`` with
  ``enable_tensorboard`` hold the same tags and steps over 4 updates,
  ``tot_loss`` within the Trainer test's rtol 1e-3 and the other scalars
  (its parts, the target count, the gradient norm) within 1e-2, the family
  update tests' tolerance for the gradient norm (both files read by
  TensorBoard's own reader);
  ``enable_profiler: 1`` writes a trace, and the summary heads the log;
* every entry point (``train``, ``val``, ``detect``, ``import_torch``),
  run with ``--device cpu`` after the backend flags were put back to
  PyTorch's defaults, leaves TF32 off and cuDNN's autotuner on.
"""

import importlib.util
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloseries_tpu_torch.data as port_data
from torch_port_families import NC, SIZE, write_folder
from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops import metrics as jax_metrics
from yoloseries_tpu.utils import summary as jax_summary
from yoloseries_tpu.utils import visualize as jax_vis
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec, YOLOv8
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.ops import metrics as port_metrics
from yoloseries_tpu_torch.utils import summary as port_summary
from yoloseries_tpu_torch.utils import visualize as port_vis
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
NARROW = (8, (1, 1, 1, 1), 1)
MODEL = "yolov5_port_tools_test"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _detections(seed, n_img=10):
    """(gt (N, 5), pred (M, 6)) per image, the predictions near the gt."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_img):
        n_gt, n_pred = int(rng.integers(1, 6)), int(rng.integers(1, 9))
        xy = rng.uniform(0, 80, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 30, (n_gt, 2)),
                             rng.integers(0, NC, (n_gt, 1))], 1)
        pick = rng.integers(0, n_gt, n_pred)
        boxes = gt[pick, :4] + rng.normal(0, 3, (n_pred, 4))
        cls = np.where(rng.uniform(size=n_pred) < 0.8, gt[pick, 4], rng.integers(0, NC, n_pred))
        out.append((gt, np.concatenate([boxes, rng.uniform(0.01, 1, (n_pred, 1)),
                                        cls[:, None]], 1)))
    return out


# ----------------------------------------------------------------- plots

@pytest.mark.parametrize("seed", range(2))
def test_plots_match_jax(seed, tmp_path):
    ours, theirs = port_metrics.DetectionMetrics(), jax_metrics.DetectionMetrics()
    cm_ours = port_metrics.ConfusionMatrix(NC, conf_thres=0.3)
    cm_theirs = jax_metrics.ConfusionMatrix(NC, conf_thres=0.3)
    for gt, pred in _detections(seed):
        for m in (ours, theirs, cm_ours, cm_theirs):
            m.add_image(gt, pred)
    got, want = ours.compute(), theirs.compute()
    assert len(got["pr_curves"]) == len(want["pr_curves"]) > 0
    np.testing.assert_allclose(np.stack(got["pr_curves"]), np.stack(want["pr_curves"]),
                               atol=1e-12, rtol=0)
    for k in ("ap", "unique_cls", "conf_axis"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0, err_msg=k)
    np.testing.assert_array_equal(cm_ours.matrix, cm_theirs.matrix)
    names = {0: "a", 1: "b", 2: "c"}
    for side, mod, out, cm in (("port", port_metrics, got, cm_ours),
                               ("jax", jax_metrics, want, cm_theirs)):
        mod.plot_metrics(out, tmp_path / side, cls2lab=names)
        cm.plot(tmp_path / side / "confusion.png", names=list(names.values()))
    listing = {side: sorted(p.name for p in (tmp_path / side).iterdir())
               for side in ("port", "jax")}
    assert listing["port"] == listing["jax"] == ["AP_Per_Class.png", "PRCurve.png",
                                                  "confusion.png"]
    for p in (tmp_path / "port").iterdir():
        assert Image.open(p).size == Image.open(tmp_path / "jax" / p.name).size


# --------------------------------------------------------------- drawing

def test_drawing_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    names = ["person", "car", "thing"]
    (gt, pred), = _detections(5, 1)
    pred[:, :4] *= 1.3
    for dets in (pred, None, pred[:0]):
        for nm in (names, None):
            a = port_vis.draw_detections(img, dets, nm)
            b = jax_vis.draw_detections(img, dets, nm)
            assert a.tobytes() == b.tobytes()
            assert port_vis.detection_report(dets, nm) == jax_vis.detection_report(dets, nm)
    np.testing.assert_array_equal(port_vis.class_colors(80), jax_vis.class_colors(80))
    port_vis.save_detection_image(img, pred, tmp_path / "p" / "a.png", names)
    jax_vis.save_detection_image(img, pred, tmp_path / "j" / "a.png", names)
    port_vis.save_pred_vs_gt(img, pred, gt, tmp_path / "p" / "b.png", names)
    jax_vis.save_pred_vs_gt(img, pred, gt, tmp_path / "j" / "b.png", names)
    for name in ("a.png", "b.png"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_detect_draws_its_detections(tmp_path, capsys):
    from yoloseries_tpu_torch.cli.detect import main

    img_dir, _, names = write_folder(tmp_path / "data", n=5, seed=2)
    model = YOLOv5(NC, YOLOv5Spec(*NARROW), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # detect heads widened: detections at conf .05
        for conv in (model.detect.detect_small, model.detect.detect_mid,
                     model.detect.detect_large):
            conv.weight.normal_(0, 0.3, generator=torch.Generator().manual_seed(0))
            conv.bias.zero_()
    torch.save(model.state_dict(), tmp_path / "w.pt")
    port_register(MODEL)(lambda num_class, generator=None, **kw:
                         YOLOv5(num_class, YOLOv5Spec(*NARROW), generator=generator, **kw))
    main(["--model", MODEL, "--weights", str(tmp_path / "w.pt"), "--img-dir", str(img_dir),
          "--save-dir", str(tmp_path / "out"), "--name-path", str(names), "--input-size",
          str(SIZE), "--batch-size", "2", "--conf", "0.05", "--device", "cpu"])
    printed = capsys.readouterr().out
    results = json.loads((tmp_path / "out" / "detections.json").read_text())
    table = ["a", "b", "c"]
    assert sum(len(v) for v in results.values()) > 0
    for p in sorted(img_dir.iterdir()):
        dets = np.asarray(results[p.name], np.float64).reshape(-1, 6)
        raw = np.asarray(Image.open(p).convert("RGB"))
        jax_vis.save_detection_image(raw, dets if len(dets) else None,
                                     tmp_path / "jax" / p.name, table)
        assert (tmp_path / "out" / p.name).read_bytes() == (tmp_path / "jax" / p.name).read_bytes()
        report = jax_vis.detection_report(dets if len(dets) else None, table)
        assert f"{p.name}: {report} ({len(dets)} boxes," in printed


# --------------------------------------------------------------- summary

def test_summary_counts_match_jax():
    jax_model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    want = jax_summary.summarize_model(jax_model, (1, SIZE, SIZE, 3))
    got = port_summary.summarize_model(YOLOv5(NC, YOLOv5Spec(*NARROW)), (1, 3, SIZE, SIZE))
    assert (got["params"], got["param_bytes"]) == (want["params"], want["param_bytes"])
    # two counts of the same forward, by different rules: near, not equal
    assert 0.5 < got["gflops"] / want["gflops"] < 2.0, (got, want)
    v8 = port_summary.summarize_model(YOLOv8(NC, 0.34), (1, 3, SIZE, SIZE))
    assert v8["params"] == sum(p.numel() for p in YOLOv8(NC, 0.34).parameters())
    hyp = {"lr": 0.01, "name": "x" * 70, "batch_size": 8}
    assert port_summary.format_hyp_table(hyp) == jax_summary.format_hyp_table(hyp)
    assert port_summary.format_hyp_table({}) == jax_summary.format_hyp_table({})


# ----------------------------------------------------- TensorBoard, profiler

def test_tensorboard_and_profiler_match_jax(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from yoloseries_tpu.train import Trainer as JaxTrainer
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = write_folder(tmp_path / "data", n=8, seed=0)
    jmodel = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False))())
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxYOLOv5(num_class=num_class, spec=JaxSpec(*NARROW), dtype=dtype))

    def port_model(num_class, generator=None):
        m = YOLOv5(num_class, YOLOv5Spec(*NARROW), generator=generator)
        m.load_state_dict(state_dict_from_jax(params, stats))
        return m

    port_register(MODEL)(port_model)
    hyp = {"input_img_size": [SIZE, SIZE], "batch_size": 2, "accumulate_loss_step": 4,
           "total_epoch": 2, "no_data_aug_epoch": 2, "warmup_steps": 3, "num_workers": 1,
           "save_ckpt_every": 100, "random_seed": 3, "enable_tensorboard": True,
           "save_log_every": 1, "data_aug_mosaic_p": 0.0, "data_aug_mixup_p": 0.0,
           "data_aug_prespective_p": 0.0, "data_aug_hsv_p": 0.0, "data_aug_cutout_p": 0.0,
           "data_aug_fliplr_p": 0.0}
    jcfg = JaxTrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                   output_dir=str(tmp_path / "jax"))
    pcfg = TrainConfig.from_hyp({**hyp, "enable_profiler": 1}, num_class=NC, model=MODEL,
                                max_labels=8, output_dir=str(tmp_path / "port"))
    jtr = JaxTrainer(jcfg, (img_dir, lab_dir), names_path=names, log_fn=lambda *a: None)
    ptr = Trainer(pcfg, (img_dir, lab_dir), names_path=names, log_fn=lambda *a: None,
                  device="cpu")
    try:
        put = jax.device_put
        jtr.state = jtr.state.replace(params=put(params), ema_params=put(params),
                                      batch_stats=put(stats), ema_batch_stats=put(stats))
        jtr.train()
        ptr.train()
    finally:
        jtr.close()
        ptr.close()
        if jtr.writer is not None:
            jtr.writer.close()

    def scalars(side):
        acc = EventAccumulator(str(tmp_path / side / "tb"))
        acc.Reload()
        return {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}

    got, want = scalars("port"), scalars("jax")
    assert set(got) == set(want) and "train/tot_loss" in got
    for tag, rows in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in rows] == [0, 1, 2, 3], tag  # 4 updates
        rtol = 1e-3 if tag == "train/tot_loss" else 1e-2  # as the Trainer and family tests
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in rows], rtol=rtol,
                                   atol=1e-6, err_msg=tag)
    trace = tmp_path / "port" / "profile" / "trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]
    log = (tmp_path / "port" / "log" / "log_rank_0" / "train.log").read_text()
    assert f"model {MODEL}: {sum(p.numel() for p in ptr.model.parameters()):,} params" in log
    assert jax_summary.format_hyp_table(pcfg.hyp) in log


# ---------------------------------------------------------- numeric mode

def _defaults():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.benchmark = False


def _assert_r1():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.benchmark is True


def test_entry_points_set_the_numeric_mode(tmp_path, monkeypatch):
    from yoloseries_tpu_torch.cli import detect, import_torch, train, val
    from yoloseries_tpu_torch.train import latest_step

    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    img_dir, lab_dir, names = write_folder(tmp_path / "data", n=4, seed=1)
    port_register(MODEL)(lambda num_class, generator=None, **kw:
                         YOLOv5(num_class, YOLOv5Spec(*NARROW), generator=generator, **kw))
    cfg = tmp_path / "hyp.yaml"
    cfg.write_text("train_hyp:\n  num_workers: 1\n  save_log_txt: false\n")
    common = ["--model", MODEL, "--device", "cpu"]
    try:
        _defaults()
        train.main([*common, "--cfg", str(cfg), "--train-img-dir", str(img_dir),
                    "--train-lab-dir", str(lab_dir), "--name-path", str(names),
                    "--batch-size", "2", "--total-epoch", "1", "--input-size", str(SIZE),
                    "--output-dir", str(tmp_path / "run")])
        _assert_r1()
        ckpt = tmp_path / "run" / "checkpoints"
        assert latest_step(ckpt) == 2
        _defaults()
        val.main([*common, "--ckpt-dir", str(ckpt), "--val-img-dir", str(img_dir),
                  "--val-lab-dir", str(lab_dir), "--name-path", str(names), "--batch-size",
                  "2", "--input-size", str(SIZE)])
        _assert_r1()
        _defaults()
        detect.main([*common, "--ckpt-dir", str(ckpt), "--img-dir", str(img_dir),
                     "--save-dir", str(tmp_path / "det"), "--num-class", str(NC),
                     "--input-size", str(SIZE)])
        _assert_r1()
        torch.save(YOLOv5(NC, YOLOv5Spec(*NARROW)).state_dict(), tmp_path / "ref.pth")
        _defaults()
        import_torch.main([*common, "--pth", str(tmp_path / "ref.pth"), "--num-class", str(NC),
                           "--out", str(tmp_path / "imp")])
        _assert_r1()
    finally:
        _defaults()
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's own default

"""Port training loop and mAP pass (yoloseries_tpu_torch.train.Trainer,
data, ops.metrics) against the JAX package.

* ``DetectionMetrics.compute`` and ``ConfusionMatrix`` on the same
  detection lists, to 1e-9;
* ``collate_batch`` and ``DataLoader`` batches byte-identical for one seed;
* a ``Trainer`` end to end on a tiny PNG folder set: 2 epochs x 2 updates
  (B=2, accumulate 2, warmup active, augmentation closed), both packages
  with the same narrow YOLOv5 registered under one name and the same
  starting weights (detect heads widened so that ``evaluate()`` sees real
  candidates). Per-update ``tot_loss`` within rtol 1e-3, the ``evaluate()``
  metrics equal to 1e-6; the port's NMS took the B1 branch
  (``nms_greedy``, K=4096); then the same with the preset's augmentation
  and the image cache, closed for the last epoch;
* the Trainer raises, naming the ROADMAP item, for each setting that needs
  a module not ported yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yoloseries_tpu.configs import TrainConfig as JaxTrainConfig
from yoloseries_tpu.data.dataset import DetectionDataset as JaxDataset
from yoloseries_tpu.data.loader import DataLoader as JaxLoader
from yoloseries_tpu.data.loader import collate_batch as jax_collate
from yoloseries_tpu.models.registry import register as jax_register
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.ops.metrics import ConfusionMatrix as JaxConfusion
from yoloseries_tpu.ops.metrics import DetectionMetrics as JaxMetrics
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.data import DataLoader, DetectionDataset, collate_batch
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec
from yoloseries_tpu_torch.models import register as port_register
from yoloseries_tpu_torch.ops.metrics import ConfusionMatrix, DetectionMetrics
from yoloseries_tpu_torch.utils.weights import state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 64
MODEL = "yolov5_port_trainer_test"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """8 PNG images of assorted sizes with 1-4 boxes each, and names.txt."""
    root = tmp_path_factory.mktemp("port_trainer")
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, NC))
            img[y1:y1 + bh, x1:x1 + bw] = (200, 60 + 60 * c, 40)
            lines.append(f"{c} {x1} {y1} {x1 + bw} {y1 + bh}")
        Image.fromarray(img).save(img_dir / f"{i:03d}.png")
        (lab_dir / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    names = root / "names.txt"
    names.write_text("0 a\n1 b\n2 c\n")
    return img_dir, lab_dir, names


# ------------------------------------------------------------- metrics

def _detections(seed, n_img=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        n_gt, n_pred = rng.integers(0, 6), rng.integers(0, 9)
        if i == 0:
            n_gt = 0  # an image without gt
        if i == 1:
            n_pred = 0  # an image without predictions
        xy = rng.uniform(0, 80, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 30, (n_gt, 2)),
                             rng.integers(0, NC, (n_gt, 1))], 1)
        pick = rng.integers(0, max(n_gt, 1), n_pred)
        base = gt[pick, :4] if n_gt else rng.uniform(0, 80, (n_pred, 4))
        boxes = base + rng.normal(0, 3, (n_pred, 4))
        cls = np.where(rng.uniform(size=n_pred) < 0.8,
                       gt[pick, 4] if n_gt else 0, rng.integers(0, NC, n_pred))
        pred = np.concatenate([boxes, rng.uniform(0.01, 1, (n_pred, 1)), cls[:, None]], 1)
        out.append((gt, pred))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_jax(seed):
    ours, theirs = DetectionMetrics(), JaxMetrics()
    cm_ours, cm_theirs = ConfusionMatrix(NC), JaxConfusion(NC)
    for gt, pred in _detections(seed):
        ours.add_image(gt, pred)
        theirs.add_image(gt, pred)
        cm_ours.add_image(gt, pred)
        cm_theirs.add_image(gt, pred)
    got, want = ours.compute(), theirs.compute()
    for k in ("map", "map50", "mp", "mr"):
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert want["map50"] > 0
    for k in ("ap", "unique_cls", "precision", "recall", "f1"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["pr_curves"]), np.asarray(want["pr_curves"]),
                               atol=1e-9, rtol=0)
    np.testing.assert_array_equal(cm_ours.matrix, cm_theirs.matrix)
    assert DetectionMetrics().compute()["map"] == JaxMetrics().compute()["map"] == 0.0


# -------------------------------------------------------------- batches

def test_collate_is_byte_identical():
    rng = np.random.default_rng(4)
    samples = []
    for i in range(5):
        h, w = rng.integers(20, 200, 2)
        n = int(rng.integers(0, 7))
        xy = rng.uniform(0, min(h, w) / 2, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(2, min(h, w) / 2, (n, 2))], 1)
        samples.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                        boxes.astype(np.float32), rng.integers(0, NC, n).astype(np.float32)))
    for size, m in ((64, 4), ((96, 128), 8)):
        got = collate_batch(samples, size, m)
        want = jax_collate(samples, size, m)
        assert got["n_dropped"] == want["n_dropped"]
        for k in ("img", "ann", "info"):
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_loader_batches_are_byte_identical(folder):
    img_dir, lab_dir, names = folder
    ours = DataLoader(DetectionDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE)),
                      batch_size=3, max_labels=6, seed=11, workers=2, use_processes=False)
    theirs = JaxLoader(JaxDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE),
                                  enable_aug=False),
                       batch_size=3, max_labels=6, seed=11, workers=2, use_processes=False)
    try:
        for _ in range(4):  # past the first epoch's end: the next permutation
            got, want = next(ours), next(theirs)
            for k in ("img", "ann", "info"):
                assert got[k].tobytes() == want[k].tobytes(), k
        ours.set_input_size(96)
        theirs.set_input_size(96)
        shapes = set()
        for _ in range(4):  # already prefetched batches may still be 64 px
            got, want = next(ours), next(theirs)
            if got["img"].shape == want["img"].shape:
                assert got["img"].tobytes() == want["img"].tobytes()
            shapes.add(got["img"].shape[1])
        assert 96 in shapes
    finally:
        ours.stop()
        theirs.stop()
    val = DataLoader(DetectionDataset(img_dir, lab_dir, names, input_size=(SIZE, SIZE)),
                     batch_size=3, max_labels=6, shuffle=False, infinite=False,
                     use_processes=False)
    first = [b["img"].tobytes() for b in val]
    val.restart()
    assert [b["img"].tobytes() for b in val] == first and len(first) == len(val) == 2
    val.stop()


# --------------------------------------------------------- the Trainer

def _hyp():
    return {
        "input_img_size": [SIZE, SIZE], "batch_size": 2, "accumulate_loss_step": 4,
        "total_epoch": 2, "no_data_aug_epoch": 2, "warmup_steps": 3, "num_workers": 1,
        "save_log_txt": False, "save_ckpt_every": 100, "random_seed": 3,
        "data_aug_mosaic_p": 0.0, "data_aug_mixup_p": 0.0, "data_aug_prespective_p": 0.0,
        "data_aug_hsv_p": 0.0, "data_aug_cutout_p": 0.0, "data_aug_fliplr_p": 0.0,
        "compute_metric_conf_threshold": 0.001, "eval_num_candidates": 4096,
    }


@pytest.fixture(scope="module")
def start_weights():
    """The JAX init of the narrow model (the JAX Trainer's own seed), with
    the detect heads widened (kernel N(0, 0.3), bias 0) so that the val
    pass has scores above the protocol's thresholds."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False))())
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(0)
    for head in params["detect"].values():
        head["kernel"] = rng.normal(0, 0.3, head["kernel"].shape).astype(np.float32)
        head["bias"] = np.zeros_like(head["bias"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return params, stats


def _register(params, stats):
    jax_register(MODEL)(lambda num_class, dtype=jnp.float32, **kw:
                        JaxYOLOv5(num_class=num_class, spec=JaxSpec(*NARROW), dtype=dtype))

    def port_model(num_class, generator=None):
        m = YOLOv5(num_class, YOLOv5Spec(*NARROW), generator=generator)
        m.load_state_dict(state_dict_from_jax(params, stats))
        return m

    port_register(MODEL)(port_model)


def _label_from_detections(trainer, img_dir, names, lab_dir, per_image=3):
    """Label files holding each image's ``per_image`` most confident
    detections of ``trainer``'s evaluator at its eval weights (boxes that
    the dataset's filters keep)."""
    lab_dir.mkdir()
    trainer._eval_model.load_state_dict(trainer.eval_variables())
    ds = DetectionDataset(img_dir, img_dir.parent / "lab", names, input_size=(SIZE, SIZE))
    loader = DataLoader(ds, batch_size=len(ds), max_labels=8, shuffle=False, infinite=False,
                        use_processes=False)
    batch = next(loader)
    loader.stop()
    dets = trainer.evaluator(batch["img"])
    for path, det in zip(ds.img_files, trainer.evaluator.to_host_detections(dets, batch["info"])):
        rows = [] if det is None else det[np.argsort(-det[:, 4])]
        rows = [r for r in rows if min(r[2] - r[0], r[3] - r[1]) > 3][:per_image]
        (lab_dir / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[5])} {r[0]:.2f} {r[1]:.2f} {r[2]:.2f} {r[3]:.2f}\n" for r in rows))
    return lab_dir


def test_trainer_matches_jax(folder, start_weights, tmp_path, monkeypatch):
    from yoloseries_tpu.train import Trainer as JaxTrainer
    from yoloseries_tpu_torch.ops import nms as port_nms
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = folder
    params, stats = start_weights
    _register(params, stats)
    calls = []
    greedy = port_nms.nms_greedy

    def spy(boxes, scores, thr, max_keep):
        calls.append(tuple(scores.shape))
        return greedy(boxes, scores, thr, max_keep)

    monkeypatch.setattr(port_nms, "nms_greedy", spy)

    jcfg = JaxTrainConfig.from_hyp(_hyp(), num_class=NC, model=MODEL, max_labels=8,
                                   output_dir=str(tmp_path / "jax"))
    pcfg = TrainConfig.from_hyp(_hyp(), num_class=NC, model=MODEL, max_labels=8,
                                output_dir=str(tmp_path / "port"))
    jtr = JaxTrainer(jcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                     log_fn=lambda *a: None)
    ptr = Trainer(pcfg, (img_dir, lab_dir), val_dirs=(img_dir, lab_dir), names_path=names,
                  log_fn=lambda *a: None, device="cpu")
    try:
        assert jtr.steps_per_epoch == ptr.steps_per_epoch == 2
        put = jax.device_put  # separate buffers: the JAX step donates its state
        jtr.state = jtr.state.replace(params=put(params), ema_params=put(params),
                                      batch_stats=put(stats), ema_batch_stats=put(stats))
        jtr.train()
        want_losses = list(jtr.meters["tot_loss"]._window)  # every update: 4 < window
        ptr.train()
        got_losses = [h["tot_loss"] for h in ptr.history]
        # val labels: the port's own top detections at the trained EMA
        # weights, so that both mAP passes score real matches
        val_lab = _label_from_detections(ptr, img_dir, names, tmp_path / "val_lab")
        jtr.val_dataset = JaxDataset(img_dir, val_lab, names, input_size=(SIZE, SIZE),
                                     enable_aug=False)
        ptr.val_dataset = DetectionDataset(img_dir, val_lab, names, input_size=(SIZE, SIZE))
        want = jtr.evaluate()
        got = ptr.evaluate()
    finally:
        jtr.close()
        ptr.close()
    assert len(want_losses) == len(got_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert ptr.state.step == int(jtr.state.step) == 4
    for k in ("map", "map50", "mp", "mr"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["map50"] > 0.5, got["map50"]
    assert calls and all(k == 4096 for _, k in calls)  # B1: 1024 < K <= 8192


def test_trainer_with_augmentation_and_cache_matches_jax(folder, start_weights, tmp_path):
    """The preset's augmentation probabilities and the image cache, closed
    for the last of 2 epochs: the same 4 losses in both packages. The
    loader has made its prefetched batches before the close, so all 4 are
    augmented in both; the close saves a checkpoint at step 2."""
    import shutil

    from yoloseries_tpu.train import Trainer as JaxTrainer
    from yoloseries_tpu_torch.train import Trainer, latest_step

    img_dir, lab_dir, names = folder
    port_data = tmp_path / "port_data"  # its own cache file, built cold
    shutil.copytree(img_dir, port_data / "img")
    params, stats = start_weights
    _register(params, stats)
    hyp = {k: v for k, v in _hyp().items() if not k.startswith("data_aug_")}
    hyp.update(no_data_aug_epoch=1, cache_images=True)
    jcfg = JaxTrainConfig.from_hyp(hyp, num_class=NC, model=MODEL, max_labels=8,
                                   output_dir=str(tmp_path / "jax"))
    pcfg = TrainConfig.from_hyp(hyp, NC, model=MODEL, max_labels=8,
                                output_dir=str(tmp_path / "port"))
    assert pcfg.aug == type(pcfg.aug)(**jcfg.aug.__dict__) and pcfg.aug.mosaic_p == 1.0
    jtr = JaxTrainer(jcfg, (img_dir, lab_dir), names_path=names, log_fn=lambda *a: None)
    ptr = Trainer(pcfg, (port_data / "img", lab_dir), names_path=names,
                  log_fn=lambda *a: None, device="cpu")
    try:
        assert ptr.train_dataset.enable_aug and ptr.train_dataset.cached_canvas
        assert (port_data / "img_img_cache_h64_w64_8.shapes.npy").exists()
        put = jax.device_put
        jtr.state = jtr.state.replace(params=put(params), ema_params=put(params),
                                      batch_stats=put(stats), ema_batch_stats=put(stats))
        jtr.train()
        want_losses = list(jtr.meters["tot_loss"]._window)
        ptr.train()
        got_losses = [h["tot_loss"] for h in ptr.history]
    finally:
        jtr.close()
        ptr.close()
    assert len(want_losses) == len(got_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert not ptr.train_loader._enable_aug and not jtr.train_loader._enable_aug
    assert latest_step(tmp_path / "port" / "checkpoints") == 2


@pytest.mark.parametrize("hyp, dtype, item", [
    ({"per_replica_bn": True}, torch.float32, "A8"),
])
def test_trainer_raises_for_what_is_not_ported(folder, tmp_path, hyp, dtype, item):
    """A setting that needs a module not ported yet raises at construction,
    naming its ROADMAP item (the card check is in the hygiene tests);
    ``remat``, ``s2d_stem`` and bf16 are ported
    (``tests/test_torch_port_train_knobs.py``)."""
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = folder
    cfg = TrainConfig.from_hyp({**_hyp(), **hyp}, num_class=NC, output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}\)"):
        Trainer(cfg, (img_dir, lab_dir), names_path=names, compute_dtype=dtype, device="cpu")

"""The training knobs of the port against the JAX package: remat, the s2d
stem and bf16 compute, through ``make_train_step``, the ``Trainer`` and
``cli/val.py``.

* remat against no remat, the port alone: two updates of a narrow YOLOv5
  (B=4, accumulate 2) from the same weights and batches; the losses, the
  parameters and the BN buffers (running stats and ``num_batches_tracked``:
  the recompute must not move them a second time) within 1e-5;
* the s2d stem: two updates of the port's s2d model against the JAX s2d
  model (``fold_stem_to_s2d`` of the same weights), f32: ``tot_loss``
  within rtol 1e-4, parameters and BN stats within 1e-4 * max(1, |ref|),
  the bounds of ``tests/test_torch_port_train.py``;
* bf16 (the image cast before the /255 in both), against the jitted JAX
  bf16 model and step: the train-mode maps on both micro-batches of the
  first update as far from the f32 maps as JAX's (std of the difference,
  0.5x-1.5x per stage); the first update's ``tot_loss`` within 2e-2
  relative; after two updates ``tar_nums`` equal, and the parameters and
  BN stats as far from f32 as JAX's (median leaf, 0.5x-1.5x); everything
  f32 and finite. The port rounds once per block where JAX on the CPU
  rounds every op, so its maps lie closer to f32 (0.53-0.70x). Train-mode
  BN divides each rounding by the batch's deviation, so on this narrow
  model bf16 moves the loss 6-7% from f32; the second update's losses,
  from weights the first bf16 updates moved apart, differ by 2.2% and are
  not held to 2e-2 (ROADMAP section C);
* the ``Trainer`` with ``remat``, ``s2d_stem`` and bf16 builds the model
  with those knobs and trains one update (finite losses, f32 parameters);
* ``cli/val.py`` with ``s2d_stem: true`` in the hyp on an s2d checkpoint
  scores what the 6x6 checkpoint of the same weights scores: the same
  detections (conf 1e-5, boxes 1e-3 px) and mAP within 1e-6.
"""

import copy
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yoloseries_tpu_torch.data as port_data
from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig as JaxLossConfig
from yoloseries_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yoloseries_tpu.models.yolov5 import YOLOv5Spec as JaxSpec
from yoloseries_tpu.nn.deploy import fold_stem_to_s2d as jax_fold_stem_to_s2d
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from yoloseries_tpu.train.optim import build_optimizer as jax_build_optimizer
from yoloseries_tpu.train.state import create_train_state as jax_create_state
from yoloseries_tpu.train.state import make_train_step as jax_make_step
from yoloseries_tpu_torch.configs import TrainConfig
from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig
from yoloseries_tpu_torch.models import YOLOv5, YOLOv5Spec, create_model
from yoloseries_tpu_torch.nn.deploy import fold_stem_to_s2d
from yoloseries_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
    save_checkpoint,
)
from yoloseries_tpu_torch.utils.weights import flatten_tree, state_dict_from_jax

NARROW = (8, (1, 1, 1, 1), 1)
NC = 3
SIZE = 64
STEP_TOL = 1e-4
REMAT_TOL = 1e-5
BF16_LOSS_TOL = 2e-2  # the first update's bf16 tot_loss against JAX's, relative
BF16_DRIFT = (0.5, 1.5)  # distance from f32, port / JAX: train-mode maps; parameters (median)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_vars():
    """The narrow JAX YOLOv5's params (init plus N(0, 0.02) noise) and BN
    stats, as numpy trees."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                           train=False))()
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["batch_stats"]))
    return params, stats


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    ann = np.full((n, 8, 6), -1.0, np.float32)
    for b in range(n):
        k = rng.integers(1, 9)
        xy = rng.uniform(0, SIZE - 12, (k, 2))
        ann[b, :k, :2] = xy
        ann[b, :k, 2:4] = np.minimum(xy + rng.uniform(6, SIZE / 2, (k, 2)), SIZE)
        ann[b, :k, 4] = rng.integers(0, NC, k)
        ann[b, :k, 5] = b
    return img, ann


OPT = dict(batch_size=4, steps_per_epoch=2, total_epochs=4, warmup_steps_override=5)


def _port_state(params, stats, **model_kw):
    model = YOLOv5(NC, YOLOv5Spec(*NARROW), **model_kw)
    return create_train_state(model, OptimizerConfig(**OPT),
                              state_dict=state_dict_from_jax(params, stats), device="cpu")


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


# ---------------------------------------------------------------- remat

def test_remat_matches_no_remat(jax_vars):
    params, stats = jax_vars
    loss = YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE))
    step = make_train_step(loss, YOLOV5_ANCHORS, accumulate=2)
    plain, remat = _port_state(params, stats), _port_state(params, stats, remat=True)
    assert remat.model.remat and not plain.model.remat
    for i in range(2):
        img, ann = _batch(10 + i, 8)
        batch = {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)}
        plain, m_plain = step(plain, batch)
        remat, m_remat = step(remat, batch)
        for k in m_plain:
            np.testing.assert_allclose(float(m_remat[k]), float(m_plain[k]), rtol=REMAT_TOL,
                                       atol=REMAT_TOL, err_msg=k)
    want, got = plain.model.state_dict(), remat.model.state_dict()
    assert int(got["backbone_stage1_bscp.cba1.bn.num_batches_tracked"]) == 4  # 2 x accumulate
    for k, v in want.items():
        np.testing.assert_allclose(got[k].double().numpy(), v.double().numpy(), rtol=REMAT_TOL,
                                   atol=REMAT_TOL, err_msg=k)


# ------------------------------------------------------ s2d stem and bf16

def _two_updates(params, stats, jax_params, jax_model_kw, port_model_kw, dtype):
    """Two updates (B=4, accumulate 2) of the JAX and the port narrow model
    from the same weights; returns the per-update metrics and both states."""
    model = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW), **jax_model_kw)
    tx = jax_build_optimizer(JaxOptimizerConfig(**OPT), jax_params)
    jstate = jax_create_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    jstate = jstate.replace(params=jax_params, batch_stats=stats,
                            opt_state=tx.init(jax_params), ema_params=jax_params,
                            ema_batch_stats=stats)
    pstate = create_train_state(YOLOv5(NC, YOLOv5Spec(*NARROW), **port_model_kw),
                                OptimizerConfig(**OPT), state_dict=state_dict_from_jax(
                                    jax_params, stats), device="cpu")
    jstep = jax_make_step(JaxLossConfig(num_class=NC, input_size=(SIZE, SIZE)), YOLOV5_ANCHORS,
                          accumulate=2, donate=False, compute_dtype=jax_model_kw.get(
                              "dtype", jnp.float32))
    pstep = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                            YOLOV5_ANCHORS, accumulate=2, compute_dtype=dtype)
    history = []
    for i in range(2):
        img, ann = _batch(20 + i, 8)
        jstate, jm = jstep(jstate, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
        pstate, pm = pstep(pstate, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        history.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in pm.items()}))
    return history, jstate, pstate


def test_s2d_stem_updates_match_jax(jax_vars):
    params, stats = jax_vars
    s2d_params = jax.device_get(jax_fold_stem_to_s2d(params))
    history, jstate, pstate = _two_updates(params, stats, s2d_params, {"s2d_stem": True},
                                           {"s2d_stem": True}, torch.float32)
    for want, got in history:
        assert abs(got["tot_loss"] - want["tot_loss"]) <= STEP_TOL * abs(want["tot_loss"])
    want = {**state_dict_from_jax(jax.device_get(jstate.params),
                                  jax.device_get(jstate.batch_stats))}
    got = pstate.model.state_dict()
    assert tuple(got["focus.conv.weight"].shape) == (8, 12, 3, 3)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert _rel(got[k].numpy(), v.numpy()) <= STEP_TOL, k
    # the s2d weights map back to the 6x6 model's layout and train alike
    assert set(flatten_tree(jax.device_get(jstate.params))) == set(flatten_tree(s2d_params))


def test_bf16_updates_match_jax(jax_vars):
    params, stats = jax_vars
    # the train-mode forward on both micro-batches of the first update,
    # against the jitted JAX model: the port's maps lie about as far from the
    # f32 maps (the port's f32 model, held to JAX's in
    # tests/test_torch_port_yolov5.py) as JAX's do (BF16_DRIFT, per stage)
    img, _ = _batch(20, 8)
    jmodel = JaxYOLOv5(num_class=NC, spec=JaxSpec(*NARROW), dtype=jnp.bfloat16)
    forward = jax.jit(lambda x: jmodel.apply(
        {"params": params, "batch_stats": stats},
        x.astype(jnp.bfloat16) / jnp.asarray(255.0, jnp.bfloat16), train=True,
        mutable=["batch_stats"])[0])
    report = []
    for sl in (slice(0, 4), slice(4, 8)):
        x = torch.from_numpy(img[sl]).permute(0, 3, 1, 2)
        jout = forward(jnp.asarray(img[sl]))
        with torch.no_grad():
            want = _port_state(params, stats).model.train()(x.float() / 255.0)
            got = _port_state(params, stats, dtype=torch.bfloat16).model.train()(
                x.to(torch.bfloat16) / 255.0)
        for s, (w, j, p) in enumerate(zip(want, jout, got)):
            assert p.dtype == torch.bfloat16
            w, p = w.permute(0, 2, 3, 1).numpy(), p.float().permute(0, 2, 3, 1).numpy()
            ratio = float(np.std(p - w) / np.std(np.asarray(j.astype(jnp.float32)) - w))
            report.append(f"images {sl.start}-{sl.stop - 1} stage {s}: distance from f32 "
                          f"{ratio:.3f}x JAX's")
            assert BF16_DRIFT[0] <= ratio <= BF16_DRIFT[1], report[-1]

    # the first update (both packages from the same weights): tot_loss within
    # BF16_LOSS_TOL of the JAX step's
    history, jstate, pstate = _two_updates(params, stats, params, {"dtype": jnp.bfloat16},
                                           {"dtype": torch.bfloat16}, torch.bfloat16)
    (want, got) = history[0][0]["tot_loss"], history[0][1]["tot_loss"]
    report.append(f"update 0 tot_loss: port {got:.5f}, JAX {want:.5f}")
    assert abs(got - want) <= BF16_LOSS_TOL * abs(want), report[-1]

    # two updates against the jitted JAX step: each package's bf16 parameters
    # lie about as far from the f32 ones (the port's f32 step, held to JAX's
    # in tests/test_torch_port_train.py) as the other's, median over leaves
    f32 = _port_state(params, stats)
    step = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                           YOLOV5_ANCHORS, accumulate=2)
    for i, (jm, pm) in enumerate(history):
        img, ann = _batch(20 + i, 8)
        f32, ref = step(f32, {"img": torch.from_numpy(img), "ann": torch.from_numpy(ann)})
        assert pm["tar_nums"] == jm["tar_nums"]
        report.append(f"update {i} tot_loss: f32 {float(ref['tot_loss']):.5f}, bf16 port "
                      f"{pm['tot_loss']:.5f}, JAX jitted {jm['tot_loss']:.5f}")
    ref = f32.model.state_dict()
    jax_sd = state_dict_from_jax(jax.device_get(jstate.params),
                                 jax.device_get(jstate.batch_stats))
    ratios = []
    for k, v in pstate.model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
            d_jax = float((jax_sd[k] - ref[k]).double().norm())
            if d_jax > 0:
                ratios.append(float((v - ref[k]).double().norm()) / d_jax)
    ratio = float(np.median(ratios))
    report.append(f"parameters and BN stats after 2 updates: distance from f32, port / JAX, "
                  f"median {ratio:.3f} over {len(ratios)} leaves (min {min(ratios):.3f}, "
                  f"max {max(ratios):.3f})")
    print("bf16:", "; ".join(report))
    assert BF16_DRIFT[0] <= ratio <= BF16_DRIFT[1], report[-1]
    assert all(v.dtype == torch.float32 for k, v in pstate.ema.items() if v.is_floating_point())


# ----------------------------------------------------------- the Trainer

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """8 PNGs of assorted sizes with 1-3 boxes each, and names.txt."""
    root = tmp_path_factory.mktemp("port_train_knobs")
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
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


def test_trainer_takes_the_knobs(folder, tmp_path):
    from yoloseries_tpu_torch.train import Trainer

    img_dir, lab_dir, names = folder
    hyp = {"input_img_size": [SIZE, SIZE], "batch_size": 4, "accumulate_loss_step": 8,
           "total_epoch": 1, "no_data_aug_epoch": 1, "warmup_steps": 3, "num_workers": 1,
           "save_log_txt": False, "save_ckpt_every": 100, "remat": True, "s2d_stem": True}
    cfg = TrainConfig.from_hyp(hyp, num_class=NC, output_dir=str(tmp_path))
    trainer = Trainer(cfg, (img_dir, lab_dir), names_path=names, compute_dtype=torch.bfloat16,
                      log_fn=lambda *a: None, device="cpu")
    try:
        model = trainer.model
        assert model.dtype == torch.bfloat16 and model.remat and model.s2d_stem
        assert tuple(model.focus.conv.weight.shape) == (32, 12, 3, 3)
        trainer.train_loader = type(trainer.train_loader)(
            trainer.train_dataset, batch_size=8, max_labels=cfg.max_labels, seed=cfg.seed,
            workers=1, use_processes=False)
        trainer.train()
    finally:
        trainer.close()
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["tot_loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())


# -------------------------------------------------------------- cli/val.py

def test_val_reads_an_s2d_checkpoint(folder, tmp_path, monkeypatch, capsys):
    from yoloseries_tpu_torch.cli.val import main

    img_dir, lab_dir, names = folder
    model = create_model("yolov5s", num_class=NC, device="cpu", seed=2)
    with torch.no_grad():  # detect heads widened: real candidates at the protocol
        for conv in (model.detect.detect_small, model.detect.detect_mid,
                     model.detect.detect_large):
            conv.weight.normal_(0, 0.3, generator=torch.Generator().manual_seed(0))
            conv.bias.zero_()
    s2d = create_model("yolov5s", num_class=NC, device="cpu", s2d_stem=True)
    s2d.load_state_dict(fold_stem_to_s2d(model.state_dict()))
    for name, m in (("std", model), ("s2d", s2d)):
        save_checkpoint(tmp_path / name, create_train_state(copy.deepcopy(m), OptimizerConfig()), 5)
    cfg = tmp_path / "s2d.yaml"
    cfg.write_text("model_hyp:\n  s2d_stem: true\n")
    monkeypatch.setattr(port_data, "DataLoader", partial(port_data.DataLoader,
                                                         use_processes=False))
    common = ["--val-img-dir", str(img_dir), "--val-lab-dir", str(lab_dir), "--name-path",
              str(names), "--batch-size", "4", "--input-size", str(SIZE), "--device", "cpu"]
    want = main(["--ckpt-dir", str(tmp_path / "std"), "--save-pkl-dir", str(tmp_path / "p0"),
                 *common])
    got = main(["--ckpt-dir", str(tmp_path / "s2d"), "--cfg", str(cfg), "--save-pkl-dir",
                str(tmp_path / "p1"), *common])
    assert abs(got["map"] - want["map"]) <= 1e-6
    name = f"pred_bbox_{SIZE}_yolov5s.pkl"
    with open(tmp_path / "p0" / name, "rb") as f0, open(tmp_path / "p1" / name, "rb") as f1:
        ref, out = pickle.load(f0), pickle.load(f1)
    assert sum(len(r) for r in ref) > 10
    for g, r in zip(out, ref):
        assert g.shape == r.shape
        free = np.ones(len(g), bool)
        for row in r:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= 1e-5)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= 1e-3))
            assert close.any(), f"no match for {row}"
            free[np.argmax(close)] = False
    with pytest.raises(RuntimeError):  # the 6x6 checkpoint does not load into the s2d model
        main(["--ckpt-dir", str(tmp_path / "std"), "--cfg", str(cfg), *common])

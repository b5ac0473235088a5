"""The plain reference: its parameter and FLOP counts at 640, and its
agreement with the port's models on the CPU. The reference and the
harness's yardstick import nothing of the program or of JAX."""

import ast
import json

import pytest
import torch

from port_bench.core import spec
from port_bench.core.flops import forward_flops
from port_bench.core.weights import images_u8, seeded_state, to_input
from port_bench.reference import models

CONFIGS = {c["name"]: json.loads((spec.ROOT / c["file"]).read_text())
           for c in spec.load_bench()["configs"]}
# (parameters, FLOPs of one 640x640 image: convolutions, 2 a multiply-add),
# pinned; a configuration with none is held to its ``published`` block alone
COUNTS = {"yolov5s": (7_235_389, 16_433_561_600), "yolox_s": (8_958_271, 24_142_745_600)}
FORBIDDEN = {"yoloseries_tpu", "yoloseries_tpu_torch", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_at_640(name):
    cfg = CONFIGS[name]
    sd, _ = models.build_state(cfg, "meta")
    params = sum(v.numel() for k, v in sd.items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    if name in COUNTS:
        assert (params, forward_flops(cfg, 640)) == COUNTS[name]
    published = cfg["published"]
    if "parameters" in published:
        assert params == published["parameters"]
    if "parameters_M" in published:  # as rounded to the tenth
        assert abs(params / 1e6 - published["parameters_M"]) <= 0.05
    assert abs(forward_flops(cfg, 640) / 1e9 - published["gflops_640"]) < 3.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matches_the_port(name):
    from yoloseries_tpu_torch.models import create_model

    torch.set_num_threads(1)
    cfg = CONFIGS[name]
    sd = seeded_state(cfg, 2**31 + 3, "cpu", 64, calib=2)
    model = create_model(cfg["program_model"], num_class=cfg["nc"], device="cpu", seed=0)
    model.load_state_dict(sd, strict=True)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = model.eval()(x), models.forward(sd, x, cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    # each widened output conv with bias 0 has its std on the calibration batch
    calib = to_input(images_u8(2**31 + 3, 1, (2, 64, 64, 3), "cpu"))
    with torch.no_grad():
        maps = models.forward(sd, calib, cfg)
    for _, _, sl, i, std, bias in models.output_convs(cfg):
        if bias == 0.0:
            assert float(maps[i][:, sl].std()) == pytest.approx(std, rel=1e-4)


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_yolov5_loss_matches_the_port(scale):
    # scale 10: saturated logits, with predicted sizes under the corners'
    # rounding, where the aspect term's gradient is the definition's
    from yoloseries_tpu_torch.losses.yolov5 import YOLOv5LossConfig
    from yoloseries_tpu_torch.losses.yolov5 import yolov5_loss as port_loss

    from port_bench.reference import yolov5_loss

    cfg = CONFIGS["yolov5s"]
    hyp = spec.traffic("train_devaug_b64x2")["hyp"]
    g = torch.Generator().manual_seed(5)
    size, nc, b, m = 128, cfg["nc"], 4, 24
    maps = [(torch.randn(b, 3 * (5 + nc), size // s, size // s, generator=g) * scale)
            .requires_grad_() for s in (8, 16, 32)]
    ann = torch.full((b, m, 6), -1.0)
    for i in range(b):  # crowded: many candidates share a cell
        n = 4 + 5 * i
        xy = torch.rand(n, 2, generator=g) * size * 0.8
        ann[i, :n, :2] = xy
        ann[i, :n, 2:4] = (xy + 4 + torch.rand(n, 2, generator=g) * 60).clamp(max=size)
        ann[i, :n, 4] = torch.randint(0, nc, (n,), generator=g).float()
        ann[i, :n, 5] = i
    pcfg = YOLOv5LossConfig(num_class=nc, input_size=(size, size), **{
        k: hyp[k] for k in ("anchor_match_thr", "iou_loss_scale", "cls_loss_scale",
                            "cof_loss_scale", "class_smooth_factor", "use_focal_loss",
                            "focal_loss_gamma", "focal_loss_alpha")})
    bal = yolov5_loss.initial_balances()
    got, got_bal = port_loss(maps, ann, cfg["anchors"], bal, pcfg)
    want, want_bal = yolov5_loss.yolov5_loss(maps, ann, bal, cfg["anchors"], hyp, nc, size)
    torch.testing.assert_close(got["tot_loss"], want["tot_loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(got_bal, want_bal, rtol=1e-6, atol=0)
    for gg, gw in zip(torch.autograd.grad(got["tot_loss"], maps),
                      torch.autograd.grad(want["tot_loss"], maps)):
        torch.testing.assert_close(gg, gw, rtol=0, atol=1e-6 * float(gw.abs().max()))


def test_yolox_loss_matches_the_port():
    from yoloseries_tpu_torch.families import get_family

    from port_bench.reference import yolox_loss

    cfg = CONFIGS["yolox_s"]
    hyp = spec.traffic("train_noaug_b64x2")["hyp"]
    g = torch.Generator().manual_seed(6)
    size, nc = 256, cfg["nc"]
    counts = (1, 3, 8, 15, 29, 0)  # crowded images share cells; the last has no box
    maps = [(torch.randn(len(counts), 5 + nc, size // s, size // s, generator=g) * 0.5)
            .requires_grad_() for s in (8, 16, 32)]
    ann = torch.full((len(counts), 30, 6), -1.0)
    for i, n in enumerate(counts):
        xy = torch.randint(0, int(size * 0.8), (n, 2), generator=g).float()
        ann[i, :n, :2] = xy
        ann[i, :n, 2:4] = (xy + torch.randint(4, 120, (n, 2), generator=g)).clamp(max=size)
        ann[i, :n, 4] = torch.randint(0, nc, (n,), generator=g).float()
        ann[i, :n, 5] = i
    port_loss = get_family(cfg["program_model"]).make_loss(hyp, nc, (size, size))[0]
    bal = yolox_loss.initial_balances()
    got, got_bal = port_loss(maps, ann, bal)
    want, want_bal = yolox_loss.yolox_loss(maps, ann, bal, hyp, nc, size)
    torch.testing.assert_close(got["tot_loss"], want["tot_loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(got_bal, want_bal, rtol=1e-6, atol=0)
    for gg, gw in zip(torch.autograd.grad(got["tot_loss"], maps),
                      torch.autograd.grad(want["tot_loss"], maps)):
        torch.testing.assert_close(gg, gw, rtol=0, atol=1e-7)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("folder", ["reference", "core", "reference/families"])
def test_no_program_or_jax_imports(folder):
    for path in sorted((spec.PKG / folder).glob("*.py")):
        assert not set(_imports(path)) & FORBIDDEN, path

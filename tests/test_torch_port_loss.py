"""Port YOLOv5 loss (yoloseries_tpu_torch.losses) against the JAX package.

Seeded maps at nc=3, 64 px, B=2, M=8: NHWC for JAX, the same values NCHW
for the port. The targets hold an empty image, padding rows, boxes at the
grid edges, centres on ``gxy % 1 == 0.5`` and just off it, and a batch
built so that many candidates share a cell. Each loss entry and the new
balances agree within rtol 1e-5, atol 1e-6; the gradient with respect to
the maps agrees with ``jax.grad`` within 1e-5 * max|grad|; ``ciou``,
``bce_with_logits`` and ``focal_loss_factor`` agree elementwise within
1e-6, logits of +-80 included. The objectness winners of the O(J log J)
sort are bit-identical to the (B, J, J) comparison of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.losses.common import bce_with_logits as jax_bce
from yoloseries_tpu.losses.common import focal_loss_factor as jax_focal
from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig as JaxLossConfig
from yoloseries_tpu.losses.yolov5 import _assign_stage_thr as jax_assign
from yoloseries_tpu.losses.yolov5 import initial_balances as jax_balances
from yoloseries_tpu.losses.yolov5 import yolov5_loss as jax_loss
from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
from yoloseries_tpu.ops.iou import ciou as jax_ciou
from yoloseries_tpu_torch.losses.common import bce_with_logits, focal_loss_factor
from yoloseries_tpu_torch.losses.yolov5 import (
    YOLOv5LossConfig,
    _assign_stage_thr,
    _order_key,
    initial_balances,
    objectness_winners,
    yolov5_loss,
)
from yoloseries_tpu_torch.ops.iou import ciou

NC = 3
SIZE = 64
B, M = 2, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = ("tot_loss", "iou_loss", "cof_loss", "cls_loss", "tar_nums")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def edge_targets():
    """Image 0: boxes at the edges, centres on and off x.5 cells, padding
    rows; image 1: empty."""
    t = np.full((B, M, 6), -1.0, np.float32)
    rows = [
        [0.0, 0.0, 12.0, 10.0, 0],  # top-left corner
        [50.0, 40.0, 64.0, 64.0, 1],  # bottom-right corner
        [20.0, 20.0, 28.0, 36.0, 2],  # centre (24, 28): gxy % 1 == 0.5 at stride 8
        [20.0, 21.0, 28.0, 37.0, 1],  # the same box a pixel lower
        [30.0, 6.0, 50.0, 29.9999, 0],  # centre just under x.5 at stride 8
        [1.0, 30.0, 63.0, 34.0, 2],  # wide: fails the anchor ratio at stride 8
    ]
    t[0, :len(rows), :5] = rows
    t[0, :len(rows), 5] = 0
    return t


def duplicate_targets(seed=0):
    """Both images full of near-identical boxes, so that many lattice slots
    land in the same cells."""
    rng = np.random.default_rng(seed)
    t = np.zeros((B, M, 6), np.float32)
    for b in range(B):
        c = rng.uniform(16, 48, 2)
        wh = rng.uniform(10, 20, 2)
        jitter = rng.uniform(-1.5, 1.5, (M, 4))
        t[b, :, 0:2] = c - wh / 2 + jitter[:, :2]
        t[b, :, 2:4] = c + wh / 2 + jitter[:, 2:]
        t[b, :, 4] = rng.integers(0, NC, M)
        t[b, :, 5] = b
    t[1, -2:] = -1.0  # two padding rows
    return t


def random_targets(seed=1):
    rng = np.random.default_rng(seed)
    t = np.full((B, M, 6), -1.0, np.float32)
    for b in range(B):
        n = rng.integers(2, M + 1)
        xy = rng.uniform(0, 50, (n, 2))
        wh = rng.uniform(3, 40, (n, 2))
        t[b, :n, 0:2] = xy
        t[b, :n, 2:4] = np.minimum(xy + wh, SIZE)
        t[b, :n, 4] = rng.integers(0, NC, n)
        t[b, :n, 5] = b
    return t


TARGETS = {"edges": edge_targets, "duplicates": duplicate_targets, "random": random_targets}


def maps(seed, scale=2.0):
    """Seeded NHWC maps (B, H, W, A*(5+nc)) at strides 8/16/32."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, scale, (B, SIZE // s, SIZE // s, 3 * (5 + NC)))).astype(np.float32)
            for s in (8, 16, 32)]


def _nchw(m):
    return torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("focal", [True, False])
@pytest.mark.parametrize("case", sorted(TARGETS))
def test_loss_and_grad_match_jax(case, focal):
    targets = TARGETS[case]()
    nhwc = maps(sorted(TARGETS).index(case))
    jcfg = JaxLossConfig(num_class=NC, input_size=(SIZE, SIZE), use_focal_loss=focal)
    pcfg = YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE), use_focal_loss=focal)
    bal = np.asarray(jax_balances())

    def f(ms):
        d, nb = jax_loss(ms, jnp.asarray(targets), jnp.asarray(YOLOV5_ANCHORS),
                         jnp.asarray(bal), jcfg)
        return d["tot_loss"], (d, nb)

    (_, (want, want_bal)), jgrad = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(m) for m in nhwc])

    tmaps = [_nchw(m).requires_grad_(True) for m in nhwc]
    got, got_bal = yolov5_loss(tmaps, torch.from_numpy(targets), YOLOV5_ANCHORS,
                               initial_balances(), pcfg)
    got["tot_loss"].backward()
    for k in KEYS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(got_bal.numpy(), np.asarray(want_bal), **LOSS_TOL)
    assert float(want["tar_nums"]) > 0
    gmax = max(float(jnp.abs(g).max()) for g in jgrad)
    for t, g in zip(tmaps, jgrad):
        diff = np.abs(t.grad.numpy().transpose(0, 2, 3, 1) - np.asarray(g)).max()
        assert diff <= 1e-5 * gmax, (diff, gmax)


def test_empty_batch_has_no_positives():
    targets = np.full((B, M, 6), -1.0, np.float32)
    nhwc = maps(3)
    want, want_bal = jax_loss([jnp.asarray(m) for m in nhwc], jnp.asarray(targets),
                              jnp.asarray(YOLOV5_ANCHORS), jax_balances(),
                              JaxLossConfig(num_class=NC, input_size=(SIZE, SIZE)))
    got, got_bal = yolov5_loss([_nchw(m) for m in nhwc], torch.from_numpy(targets),
                               YOLOV5_ANCHORS, initial_balances(),
                               YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)))
    assert float(got["tar_nums"]) == 0.0 and float(got["iou_loss"]) == 0.0
    for k in KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(got_bal.numpy(), np.asarray(want_bal), **LOSS_TOL)


def _winners_dense(cells, live, order_key):
    """The JAX package's (B, J, J) form (losses/yolov5.py:219-225)."""
    same = cells[:, :, None] == cells[:, None, :]
    beats = same & live[:, :, None] & (order_key[:, None] > order_key[None, :])
    return live & ~beats.any(axis=1)


@pytest.mark.parametrize("seed", range(4))
def test_winners_match_the_dense_form(seed):
    """Random cells over a tiny grid (every cell taken many times) and the
    cells the assigner gives the duplicate batch."""
    rng = np.random.default_rng(seed)
    num_boxes, na = 8, 3
    j = num_boxes * na * 5
    order_key = _order_key(num_boxes, na, "cpu")
    cells = rng.integers(0, 6, (4, j))
    live = rng.uniform(size=(4, j)) < 0.7
    live[1] = False
    got = objectness_winners(torch.from_numpy(cells), torch.from_numpy(live), order_key, 6)
    want = _winners_dense(cells, live, order_key.numpy())
    assert np.array_equal(got.numpy(), want)
    assert want.sum() < live.sum()  # duplicates were resolved

    targets = duplicate_targets(seed)
    t = torch.from_numpy(targets)
    for stride in (8, 16, 32):
        fm = SIZE // stride
        scale = torch.tensor([fm, fm, fm, fm], dtype=torch.float32)
        xywh = torch.cat([(t[..., :2] + t[..., 2:4]) * 0.5, t[..., 2:4] - t[..., :2]], -1)
        a = _assign_stage_thr(xywh / SIZE * scale, t[..., 4] >= 0,
                              torch.from_numpy(YOLOV5_ANCHORS[stride // 16] / stride), fm, fm, 4.0)
        cells_a = ((a["gy"].long() * fm + a["gx"].long()) * na)[:, :, None, :] \
            + torch.arange(na)[None, None, :, None]
        live_a = a["mask"].reshape(B, -1)
        got = objectness_winners(cells_a.reshape(B, -1), live_a, order_key, fm * fm * na)
        want = _winners_dense(cells_a.reshape(B, -1).numpy(), live_a.numpy(), order_key.numpy())
        assert np.array_equal(got.numpy(), want)


def test_assigner_matches_jax_at_edges():
    targets = edge_targets()
    t = torch.from_numpy(targets)
    for stride, anchors in zip((8, 16, 32), YOLOV5_ANCHORS):
        fm = SIZE // stride
        xywh = torch.cat([(t[..., :2] + t[..., 2:4]) * 0.5, t[..., 2:4] - t[..., :2]], -1) / SIZE
        t_stage = xywh * fm
        got = _assign_stage_thr(t_stage, t[..., 4] >= 0, torch.from_numpy(anchors / stride),
                                fm, fm, 4.0)
        want = jax_assign(jnp.asarray(t_stage.numpy()), jnp.asarray(targets[..., 4] >= 0),
                          jnp.asarray(anchors / stride), fm, fm, 4.0)
        for k in ("mask", "gx", "gy", "t_off", "t_wh"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_primitives_match_jax_elementwise():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 6, 500), [80.0, -80.0, 0.0, 30.0, -30.0]]).astype(np.float32)
    t = rng.uniform(0, 1, x.shape).astype(np.float32)
    t[:200] = np.round(t[:200])
    for pw in (1.0, 2.5):
        np.testing.assert_allclose(bce_with_logits(torch.from_numpy(x), torch.from_numpy(t), pw),
                                   np.asarray(jax_bce(jnp.asarray(x), jnp.asarray(t), pw)),
                                   rtol=1e-6, atol=1e-6)
    assert torch.isfinite(bce_with_logits(torch.from_numpy(x), torch.from_numpy(t))).all()
    np.testing.assert_allclose(focal_loss_factor(torch.from_numpy(x), torch.from_numpy(t)),
                               np.asarray(jax_focal(jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(focal_loss_factor(torch.from_numpy(x), 0.0, 2.0, 0.5),
                               np.asarray(jax_focal(jnp.asarray(x), 0.0, 2.0, 0.5)),
                               rtol=1e-6, atol=1e-6)

    xy = rng.uniform(0, 20, (300, 2, 2))
    wh = rng.uniform(0, 10, (300, 2, 2))
    wh[:10, 0] = 0.0  # zero-area boxes
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    np.testing.assert_allclose(ciou(torch.from_numpy(boxes[:, 0]), torch.from_numpy(boxes[:, 1])),
                               np.asarray(jax_ciou(jnp.asarray(boxes[:, 0]),
                                                   jnp.asarray(boxes[:, 1]))),
                               rtol=1e-6, atol=1e-6)


def test_softplus_gradient_at_zero_and_large_logits():
    x = torch.tensor([0.0, 80.0, -80.0, 3.0], requires_grad=True)
    bce_with_logits(x, torch.zeros(4)).sum().backward()
    want = jax.grad(lambda v: jax_bce(v, jnp.zeros(4)).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)

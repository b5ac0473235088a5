"""Port NMS (yoloseries_tpu_torch) against the JAX package's kernels.

The plain twins of the CUDA kernels, and the wrappers given CPU tensors,
must match the Pallas kernels run in interpret mode index for index: exact
ties, zero-area boxes, all-dead rows, K not a multiple of 128, shuffled
(unsorted) input and the class offset. ``nms_candidates`` (B, 300, 6) must
match the JAX ``nms_candidates(use_pallas=False)`` at the serving and the
protocol thresholds through every dispatch branch; the arithmetic is the
same op for op, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloseries_tpu.kernels.nms_matrix import (
    pallas_matrix_nms,
    pallas_matrix_nms_chunked,
)
from yoloseries_tpu.kernels.nms_pallas import pallas_greedy_nms
from yoloseries_tpu.ops.nms import nms_candidates as jax_nms_candidates
from yoloseries_tpu.ops.nms import select_topk_candidates as jax_select_topk
from yoloseries_tpu_torch.kernels import nms_greedy as port_greedy
from yoloseries_tpu_torch.kernels import nms_matrix as port_matrix
from yoloseries_tpu_torch.ops import nms as port_nms


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_candidates(seed, b, k, shuffle, n_cls=1):
    """Clustered boxes with zero-area boxes, exact ties, dead tails, one
    all-dead row when b > 1, and the class offset for n_cls > 1."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    hot = rng.uniform(0, 600, (b, 20, 2)).astype(np.float32)
    pick = rng.integers(0, 20, (b, k))
    cluster = hot[np.arange(b)[:, None], pick] + rng.normal(0, 15, (b, k, 2))
    use_c = rng.uniform(size=(b, k)) < 0.7
    xy = np.where(use_c[..., None], cluster, xy).astype(np.float32)
    wh = rng.uniform(5, 90, (b, k, 2)).astype(np.float32)
    wh[:, ::37] = 0.0  # zero-area boxes (self-IoU 0)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1, (b, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    scores[:, 5:9] = scores[:, 5:6]  # exact ties
    for r in range(b):
        scores[r, rng.integers(k // 4, k + 1):] = 0.0  # dead tail
    if b > 1:
        scores[-1] = 0.0  # an all-dead row
    if n_cls > 1:
        cls = rng.integers(0, n_cls, (b, k)).astype(np.float32)
        boxes = boxes + (cls * np.float32(4096.0))[..., None]
    if shuffle:
        order = np.argsort(rng.uniform(size=k) + (np.arange(k) % 2))
        boxes, scores = boxes[:, order], scores[:, order]
    return np.ascontiguousarray(boxes), np.ascontiguousarray(scores)


def _canon(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return np.where(valid, idx, -1), valid


def _assert_same(port, ref):
    p_idx, p_val = _canon(*(t.numpy() for t in port))
    r_idx, r_val = _canon(*ref)
    np.testing.assert_array_equal(p_val, r_val)
    np.testing.assert_array_equal(p_idx, r_idx)


@pytest.mark.parametrize("b,k,thr,shuffle,n_cls", [
    (4, 128, 0.45, False, 1),
    (3, 200, 0.65, True, 1),   # K not a multiple of 128, unsorted
    (2, 384, 0.5, False, 80),  # class offset
])
def test_greedy_twin_matches_pallas(b, k, thr, shuffle, n_cls):
    boxes, scores = make_candidates(b * 1000 + k, b, k, shuffle, n_cls)
    for max_keep in (40, 300):
        ref = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                max_keep=max_keep, interpret=True)
        tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
        _assert_same(port_greedy.greedy_nms(tb, ts, thr, max_keep), ref)
        _assert_same(port_greedy.nms_greedy(tb, ts, thr, max_keep), ref)
    assert port_greedy.nms_greedy.launches == 0  # CPU tensors take the twin


def _keeper_positions(scores, keep_idx, keep_valid):
    """Priority positions (greedy's order) of each image's keepers."""
    rank = torch.argsort(port_greedy.priority_order(torch.from_numpy(scores)), dim=1)
    return [rank[r, keep_idx[r][keep_valid[r]].long()].numpy() for r in range(len(scores))]


def _tile_case(case, tile):
    """(boxes, scores, thr, max_keep) of one tile-scan test input. Every
    case has exact ties, zero-area boxes, dead tails and an all-dead row, at
    K not a multiple of 32."""
    if case in ("sorted", "shuffled"):
        boxes, scores = make_candidates(71, 3, 200, case == "shuffled", n_cls=2)
        return boxes, scores, 0.45, 300
    if case == "duplicates":  # exact copies, with equal and with lower scores
        boxes, scores = make_candidates(72, 3, 150, True)
        boxes[:, 100:140] = boxes[:, 10:50]
        scores[:, 100:120] = scores[:, 10:30]
        scores[:, 120:140] = scores[:, 30:50] * np.float32(0.5)
        return boxes, scores, 0.5, 300
    # max_keep cut mid-tile: the last keeper shares its tile with a later one
    boxes, scores = make_candidates(73, 3, 230, True)
    full = port_greedy.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.65, 300)
    tiles = _keeper_positions(scores, *full)[0] // tile
    cut = next(m for m in range(len(tiles) // 2, len(tiles)) if tiles[m - 1] == tiles[m])
    return boxes, scores, 0.65, cut


@pytest.mark.parametrize("tile", [32, 8])
@pytest.mark.parametrize("case", ["sorted", "shuffled", "duplicates", "cut mid-tile"])
def test_tiled_twin_matches_pallas_and_greedy(case, tile):
    """The kernel's design (priority order, tiles resolved in order, forward
    suppression) as a plain twin, against the Pallas kernel and the argmax
    loop, index for index."""
    boxes, scores, thr, max_keep = _tile_case(case, tile)
    ref = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                            max_keep=max_keep, interpret=True)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = port_greedy.greedy_nms_tiled_plain(tb, ts, thr, max_keep, tile=tile)
    _assert_same(got, ref)
    _assert_same(port_greedy.greedy_nms(tb, ts, thr, max_keep), ref)
    assert not got[1][-1].any()  # the all-dead row keeps nothing
    if case == "cut mid-tile":
        assert got[1][0].all()  # image 0 stopped at max_keep, inside a tile


def test_tiled_twin_on_an_all_dead_batch():
    boxes, _ = make_candidates(74, 2, 64, False)
    got = port_greedy.greedy_nms_tiled_plain(torch.from_numpy(boxes), torch.zeros(2, 64), 0.5, 10)
    assert not got[1].any() and (got[0] == -1).all()


@pytest.mark.parametrize("b,k,shuffle,n_cls", [
    (1, 512, False, 1),
    (4, 256, True, 1),
    (2, 200, True, 80),  # K not a multiple of 128, class offset
])
def test_matrix_twin_matches_pallas(b, k, shuffle, n_cls):
    boxes, scores = make_candidates(b * 7 + k, b, k, shuffle, n_cls)
    for max_keep in (50, 300):
        ref = pallas_matrix_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                max_keep=max_keep, interpret=True)
        tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
        _assert_same(port_matrix.matrix_nms_plain(tb, ts, 0.5, max_keep), ref)
        _assert_same(port_matrix.matrix_nms(tb, ts, 0.5, max_keep), ref)
    assert port_matrix.matrix_nms.launches == 0


@pytest.mark.parametrize("k,shuffle", [(600, True), (384, False)])
def test_chunked_matches_pallas_chunked(k, shuffle):
    boxes, scores = make_candidates(k, 2, k, shuffle, n_cls=3)
    ref = pallas_matrix_nms_chunked(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                                    max_keep=300, chunk=128, interpret=True)
    got = port_matrix.matrix_nms_chunked(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.45,
                                         max_keep=300, chunk=128)
    _assert_same(got, ref)


def _relation_reference(boxes, scores, thr):
    """The relation words pair by pair in numpy float32, in the kernel's
    op order (csrc/nms_common.cuh), as uint32."""
    b, k = scores.shape
    words = np.zeros((b, -(-k // 32), k), np.uint32)
    f = np.float32
    for r in range(b):
        x1, y1, x2, y2 = (boxes[r, :, c] for c in range(4))
        area = (x2 - x1) * (y2 - y1)
        for j in range(k):
            iw = np.maximum(np.minimum(x2[j], x2) - np.maximum(x1[j], x1), f(0))
            ih = np.maximum(np.minimum(y2[j], y2) - np.maximum(y1[j], y1), f(0))
            inter = iw * ih
            iou = inter / np.maximum(area[j] + area - inter, f(1e-9))
            before = (scores[r, j] > scores[r]) | ((scores[r, j] == scores[r])
                                                   & (j < np.arange(k)))
            hit = (iou >= f(thr)) & before & (scores[r, j] > 0) & (scores[r] > 0)
            words[r, j // 32] |= hit.astype(np.uint32) << np.uint32(j % 32)
    return words


@pytest.mark.parametrize("b,k,shuffle,n_cls", [
    (2, 77, True, 1),   # K not a multiple of 32, unsorted, an all-dead row
    (1, 96, False, 3),  # class offset
])
def test_relation_twin_matches_pairwise_reference(b, k, shuffle, n_cls):
    boxes, scores = make_candidates(b * 13 + k, b, k, shuffle, n_cls)
    want = _relation_reference(boxes, scores, 0.45)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = port_matrix.nms_relation_plain(tb, ts, 0.45)
    assert got.dtype == torch.int32 and got.shape == (b, -(-k // 32), k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(port_matrix.nms_relation(tb, ts, 0.45).numpy(), got.numpy())
    if b > 1:
        assert not got[-1].any()  # an all-dead row has no relation at all
    assert port_matrix.nms_relation.launches == 0


@pytest.mark.parametrize("b,k,shuffle,n_cls", [
    (1, 256, False, 1),  # sorted
    (3, 200, True, 1),   # shuffled, K not a multiple of 32, an all-dead row
    (2, 333, True, 80),  # class offset
])
def test_fixpoint_over_relation_matches_pallas(b, k, shuffle, n_cls):
    boxes, scores = make_candidates(b * 17 + k, b, k, shuffle, n_cls)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    words = port_matrix.nms_relation_plain(tb, ts, 0.5)
    for max_keep in (30, 300):
        ref = pallas_matrix_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                max_keep=max_keep, interpret=True)
        _assert_same(port_matrix.matrix_fixpoint_plain(words, ts, max_keep), ref)


def _count_strips(monkeypatch):
    """Record the scores of every strip ``matrix_nms_chunked_plain`` hands
    ``matrix_nms_plain``."""
    inner, strips = port_matrix.matrix_nms_plain, []

    def record(b, s, thr, keep):
        strips.append(s.clone())
        return inner(b, s, thr, keep)

    monkeypatch.setattr(port_matrix, "matrix_nms_plain", record)
    return strips


@pytest.mark.parametrize("max_keep", [20, 300])
def test_chunked_early_stop_matches_pallas_and_greedy(monkeypatch, max_keep):
    """K = 5 strips of 128, an all-dead image. With max_keep = 20 every
    live image's carry fills in the first strip, so the loop stops there;
    with 300 no carry fills and it stops at the first all-dead strip."""
    boxes, scores = make_candidates(41, 3, 640, True, n_cls=2)
    ref = pallas_matrix_nms_chunked(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                                    max_keep=max_keep, chunk=128, interpret=True)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    strips = _count_strips(monkeypatch)
    got = port_matrix.matrix_nms_chunked_plain(tb, ts, 0.45, max_keep, chunk=128)
    n_strips = len(strips)
    _assert_same(got, ref)
    _assert_same(port_greedy.greedy_nms(tb, ts, 0.45, max_keep), ref)
    _assert_same(port_matrix.matrix_nms_chunked(tb, ts, 0.45, max_keep, chunk=128), ref)
    if max_keep == 20:
        assert got[1][:2].all()  # both live images filled their carry
        assert n_strips == 1  # ... in the first strip: nothing ran after it
    else:
        assert not got[1].all(dim=1).any()
        assert n_strips == -(-int((scores > 0).sum(axis=1).max()) // 128) < 5


def test_chunked_carry_fills_mid_strip(monkeypatch):
    """max_keep falls between image 0's keepers of strip 0 and of strips
    0-1, so its carry fills in the middle of strip 1 and the cut drops that
    strip's later keepers; image 1 (the same scores, its boxes crowded
    together) stays short of max_keep and runs strip 2 alone."""
    boxes, scores = make_candidates(43, 2, 600, False, n_cls=1)
    scores[1] = scores[0]
    wh = boxes[1, :, 2:] - boxes[1, :, :2]
    xy = np.float32(300) + np.float32(0.1) * (boxes[1, :, :2] - np.float32(300))
    boxes[1] = np.concatenate([xy, xy + wh], -1)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    order = np.argsort(-scores[0], kind="stable")
    _, kval = port_greedy.greedy_nms(tb, ts, 0.5, 600)
    kidx = port_greedy.greedy_nms(tb, ts, 0.5, 600)[0][0][kval[0]].numpy()
    pos = np.argsort(order)[kidx]  # sorted positions of image 0's keepers
    n0, n01 = int((pos < 128).sum()), int((pos < 256).sum())
    max_keep = (n0 + n01) // 2
    assert n0 < max_keep < n01
    ref = pallas_matrix_nms_chunked(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                    max_keep=max_keep, chunk=128, interpret=True)
    strips = _count_strips(monkeypatch)
    got = port_matrix.matrix_nms_chunked_plain(tb, ts, 0.5, max_keep, chunk=128)
    _assert_same(got, ref)
    _assert_same(port_greedy.greedy_nms(tb, ts, 0.5, max_keep), ref)
    assert got[1][0].all() and not got[1][1].all()
    assert len(strips) == 3  # strip 3 starts dead in both images
    assert not strips[2][0].any() and strips[2][1].any()  # image 0 idle after strip 1


def test_twins_agree_with_each_other():
    """Greedy, matrix and chunked twins are one function."""
    boxes, scores = make_candidates(3, 3, 700, True, n_cls=5)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    g = port_greedy.greedy_nms(tb, ts, 0.6, 300)
    m = port_matrix.matrix_nms_plain(tb, ts, 0.6, 300)
    c = port_matrix.matrix_nms_chunked(tb, ts, 0.6, 300, chunk=256)
    for other in (m, c):
        np.testing.assert_array_equal(g[0].numpy(), other[0].numpy())
        np.testing.assert_array_equal(g[1].numpy(), other[1].numpy())


def test_wrappers_reject_bad_inputs():
    boxes = torch.zeros(2, 8, 4)
    with pytest.raises(TypeError):
        port_greedy.nms_greedy(boxes.double(), torch.zeros(2, 8, dtype=torch.float64), 0.5)
    with pytest.raises(ValueError):
        port_greedy.nms_greedy(boxes, torch.zeros(2, 9), 0.5)
    with pytest.raises(ValueError):
        port_matrix.matrix_nms(torch.zeros(1, 1025, 4), torch.zeros(1, 1025), 0.5)


def _candidates_for_serving(seed, b, k):
    boxes, scores = make_candidates(seed, b, k, shuffle=True)
    cls = np.random.default_rng(seed + 1).integers(0, 4, (b, k)).astype(np.float32)
    return boxes, scores, cls


@pytest.mark.parametrize("b,k,thr", [
    (8, 512, 0.45),   # matrix branch, serving threshold
    (20, 256, 0.45),  # greedy branch (B > 16)
    (2, 1500, 0.65),  # greedy branch (K > 1024), protocol threshold
    (1, 8200, 0.65),  # chunked branch (K > 8192)
])
def test_nms_candidates_matches_jax(b, k, thr):
    boxes, scores, cls = _candidates_for_serving(b + k, b, k)
    ref = np.asarray(jax_nms_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
        iou_threshold=thr, max_keep=300, merge_boxes=True, use_pallas=False))
    got = port_nms.nms_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls),
        iou_threshold=thr, max_keep=300, merge_boxes=True).numpy()
    assert got.shape == (b, 300, 6)
    assert (got[..., 4] > 0).any()
    np.testing.assert_array_equal(got, ref)


def test_nms_candidates_on_tta_branches_takes_greedy(monkeypatch):
    """Three separately sorted branches of 512 candidates concatenated, as
    the TTA evaluator hands them over at the serving config: K = 1536, not
    sorted as a whole, goes to the greedy kernel's branch (B1)."""
    parts = [make_candidates(90 + i, 3, 512, False, n_cls=4) for i in range(3)]
    boxes = np.concatenate([p[0][:2] for p in parts], axis=1)  # two live images
    scores = np.concatenate([p[1][:2] for p in parts], axis=1)
    cls = np.random.default_rng(93).integers(0, 4, scores.shape).astype(np.float32)
    assert (np.diff(scores, axis=1) > 0).any()  # unsorted as a whole
    calls = []

    def record(b, s, thr, keep):
        calls.append(tuple(s.shape))
        return port_greedy.nms_greedy(b, s, thr, keep)

    monkeypatch.setattr(port_nms, "nms_greedy", record)
    ref = np.asarray(jax_nms_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
        iou_threshold=0.45, max_keep=300, merge_boxes=True, use_pallas=False))
    got = port_nms.nms_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls),
        iou_threshold=0.45, max_keep=300, merge_boxes=True).numpy()
    assert calls == [(2, 1536)]
    assert (got[..., 4] > 0).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("merge_gate_max", [3000, 301])
def test_nms_candidates_merge_write_matches_jax(merge_gate_max):
    """The retinanet merge (IoU-weighted boxes written to the output) and
    the fcos gate. The merged box is a matmul, whose summation order
    differs between the two packages: boxes at atol 1e-3 px, the rest exact."""
    boxes, scores, cls = _candidates_for_serving(11, 3, 1024)
    scores[0, np.flatnonzero(scores[0] > 0)[200:]] = 0.0  # under both gates
    kw = dict(iou_threshold=0.45, max_keep=300, merge_boxes=True,
              merge_write_boxes=True, merge_gate_max=merge_gate_max)
    ref = np.asarray(jax_nms_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), use_pallas=False, **kw))
    got = port_nms.nms_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls), **kw).numpy()
    plain = port_nms.nms_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls),
        iou_threshold=0.45, max_keep=300, merge_gate_max=merge_gate_max).numpy()
    n_live = (scores > 0).sum(axis=1)
    gated = (n_live > 1) & (n_live < merge_gate_max)
    assert gated.any() and (np.abs(got[gated, :, :4] - plain[gated, :, :4]) > 1e-2).any()
    np.testing.assert_array_equal(got[~gated], plain[~gated])
    np.testing.assert_array_equal(got[..., 4:], ref[..., 4:])
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-3)


def test_soft_nms_modes_raise():
    """Both soft-NMS modes run (the test's name dates from when they raised)
    and match the JAX ``nms_candidates`` slot for slot: keepers equal, the
    decayed scores within 1e-6 (``exp`` may round in another last bit). A
    mode that neither package knows raises in both."""
    boxes, scores, cls = _candidates_for_serving(5, 2, 300)
    args = [torch.from_numpy(a) for a in (boxes, scores, cls)]
    for mode in ("soft_linear", "soft_exp"):
        got = port_nms.nms_candidates(*args, 0.5, nms_mode=mode).numpy()
        ref = np.asarray(jax_nms_candidates(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), iou_threshold=0.5,
            use_pallas=False, nms_mode=mode))
        assert (got[..., 4] > 0).any()
        np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 5]], ref[..., [0, 1, 2, 3, 5]])
        np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        port_nms.nms_candidates(*args, 0.5, nms_mode="soft_gauss")
    with pytest.raises(ValueError):
        jax_nms_candidates(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                           iou_threshold=0.5, use_pallas=False, nms_mode="soft_gauss")


@pytest.mark.parametrize("k", [16, 500])
def test_select_topk_candidates_matches_jax(k):
    rng = np.random.default_rng(k)
    boxes = rng.uniform(0, 100, (300, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    scores[::3] = 0.0  # exact-zero ties: lowest index first
    classes = rng.integers(0, 5, 300).astype(np.float32)
    ref = jax_select_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), k)
    got = port_nms.select_topk_candidates(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          torch.from_numpy(classes), k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

"""Shared helpers of ``test_torch_port_yolox.py`` and
``test_torch_port_yolov8.py``: seeded JAX variables, targets, batches, a
PNG folder set and the JAX ``cli/val.py`` main."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
NC = 3
SIZE = 64


def jax_variables(model, seed=0, size=SIZE, noise=0.05):
    """``model.init`` with N(0, noise) added to every parameter and BN
    stats drawn away from the identity, as numpy trees."""
    variables = jax.device_get(jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))())
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, noise, x.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0, 0.1, x.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def jax_param_count(model, size=SIZE):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, size, size, 3)), train=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"])), shapes


def targets(rng, b, m, size=SIZE, nc=NC, lo=1):
    """(b, m, 6) [x1, y1, x2, y2, cls, img] in pixels, ``lo``..m boxes per
    image, -1 padded."""
    t = np.full((b, m, 6), -1.0, np.float32)
    for i in range(b):
        k = int(rng.integers(lo, m + 1))
        xy = rng.uniform(0, size * 0.8, (k, 2))
        wh = rng.uniform(4, size * 0.5, (k, 2))
        t[i, :k, :2] = xy
        t[i, :k, 2:4] = np.minimum(xy + wh, size)
        t[i, :k, 4] = rng.integers(0, nc, k)
        t[i, :k, 5] = i
    return t


def batch(seed, n, size=SIZE, m=8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return img, targets(rng, n, m, size)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).permute(0, 3, 1, 2)


def write_folder(root, n=8, seed=0):
    """``n`` PNGs of assorted sizes with 1-4 filled boxes each, labels and
    names.txt. Returns (img_dir, lab_dir, names)."""
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
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


def jax_val_main():
    spec = importlib.util.spec_from_file_location("jax_cli_val", ROOT / "cli" / "val.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def match_detections(got, want, box_tol=2e-3, conf_tol=1e-5):
    """Per image, the same detections one for one (slots matched: keepers
    whose confs differ by ulps may swap)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(-1, 6), np.asarray(w).reshape(-1, 6)
        assert g.shape == w.shape
        free = np.ones(len(g), bool)
        for row in w:
            close = (free & (g[:, 5] == row[5]) & (np.abs(g[:, 4] - row[4]) <= conf_tol)
                     & (np.abs(g[:, :4] - row[:4]).max(axis=1) <= box_tol))
            assert close.any(), f"no match for {row}"
            free[np.argmax(close)] = False


def rel_diff(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))

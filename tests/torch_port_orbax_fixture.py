"""Generator of ``tests/data/orbax_v5_tiny``: an Orbax checkpoint written by
the JAX package's own ``save_checkpoint`` (OCDBT, zstd: tensorstore's
bytes), for the port's reader to be checked against on machines that have
no JAX, orbax, tensorstore or zstandard (``chip_smoke.py``'s phase 15).

The model is the narrowest YOLOv5 the JAX package builds (width 1, no
C3 blocks, nc=1) after one SGD update at 64 px (warmup active), so that the
Nesterov trace and the EMA are non-zero. ``digests.json`` beside the step
holds, per leaf of the state (its path joined with ``/``), the sha256 of
its bytes (C order), its shape and dtype, or null for a masked leaf.

    JAX_PLATFORMS=cpu python tests/torch_port_orbax_fixture.py [out_dir]

(the sample goes beside ``out_dir``).

Beside it, ``tests/data/zstd_weights_level1.zst``: one zstd frame (``zstandard`` at level 1,
as tensorstore compresses a chunk) of ``SAMPLE_FLOATS`` float32 weights
drawn from N(0, 0.02) with seed 0: every 128 KB block a compressed block
of 4-stream Huffman literals, the decoder's hot path, which phase 15 times
on the card's machine.

``tests/test_torch_port_orbax_families.py`` regenerates both and checks
that the arrays equal the committed ones (the compressed bytes may differ
between orbax, tensorstore and zstandard versions).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "orbax_v5_tiny"
NARROW = (1, (0, 0, 0, 0), 0)
NC = 1
SIZE = 64
STEP = 1
HYP = {"model": "yolov5_tiny", "num_class": NC, "input_size": SIZE, "s2d_stem": False}
SAMPLE = FIXTURE.parent / "zstd_weights_level1.zst"
SAMPLE_FLOATS = 1 << 16  # 256 KB: two blocks
SAMPLE_SHA256 = "36700b8aeb1100568bfbcd16bcf9b8a12111f4cb487736242d63b3e554203cc2"


def sample_weights() -> bytes:
    """The content of ``zstd_weights_level1.zst``."""
    return np.random.default_rng(0).normal(0, 0.02, SAMPLE_FLOATS).astype(np.float32).tobytes()


def jax_state():
    """The JAX ``TrainState`` after one update on two seeded images."""
    import jax
    import jax.numpy as jnp

    from yoloseries_tpu.losses.yolov5 import YOLOv5LossConfig
    from yoloseries_tpu.models.yolov5 import YOLOv5, YOLOv5Spec
    from yoloseries_tpu.ops.anchors import YOLOV5_ANCHORS
    from yoloseries_tpu.train.optim import OptimizerConfig, build_optimizer
    from yoloseries_tpu.train.state import create_train_state, make_train_step

    model = YOLOv5(num_class=NC, spec=YOLOv5Spec(*NARROW))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                        train=False)["params"]
    tx = build_optimizer(OptimizerConfig(batch_size=2, steps_per_epoch=1,
                                         warmup_steps_override=2), params)
    state = create_train_state(model, tx, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    ann = np.full((2, 4, 6), -1.0, np.float32)
    ann[:, :2] = [[[4, 6, 30, 40, 0, 0], [20, 10, 60, 50, 0, 0]],
                  [[10, 12, 34, 44, 0, 1], [30, 30, 62, 58, 0, 1]]]
    step = make_train_step(YOLOv5LossConfig(num_class=NC, input_size=(SIZE, SIZE)),
                           YOLOV5_ANCHORS, donate=False)
    state, _ = step(state, {"img": jnp.asarray(img), "ann": jnp.asarray(ann)})
    return state


def state_leaves(state) -> dict:
    """{path joined with /: numpy array or None} of the tree the JAX
    package checkpoints (masked leaves and empty states as None)."""
    import jax

    from yoloseries_tpu.train.checkpoint import _state_to_tree

    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))

    flat = jax.tree_util.tree_flatten_with_path(
        _state_to_tree(state), is_leaf=lambda x: x is None or (isinstance(x, tuple) and not x))
    return {"/".join(name(k) for k in path): (None if v is None or isinstance(v, tuple)
                                              else np.asarray(v))
            for path, v in flat[0]}


def digest(value) -> dict | None:
    if value is None:
        return None
    value = np.asarray(value, order="C")
    return {"sha256": hashlib.sha256(value.tobytes()).hexdigest(), "shape": list(value.shape),
            "dtype": value.dtype.str}


def write_fixture(out_dir=FIXTURE) -> dict:
    """Write the checkpoint (step ``STEP``) and ``digests.json`` under
    ``out_dir``; returns the digests."""
    from yoloseries_tpu.train.checkpoint import save_checkpoint

    out_dir = Path(out_dir)
    state = jax_state()
    save_checkpoint(out_dir, state, STEP, hyp=HYP)
    digests = {k: digest(v) for k, v in sorted(state_leaves(state).items())}
    text = json.dumps(digests, sort_keys=True, separators=(",", ":"))
    (out_dir / "digests.json").write_text(text + "\n")
    return digests


def write_sample(path=SAMPLE) -> bytes:
    """Write the zstd sample; returns the frame."""
    import zstandard

    frame = zstandard.ZstdCompressor(level=1).compress(sample_weights())
    Path(path).write_bytes(frame)
    return frame


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE
    write_fixture(out)
    write_sample(out.parent / SAMPLE.name)

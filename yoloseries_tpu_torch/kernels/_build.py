"""Build and load the CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library lives in
``build/kernels/`` beside the package, named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

No PyTorch headers are compiled: each C entry takes raw device pointers, the
sizes and the CUDA stream, launches on that stream, and returns
``cudaGetLastError()``; the wrappers raise when it is not 0.

The build or load runs in the span ``setup.kernels``; the counter
``kernels.built`` counts the builds that ran ``nvcc`` (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils import trace

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "build_log", "check", "launch",
           "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
# -fmad=false: no a*b+c contraction, so the IoU at the threshold is
# bit-identical to the plain twins'; IEEE division is nvcc's default and
# --use_fast_math must never be added
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, pointer/int/float argument kinds) of every C entry point; the last
# pointer is the CUDA stream
_ENTRIES = {
    "yst_nms_greedy": "ppiifippp",
    "yst_nms_relation": "ppiifpp",
    "yst_nms_matrix": "ppiifipppp",
    "yst_nms_matrix_chunked": "ppiiifipppp",
    "yst_step_probe": "iipp",  # latency probes, measurement only
    "yst_warp_step_probe": "ipp",
    "yst_bn_silu": "ppiiippppfiip",
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_lib = None
_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile ``csrc/`` into ``BUILD_DIR`` unless an up-to-date library is
    there. Returns (library path, compiler log: ``-Xptxas -v`` register and
    shared-memory use, empty when the library was reused)."""
    lib_path = BUILD_DIR / f"libyst_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [proc.communicate()[0] for _, proc in procs]  # wait for all
        for (obj, proc), out in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {obj.stem}.cu:\n{out}")
        objs = [str(obj) for obj, _ in procs]
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_lib), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees a partial file
    trace.count("kernels.built")
    return lib_path, "".join(logs)


def load():
    """The loaded kernel library (built on first call in this process)."""
    global _lib, _log
    if _lib is not None:  # set once, after every entry is typed: no lock needed
        return _lib
    with _lock, trace.span("setup.kernels"):
        if _lib is None:
            path, _log = build()
            lib = ctypes.CDLL(str(path))
            for name, kinds in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPE[k] for k in kinds]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler output of this process's build ('' when reused)."""
    return _log


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` with ``args`` and the current stream of CUDA
    ``device`` (made the current device for the call), and raise on an
    error. The device switch is skipped when it is current already."""
    fn = getattr(load(), entry)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, entry)

"""Build and bind the hand-written Hopper kernels.

Every source under ``csrc/`` compiles with ``nvcc`` into ONE shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
which is loaded with ``ctypes``. The library lands in ``build/kernels/`` at
the repository root, named by a hash of the sources and flags: an edited
source rebuilds, an unchanged one is reused. ``ptxas -v`` (registers, shared
memory, spills per kernel) is kept beside it as ``<name>.log``.

Nothing is built or loaded at import time; the first kernel launch calls
:func:`load_library`. To force a rebuild, delete ``build/kernels/``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu): pointers and the stream are c_void_p
SIGNATURES = {
    "mdf_rowsweep_aggregate": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P],
    "mdf_conv_bn_act": [_P] * 6 + [_I] * 16 + [_P],
    "mdf_trconv_bn_act": [_P] * 6 + [_I] * 10 + [_P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmdfnet_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mdf_error_string.argtypes = [ctypes.c_int]
    lib.mdf_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().mdf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch_context(t) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor ``t``."""
    import torch
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check_operand(t, name: str) -> None:
    """Kernels take contiguous, 16-byte aligned CUDA tensors."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")

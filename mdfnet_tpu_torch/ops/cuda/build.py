"""Build and bind the hand-written Hopper kernels.

Every source under ``csrc/`` compiles with its own ``nvcc`` (all started
together) and the objects link into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), which is loaded
with ``ctypes``. The library lands in ``build/kernels/`` at the repository
root, named by a hash of the sources and flags: an edited source rebuilds,
an unchanged one is reused. ``ptxas -v`` (registers, shared memory, spills
per kernel) is kept beside it as ``<name>.log``.

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
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu): pointers and the stream are c_void_p
SIGNATURES = {
    "mdf_rowsweep_aggregate": [_P] * 6 + [_I] * 12 + [_F, _F, _I, _P],
    "mdf_rowsweep_aggregate_train": [_P] * 8 + [_I] * 10 + [_F, _F, _I, _P],
    "mdf_rowsweep_stats": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "mdf_conv_bn_act": [_P] * 6 + [_I] * 16 + [_P],
    "mdf_trconv_bn_act": [_P] * 6 + [_I] * 10 + [_P],
    "mdf_conv_tc": [_P] * 6 + [_I] * 20 + [_P],
    "mdf_trconv_tc": [_P] * 6 + [_I] * 14 + [_P],
    "mdf_conv_co1": [_P] * 6 + [_I] * 13 + [_P],
    "mdf_conv_chain": [_P] * 6 + [_I] * 8 + [_P],
    "mdf_conv3d_pair": [_P] * 8 + [_I] * 11 + [_P],
    "mdf_sample_2d": [_P] * 4 + [_I] * 7 + [_P],
    "mdf_splat_2d": [_P] * 8 + [_I] * 11 + [_P],
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for obj, src in zip(objs, srcs)]
        logs = [p.communicate() for p in procs]    # waits for every nvcc
        failed = [(p, log) for p, log in zip(procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                log[1] for _, log in failed))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(log[1] for log in logs))
        os.replace(lib, out)  # atomic: a loader never sees half a file
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

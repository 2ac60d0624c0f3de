"""ctypes loader for the native fusion cores (``native/fusion_core.cpp``),
the port's counterpart of ``mdfnet_tpu/fusion/native.py``.

The two sequential cores of the pcd fusion (the z-buffer election, the
small-segment flood fill) run on the host in C, as in the JAX package. The
library is compiled with ``g++`` at first use into ``build/native/`` at the
repository root (git-ignored), named by a hash of the source and flags, so
an edited source rebuilds and the JAX package's library next to the source
is never shared. Each build writes a temporary name and ``os.replace``\\ s it
into place, so processes that build at once never load half a file. A
failed build raises: there is no silent fallback. The numpy versions
(:func:`zbuffer_elect_numpy`, :func:`segment_filter_numpy`) are the plain
versions the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "fusion_core.cpp"
BUILD_DIR = _ROOT / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libfusion_core_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    f32, i32, u8 = (ctypes.POINTER(t) for t in (
        ctypes.c_float, ctypes.c_int32, ctypes.c_uint8))
    lib.zbuffer_elect.argtypes = [f32, f32, i32, u8, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, f32]
    lib.segment_filter.argtypes = [f32, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_float,
                                   ctypes.c_int32, u8]
    lib.zbuffer_elect.restype = lib.segment_filter.restype = None
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _elect_args(depth, xy, violation, valid):
    """The election's arrays, contiguous in the C types, their sizes
    checked (the library indexes them by the candidate count)."""
    depth = np.ascontiguousarray(depth, np.float32).reshape(-1)
    xy = np.ascontiguousarray(xy, np.float32)
    violation = np.ascontiguousarray(violation, np.int32).reshape(-1)
    if xy.shape != (len(depth), 2) or len(violation) != len(depth) \
            or np.ndim(valid) != 2:
        raise ValueError(f"zbuffer_elect: depth {depth.shape}, xy "
                         f"{xy.shape}, violation {violation.shape}, valid "
                         f"{np.shape(valid)}")
    return depth, xy, violation, np.ascontiguousarray(valid, np.uint8)


def zbuffer_elect(depth: np.ndarray, xy: np.ndarray, violation: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Elect one depth per ref pixel from scattered candidates.

    Args:
        depth: (M,) candidate depths in the ref camera frame.
        xy: (M, 2) candidate positions, pixel-center (+0.5) convention.
        violation: (M,) int32 occlusion-violation counts.
        valid: (H, W) bool ref-pixel validity.
    Returns:
        (H, W) elected depth, 0 where no candidate landed.
    """
    depth, xy, violation, valid_u8 = _elect_args(depth, xy, violation, valid)
    h, w = valid_u8.shape
    out = np.zeros((h, w), np.float32)
    load_library().zbuffer_elect(
        _ptr(depth, ctypes.c_float), _ptr(xy, ctypes.c_float),
        _ptr(violation, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8),
        len(depth), h, w, _ptr(out, ctypes.c_float))
    return out


def zbuffer_elect_numpy(depth: np.ndarray, xy: np.ndarray,
                        violation: np.ndarray, valid: np.ndarray
                        ) -> np.ndarray:
    """:func:`zbuffer_elect` in numpy: lexsort by (cell, depth, violation),
    then a scan of each cell's group. Cells round as ``lround`` does (half
    away from zero)."""
    depth, xy, violation, valid_u8 = _elect_args(depth, xy, violation, valid)
    h, w = valid_u8.shape
    x = _lround(xy[:, 0] - np.float32(0.5))
    y = _lround(xy[:, 1] - np.float32(0.5))
    keep = ((depth > np.float32(1e-9)) & (x >= 0) & (x < w) & (y >= 0)
            & (y < h))
    keep &= valid_u8[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)].astype(bool)
    cell = (y * w + x)[keep]
    d, v = depth[keep], violation[keep]
    order = np.lexsort((v, d, cell))
    cell, d, v = cell[order], d[order], v[order]
    out = np.zeros(h * w, np.float32)
    starts = np.flatnonzero(np.r_[True, cell[1:] != cell[:-1]])
    ends = np.r_[starts[1:], len(cell)]
    for s, e in zip(starts, ends):
        ok = np.flatnonzero(np.arange(e - s) >= v[s:e])
        out[cell[s]] = d[s + ok[0]] if len(ok) else d[e - 1]
    return out.reshape(h, w)


def _lround(x: np.ndarray) -> np.ndarray:
    """C's ``lround``: nearest integer, halves away from zero."""
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int64)


def segment_filter(depth: np.ndarray, window: int = 4,
                   diff_thresh: float = 1e-3, size_thresh: int = 10
                   ) -> np.ndarray:
    """Drop small depth-connected segments. Returns (H, W) bool keep-mask."""
    depth = np.ascontiguousarray(depth, np.float32)
    h, w = depth.shape
    mask = np.zeros((h, w), np.uint8)
    load_library().segment_filter(
        _ptr(depth, ctypes.c_float), h, w, window, diff_thresh, size_thresh,
        _ptr(mask, ctypes.c_uint8))
    return mask.astype(bool)


def segment_filter_numpy(depth: np.ndarray, window: int = 4,
                         diff_thresh: float = 1e-3, size_thresh: int = 10
                         ) -> np.ndarray:
    """:func:`segment_filter` in Python: a breadth-first search per
    component (slow; for small maps and tests)."""
    h, w = depth.shape
    depth = np.ascontiguousarray(depth, np.float32)
    thresh = np.float32(diff_thresh)
    valid = depth >= np.float32(1e-9)
    seen = ~valid
    mask = valid.copy()
    offsets = [(dy, dx) for dy in range(-window, window + 1)
               for dx in range(-window, window + 1) if (dy, dx) != (0, 0)]
    for sy in range(h):
        for sx in range(w):
            if seen[sy, sx]:
                continue
            comp = [(sy, sx)]
            seen[sy, sx] = True
            head = 0
            while head < len(comp):
                cy, cx = comp[head]
                head += 1
                cd = depth[cy, cx]
                for dy, dx in offsets:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx < w and not seen[ny, nx]:
                        nd = depth[ny, nx]
                        if abs(cd - nd) < thresh * (cd + nd):
                            seen[ny, nx] = True
                            comp.append((ny, nx))
            if len(comp) < size_thresh:
                for cy, cx in comp:
                    mask[cy, cx] = False
    return mask

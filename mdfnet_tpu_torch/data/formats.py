"""File codecs for the MVS dataset formats (counterpart of
``mdfnet_tpu/data/formats.py``).

- PFM float maps (Portable Float Map: 'Pf'/'PF' header, scale line whose sign
  encodes endianness, rows stored bottom-up) — the interchange format for
  depth/confidence maps, byte-compatible with the reference's reader/writer
  (reference tools/data_io.py:6-71).
- MVSNet-style cam txt: 'extrinsic' 4x4 at lines 1-4, 'intrinsic' 3x3 at
  lines 7-9, optional depth info at line 11 (reference tools/data_io.py:92-101,
  load/blendedtrain.py:94-106).
- pair.txt: total view count, then per view "ref" line and
  "count (src score)*" line (reference tools/data_io.py:79-89).
"""
from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------- PFM codec

def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Read a PFM file. Returns (array top-down, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline().decode("ascii").split()
        width, height = int(dims[0]), int(dims[1])

        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, dtype=endian + "f4", count=width * height * channels)

    shape = (height, width, 3) if channels == 3 else (height, width)
    # PFM stores rows bottom-up
    return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array as PFM (bottom-up rows, native endianness)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError(f"PFM requires float32, got {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
    else:
        raise ValueError(f"PFM image must be HxW[x1|x3], got shape {image.shape}")

    little = image.dtype.byteorder == "<" or (
        image.dtype.byteorder in ("=", "|") and sys.byteorder == "little")
    signed_scale = -scale if little else scale

    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{signed_scale:f}\n".encode("ascii"))
        np.flipud(image).tofile(f)


# --------------------------------------------------------------- cam / pair

def read_cam_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read an MVSNet cam txt.

    Returns (intrinsic (3,3), extrinsic (4,4), depth_info) where depth_info is
    whatever floats line 11 holds (may be empty): DTU train files carry
    [min, interval], BlendedMVS [min, interval, n, max], Tanks [min, ...].
    """
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extrinsic = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsic = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    depth_info = np.array([], dtype=np.float32)
    if len(lines) > 11 and lines[11].strip():
        depth_info = np.fromstring(lines[11], dtype=np.float32, sep=" ")
    return intrinsic, extrinsic, depth_info


def write_cam_file(path: str, intrinsic: np.ndarray, extrinsic: np.ndarray,
                   depth_info=()) -> None:
    """Write an MVSNet cam txt (inverse of :func:`read_cam_file`)."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsic).reshape(4, 4):
            f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsic).reshape(3, 3):
            f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
        f.write("\n")
        if len(depth_info):
            f.write(" ".join(f"{v:.10g}" for v in depth_info) + "\n")


def read_pair_file(path: str) -> Tuple[int, List[Tuple[int, List[int]]]]:
    """Read pair.txt -> (num_views, [(ref_view, [src views best-first]), ...])."""
    pairs = []
    with open(path) as f:
        num_views = int(f.readline())
        for _ in range(num_views):
            ref = int(f.readline().rstrip())
            tokens = f.readline().rstrip().split()
            srcs = [int(t) for t in tokens[1::2]]  # skip scores
            pairs.append((ref, srcs))
    return num_views, pairs


def write_pair_file(path: str, pairs: List[Tuple[int, List[int]]]) -> None:
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " + " ".join(f"{s} {2.0:.2f}" for s in srcs) + "\n")


# ------------------------------------------------------------------- images

def read_image(path: str) -> np.ndarray:
    """Load an image as float32 HWC in [0, 1] (reference tools/data_io.py:103-107)."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img, dtype=np.float32) / 255.0


def write_depth_png(path: str, depth: np.ndarray) -> None:
    """Grayscale depth visualisation, (d - 500) / 2 like the reference
    (tools/data_io.py:73-76)."""
    from PIL import Image
    Image.fromarray((np.asarray(depth) - 500.0) / 2.0).convert("L").save(path)


def write_mask_png(path: str, mask: np.ndarray) -> None:
    """Binary mask as 0/255 PNG (reference tools/data_io.py:110-113)."""
    from PIL import Image
    assert mask.dtype == np.bool_
    Image.fromarray(mask.astype(np.uint8) * 255).save(path)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path

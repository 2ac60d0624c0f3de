"""Minimal binary-PLY point-cloud IO (xyz float32 + rgb uint8); a copy of
``mdfnet_tpu/fusion/ply.py``.

Replaces the reference's plyfile dependency (tools/filter/dynamic_filter_gpu.py
:146-164) and fusibile's hand-rolled writer (displayUtils.h:80) with one
little-endian binary codec.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Write points (N,3) float with optional colors (N,3) uint8 / normals."""
    xyz = np.ascontiguousarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        dtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if rgb is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

    rec = np.empty(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if normals is not None:
        nrm = np.ascontiguousarray(normals, dtype="<f4")
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, dtype="u1")
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props + ["end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a binary or ascii PLY; returns (xyz (N,3) f32, rgb (N,3) u1|None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"element"):  # other elements unsupported
                pass
            elif line.startswith(b"property"):
                toks = line.split()
                props.append((toks[-1].decode(), toks[1].decode()))
            elif line == b"end_header":
                break

        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
        if fmt == "binary_little_endian":
            dtype = [(name, type_map[t]) for name, t in props]
            rec = np.fromfile(f, dtype=dtype, count=n)
        elif fmt == "ascii":
            raw = np.loadtxt(f, max_rows=n)
            rec = {name: raw[:, i] for i, (name, _) in enumerate(props)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    xyz = np.stack([np.asarray(rec["x"], np.float32),
                    np.asarray(rec["y"], np.float32),
                    np.asarray(rec["z"], np.float32)], axis=1)
    rgb = None
    names = [name for name, _ in props]
    if "red" in names:
        rgb = np.stack([np.asarray(rec["red"], np.uint8),
                        np.asarray(rec["green"], np.uint8),
                        np.asarray(rec["blue"], np.uint8)], axis=1)
    return xyz, rgb

"""Camera geometry for the plane sweep (port of ``mdfnet_tpu/geometry.py``).

Conventions match the reference: intrinsics ``(..., 3, 3)``, extrinsics
``(..., 4, 4)`` world -> camera, pixel coordinates ``(x, y)`` with integer
coordinates on pixel centres.
"""
from __future__ import annotations

import numpy as np
import torch


def scale_intrinsics(intrinsics: torch.Tensor, stage: int,
                     num_stages: int = 4) -> torch.Tensor:
    """Scale K for a pyramid stage living at 1/2^(num_stages-1-stage)."""
    factor = 1.0 / (2.0 ** (num_stages - 1 - stage))
    # rows x and y times a Python scalar: a power of two, so the bits of a
    # product with a [f, f, 1] tensor, without copying one to the device
    return torch.cat([intrinsics[..., :2, :] * factor,
                      intrinsics[..., 2:, :]], dim=-2)


def projection_matrices(intrinsics: torch.Tensor, extrinsics: torch.Tensor,
                        stage: int, num_stages: int = 4
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-view 4x4 projections P[:3, :4] = K_s @ E[:3, :4], P[3] = E[3].

    Args:
        intrinsics: (B, V, 3, 3); extrinsics: (B, V, 4, 4).
    Returns:
        ref_proj (B, 4, 4), src_projs (B, V-1, 4, 4).
    """
    k = scale_intrinsics(intrinsics, stage, num_stages)
    top = k @ extrinsics[..., :3, :4]
    proj = torch.cat([top, extrinsics[..., 3:4, :4]], dim=-2)
    return proj[:, 0], proj[:, 1:]


def relative_transforms(src_projs: torch.Tensor,
                        ref_proj: torch.Tensor) -> torch.Tensor:
    """src_proj @ ref_proj^-1 for every source: (B, S, 4, 4) from
    src_projs (B, S, 4, 4) and ref_proj (B, 4, 4), in f32. ``inv_ex``
    leaves the factorisation's status unchecked, as ``jnp.linalg.inv``
    does, so a CUDA call does not wait for the device."""
    inv = torch.linalg.inv_ex(ref_proj.float()).inverse
    return src_projs.float() @ inv[:, None]


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None, row0: int = 0) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W): rows x, y, 1 (x fastest); y runs
    over rows row0 .. row0 + H - 1 (a band of a taller image)."""
    y = torch.arange(row0, row0 + height, dtype=dtype, device=device)
    x = torch.arange(width, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([xx.reshape(-1), yy.reshape(-1), ones])


def sweep_coordinates(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                      depth_hypos: torch.Tensor, height: int, width: int,
                      row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Project each ref pixel, lifted to each hypothesis depth, into a source.

    Args:
        src_proj, ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        height, width: the reference grid, whose first row is the
            reference image's row ``row0`` (a band under spatial sharding).
    Returns:
        (x_src, y_src), each (B, D, H*W) unnormalised source pixel coords.
    """
    b, d = depth_hypos.shape[:2]
    rel = relative_transforms(src_proj[:, None], ref_proj)[:, 0]
    rot, trans = rel[:, :3, :3], rel[:, :3, 3]
    grid = pixel_grid(height, width, rot.dtype, rot.device, row0)
    rot_xyz = rot @ grid                                   # (B, 3, H*W)
    hypos = depth_hypos.float().reshape(b, d, -1)
    if hypos.shape[-1] == 1:
        hypos = hypos.expand(b, d, height * width)
    xyz = rot_xyz[:, :, None, :] * hypos[:, None] + trans[:, :, None, None]
    z = xyz[:, 2]
    return xyz[:, 0] / z, xyz[:, 1] / z


def reference_grid_coords(x_src: torch.Tensor, y_src: torch.Tensor,
                          height: int, width: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's mixed align-corners convention,
    ``x_eff = x * W / (W - 1) - 0.5`` (see ``mdfnet_tpu/geometry.py``);
    ``height`` and ``width`` are the SOURCE image's (the full height under
    spatial sharding, where the reference grid is a band)."""
    return (x_src * (width / (width - 1.0)) - 0.5,
            y_src * (height / (height - 1.0)) - 0.5)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as a fused multiply-add
    gives it (the JAX package's CPU backend contracts a product that feeds
    an add into one). The product of two f32 values is exact in f64, so
    the f64 sum rounded to f32 is the FMA's result (but where that double
    rounding meets a tie, ~2^-29 of sums), whether or not the f64 add is
    itself fused: the CPU and the card give the same bits."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def matmul(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for small ``m`` (..., I, J) and ``v`` (..., J, N) in f32,
    as the JAX package's CPU dot sums it: a chain of FMAs over j in order
    (XLA's order; for one 4x4 matrix beyond 8192 columns its CPU backend
    pairs the terms instead). Elementwise, so neither TF32 nor a library's
    order enters."""
    m64, v64 = m.double(), v.double()
    acc = m[..., :, :1] * v[..., :1, :]
    for j in range(1, m.shape[-1]):
        acc = torch.addcmul(acc.double(), m64[..., :, j:j + 1],
                            v64[..., j:j + 1, :]).float()
    return acc


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of small f32 matrices (..., n, n), a camera's K or E: LU
    with partial pivoting and its solve against the identity (LAPACK
    ``getrf`` / ``getrs`` through scipy), the JAX package's own route and
    bits on the CPU. Computed on the host and returned on ``m``'s device,
    so the card's projections start from the CPU's bits."""
    from scipy.linalg import lu_factor, lu_solve
    a = m.detach().float().cpu().numpy().reshape(-1, *m.shape[-2:])
    eye = np.eye(m.shape[-1], dtype=np.float32)
    inv = np.stack([lu_solve(lu_factor(x), eye) for x in a]).astype(np.float32)
    return torch.from_numpy(inv.reshape(m.shape)).to(m.device)


def unproject(depth: torch.Tensor, intrinsics: torch.Tensor,
              extrinsics: torch.Tensor) -> torch.Tensor:
    """Back-project depth maps (B, H, W) through K (B, 3, 3) and E (B, 4, 4)
    world -> cam to world points (B, 3, H*W)."""
    b, h, w = depth.shape
    grid = pixel_grid(h, w, device=depth.device).expand(b, 3, h * w)
    cam = matmul(inverse(intrinsics), grid) * depth.reshape(b, 1, -1)
    ones = torch.ones(b, 1, h * w, device=depth.device)
    return matmul(inverse(extrinsics), torch.cat([cam, ones], 1))[:, :3]


def project(xyz_world: torch.Tensor, intrinsics: torch.Tensor,
            extrinsics: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points (B, 3, N) into cameras K (B, 3, 3), E (B, 4, 4): (x, y,
    z_cam), each (B, N); z_cam is the camera-frame depth."""
    b, _, n = xyz_world.shape
    ones = torch.ones(b, 1, n, device=xyz_world.device)
    cam = matmul(extrinsics, torch.cat([xyz_world, ones], 1))[:, :3]
    pix = matmul(intrinsics, cam)
    return pix[:, 0] / pix[:, 2], pix[:, 1] / pix[:, 2], cam[:, 2]

"""Camera geometry for the plane sweep (port of ``mdfnet_tpu/geometry.py``).

Conventions match the reference: intrinsics ``(..., 3, 3)``, extrinsics
``(..., 4, 4)`` world -> camera, pixel coordinates ``(x, y)`` with integer
coordinates on pixel centres.
"""
from __future__ import annotations

import torch


def scale_intrinsics(intrinsics: torch.Tensor, stage: int,
                     num_stages: int = 4) -> torch.Tensor:
    """Scale K for a pyramid stage living at 1/2^(num_stages-1-stage)."""
    factor = 1.0 / (2.0 ** (num_stages - 1 - stage))
    scale = torch.tensor([factor, factor, 1.0], dtype=intrinsics.dtype,
                         device=intrinsics.device).reshape(3, 1)
    return intrinsics * scale


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
               device=None) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W): rows x, y, 1 (x fastest)."""
    y = torch.arange(height, dtype=dtype, device=device)
    x = torch.arange(width, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([xx.reshape(-1), yy.reshape(-1), ones])


def sweep_coordinates(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                      depth_hypos: torch.Tensor, height: int, width: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Project each ref pixel, lifted to each hypothesis depth, into a source.

    Args:
        src_proj, ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
    Returns:
        (x_src, y_src), each (B, D, H*W) unnormalised source pixel coords.
    """
    b, d = depth_hypos.shape[:2]
    rel = relative_transforms(src_proj[:, None], ref_proj)[:, 0]
    rot, trans = rel[:, :3, :3], rel[:, :3, 3]
    grid = pixel_grid(height, width, rot.dtype, rot.device)
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
    ``x_eff = x * W / (W - 1) - 0.5`` (see ``mdfnet_tpu/geometry.py``)."""
    return (x_src * (width / (width - 1.0)) - 0.5,
            y_src * (height / (height - 1.0)) - 0.5)

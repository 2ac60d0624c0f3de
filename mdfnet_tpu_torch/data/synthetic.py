"""Synthetic multi-view scenes with analytic ground truth (counterpart of
``mdfnet_tpu/data/synthetic.py``).

The reference has no test suite; golden-file tests against tiny synthetic
scenes are the substitute. A textured fronto-parallel
(or tilted) plane at a known depth yields analytic GT depth and exactly
consistent multi-view geometry, so model plumbing, loss, fusion and metrics
can all be validated without DTU on disk.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticScene:
    imgs: np.ndarray        # (V, H, W, 3) float32 in [0,1]
    intrinsics: np.ndarray  # (V, 3, 3)
    extrinsics: np.ndarray  # (V, 4, 4) world->cam
    depth: np.ndarray       # (H, W) GT depth of view 0
    depth_range: np.ndarray  # (2,)
    depths: np.ndarray | None = None  # (V, H, W) GT depth of every view


def _texture(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Smooth, high-frequency RGB texture over plane coordinates."""
    r = 0.5 + 0.5 * np.sin(0.13 * u) * np.cos(0.07 * v)
    g = 0.5 + 0.5 * np.sin(0.05 * u + 1.7) * np.sin(0.11 * v + 0.3)
    b = 0.5 + 0.5 * np.cos(0.09 * u - 0.5) * np.cos(0.15 * v + 2.1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def make_plane_scene(height: int = 128, width: int = 160, nviews: int = 3,
                     plane_depth: float = 600.0, tilt: float = 0.0,
                     depth_range=(425.0, 935.0), baseline: float = 12.0,
                     focal: float = 320.0) -> SyntheticScene:
    """Views of a textured plane z = plane_depth + tilt * x_world.

    Cameras share orientation (identity rotation) and are translated along x,
    so every pixel of every view observes the plane and the warp math is
    analytically checkable.
    """
    k = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]], dtype=np.float32)
    intrinsics = np.stack([k] * nviews)

    extrinsics = []
    for v in range(nviews):
        e = np.eye(4, dtype=np.float32)
        # camera v sits at world x = v * baseline: world->cam subtracts it
        e[0, 3] = -v * baseline
        extrinsics.append(e)
    extrinsics = np.stack(extrinsics)

    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")

    imgs = []
    depths = []
    for v in range(nviews):
        cx = v * baseline  # camera center world x
        # ray through pixel: world point = cam_origin + z * dir,
        # dir = K^-1 [x, y, 1]; plane: z = d0 + tilt * x_world
        dx = (xs - k[0, 2]) / k[0, 0]
        dy = (ys - k[1, 2]) / k[1, 1]
        # z = d0 + tilt * (cx + z*dx)  =>  z = (d0 + tilt*cx) / (1 - tilt*dx)
        z = (plane_depth + tilt * cx) / (1.0 - tilt * dx)
        xw = cx + z * dx
        yw = z * dy
        imgs.append(_texture(xw * 4.0, yw * 4.0))
        depths.append(z.astype(np.float32))

    depths = np.stack(depths)
    return SyntheticScene(
        imgs=np.stack(imgs),
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        depth=depths[0],
        depth_range=np.array(depth_range, dtype=np.float32),
        depths=depths,
    )


def _surface_fn(structure: str, base: float):
    """Heightfield z(x_world, y_world) for the structured scenes."""
    if structure == "plane":
        return lambda x, y: np.full_like(x, base)
    if structure == "steps":
        # two rectangular plateaus raised above the base plane — sharp
        # depth discontinuities + occlusion boundaries
        def f(x, y):
            z = np.full_like(x, base)
            z = np.where((x > -30) & (x < 10) & (y > -25) & (y < 5),
                         base - 25.0, z)
            z = np.where((x > 25) & (x < 60) & (y > -5) & (y < 30),
                         base - 45.0, z)
            return z
        return f
    if structure == "sphere":
        # a dome bulging toward the cameras — smoothly varying normals
        def f(x, y):
            r2 = (x - 10.0) ** 2 + (y + 5.0) ** 2
            dome = np.sqrt(np.maximum(55.0 ** 2 - r2, 0.0))
            return base - dome
        return f
    if structure == "ridges":
        # sinusoidal relief — dense mid-frequency structure
        return lambda x, y: base - 18.0 * np.sin(x / 14.0) * np.cos(y / 17.0)
    raise ValueError(f"unknown structure {structure}")


def make_structured_scene(height: int = 64, width: int = 96, nviews: int = 5,
                          structure: str = "steps", base_depth: float = 600.0,
                          depth_range=(425.0, 935.0), baseline: float = 12.0,
                          focal: float = 320.0) -> SyntheticScene:
    """Views of a textured HEIGHTFIELD z = f(x_w, y_w) (steps / sphere dome /
    sinusoidal ridges) rendered by per-pixel ray marching with occlusion —
    the multi-structure stand-in for real scenes: depth
    discontinuities, curved surfaces, and slanted relief that a plane scene
    cannot exercise. Multi-view consistent by construction (every view ray
    marches the same surface)."""
    f = _surface_fn(structure, base_depth)
    k = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]], dtype=np.float32)
    intrinsics = np.stack([k] * nviews)
    extrinsics = []
    for v in range(nviews):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = -v * baseline
        extrinsics.append(e)
    extrinsics = np.stack(extrinsics)

    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    z_lo, z_hi = base_depth - 70.0, base_depth + 10.0
    n_march = 700

    imgs, depths = [], []
    for v in range(nviews):
        cx = v * baseline
        dx = (xs - k[0, 2]) / k[0, 0]
        dy = (ys - k[1, 2]) / k[1, 1]
        # march depth: first crossing of h(z) = z - f(x(z), y(z)) from below
        # (the ray starts above/behind the surface at z_lo) = the VISIBLE
        # surface; refine the crossing by linear interpolation
        zs = np.linspace(z_lo, z_hi, n_march)
        h_prev = np.full(xs.shape, -1.0)
        z_hit = np.full(xs.shape, np.nan)
        z_prev = zs[0]
        for z in zs:
            h = z - f(cx + z * dx, z * dy)
            cross = np.isnan(z_hit) & (h >= 0.0) & (h_prev < 0.0)
            if cross.any():
                # linear root between z_prev and z (exact for planes; the
                # march step bounds the error elsewhere)
                denom = np.where(h - h_prev > 1e-12, h - h_prev, 1.0)
                frac = np.clip(-h_prev / denom, 0.0, 1.0)
                z_root = z_prev + frac * (z - z_prev)
                z_hit = np.where(cross, z_root, z_hit)
            h_prev, z_prev = h, z
        z_hit = np.where(np.isnan(z_hit), z_hi, z_hit)
        xw = cx + z_hit * dx
        yw = z_hit * dy
        imgs.append(_texture(xw * 4.0, yw * 4.0))
        depths.append(z_hit.astype(np.float32))

    depths = np.stack(depths)
    return SyntheticScene(
        imgs=np.stack(imgs),
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        depth=depths[0],
        depth_range=np.array(depth_range, dtype=np.float32),
        depths=depths,
    )


def write_dtu_train_tree(root: str, scans=(1, 2), nviews: int = 4,
                         lightings: int = 2, height: int = 64,
                         width: int = 96, plane_depth: float = 600.0,
                         tilt: float = 0.05, baseline: float = 12.0,
                         structures=None) -> None:
    """Materialise a synthetic scene on disk in the DTU TRAIN layout
    (reference load/getpath.py:4-45) so the real train CLI can run on it.

    Every scan is the same plane scene (different tilt per scan) rendered to
    Rectified/scan{X}_train PNGs, with Cameras/{v:08d}_cam.txt, Cameras/
    pair.txt, and Depths/scan{X}_train GT PFMs.
    """
    import os
    from PIL import Image
    from mdfnet_tpu_torch.data.formats import write_cam_file, write_pair_file, write_pfm

    os.makedirs(os.path.join(root, "Cameras"), exist_ok=True)
    pairs = [(r, [s for s in range(nviews) if s != r]) for r in range(nviews)]
    write_pair_file(os.path.join(root, "Cameras", "pair.txt"), pairs)

    for si, scan in enumerate(scans):
        if structures is not None:
            # per-scan structured heightfields (steps/sphere/ridges)
            scene = make_structured_scene(
                height=height, width=width, nviews=nviews,
                structure=structures[si % len(structures)],
                base_depth=plane_depth + 20.0 * si, baseline=baseline)
        else:
            scene = make_plane_scene(height=height, width=width,
                                     nviews=nviews,
                                     plane_depth=plane_depth + 20.0 * si,
                                     tilt=tilt, baseline=baseline)
        rect = os.path.join(root, "Rectified", f"scan{scan}_train")
        dep = os.path.join(root, "Depths", f"scan{scan}_train")
        os.makedirs(rect, exist_ok=True)
        os.makedirs(dep, exist_ok=True)
        for v in range(nviews):
            if si == 0:
                write_cam_file(
                    os.path.join(root, "Cameras", f"{v:08d}_cam.txt"),
                    scene.intrinsics[v], scene.extrinsics[v], (425.0, 2.5))
            img8 = (scene.imgs[v] * 255).astype(np.uint8)
            for light in range(lightings):
                Image.fromarray(img8).save(os.path.join(
                    rect, f"rect_{v + 1:03d}_{light}_r5000.png"))
            write_pfm(os.path.join(dep, f"depth_map_{v:04d}.pfm"),
                      scene.depths[v])


def write_dtu_eval_tree(root: str, scans=(9,), nviews: int = 5,
                        height: int = 64, width: int = 96,
                        plane_depth: float = 600.0, tilt: float = 0.05,
                        baseline: float = 12.0,
                        structure: str | None = None) -> "SyntheticScene":
    """Materialise a synthetic scene in the DTU EVAL layout
    (scan{X}/images/{v:08d}.jpg + scan{X}/cams + root pair.txt) for the eval
    CLI. Returns the scene (GT for downstream metric checks). JPEG
    compression noise is acceptable for plumbing tests.
    """
    import os
    from PIL import Image
    from mdfnet_tpu_torch.data.formats import write_cam_file, write_pair_file

    if structure is not None:
        scene = make_structured_scene(height=height, width=width,
                                      nviews=nviews, structure=structure,
                                      base_depth=plane_depth,
                                      baseline=baseline)
    else:
        scene = make_plane_scene(height=height, width=width, nviews=nviews,
                                 plane_depth=plane_depth, tilt=tilt,
                                 baseline=baseline)
    os.makedirs(root, exist_ok=True)
    pairs = [(r, [s for s in range(nviews) if s != r]) for r in range(nviews)]
    write_pair_file(os.path.join(root, "pair.txt"), pairs)
    for scan in scans:
        imgd = os.path.join(root, f"scan{scan}", "images")
        camd = os.path.join(root, f"scan{scan}", "cams")
        os.makedirs(imgd, exist_ok=True)
        os.makedirs(camd, exist_ok=True)
        for v in range(nviews):
            img8 = (scene.imgs[v] * 255).astype(np.uint8)
            Image.fromarray(img8).save(
                os.path.join(imgd, f"{v:08d}.jpg"), quality=98)
            write_cam_file(os.path.join(camd, f"{v:08d}_cam.txt"),
                           scene.intrinsics[v], scene.extrinsics[v],
                           (425.0, 2.5, 0.0, 935.0))
    return scene


def write_tanks_eval_tree(root: str, scenes=("Family",), nviews: int = 11,
                          height: int = 64, width: int = 96,
                          plane_depth: float = 600.0, tilt: float = 0.05,
                          baseline: float = 12.0, focal: float = 320.0,
                          depth_range=(425.0, 935.0)) -> "SyntheticScene":
    """Materialise a synthetic tilted plane in the Tanks & Temples EVAL
    layout (<scene>/images/{v:08d}.jpg, <scene>/cams_1/{v:08d}_cam.txt and
    a per-scene pair.txt, every other view a source) for the eval CLI's
    Tanks branch. The cams' info line starts with the depth range, the
    columns the Tanks sampler reads. Returns the scene.
    """
    import os
    from PIL import Image
    from mdfnet_tpu_torch.data.formats import write_cam_file, write_pair_file

    scene = make_plane_scene(height=height, width=width, nviews=nviews,
                             plane_depth=plane_depth, tilt=tilt,
                             baseline=baseline, focal=focal,
                             depth_range=depth_range)
    pairs = [(r, sorted((s for s in range(nviews) if s != r),
                        key=lambda s: abs(s - r))) for r in range(nviews)]
    for name in scenes:
        imgd = os.path.join(root, name, "images")
        camd = os.path.join(root, name, "cams_1")
        os.makedirs(imgd, exist_ok=True)
        os.makedirs(camd, exist_ok=True)
        write_pair_file(os.path.join(root, name, "pair.txt"), pairs)
        for v in range(nviews):
            img8 = (scene.imgs[v] * 255).astype(np.uint8)
            Image.fromarray(img8).save(
                os.path.join(imgd, f"{v:08d}.jpg"), quality=98)
            write_cam_file(os.path.join(camd, f"{v:08d}_cam.txt"),
                           scene.intrinsics[v], scene.extrinsics[v],
                           (*depth_range, 0.0, 0.0))
    return scene


def make_batch(scene: SyntheticScene, batch: int = 1) -> dict:
    """Package a scene as the model's input dict (channels-last, batched)."""
    def rep(x):
        return np.broadcast_to(x[None], (batch,) + x.shape).copy()

    h, w = scene.depth.shape
    gt = scene.depth
    pyramid = {
        "3": gt[::8, ::8].copy(),
        "2": gt[::4, ::4].copy(),
        "1": gt[::2, ::2].copy(),
        "0": gt,
    }
    return {
        "imgs": rep(scene.imgs),
        "intrinsics": rep(scene.intrinsics),
        "extrinsics": rep(scene.extrinsics),
        "depth_range": rep(scene.depth_range),
        "ref_depths": {k: rep(v) for k, v in pyramid.items()},
    }

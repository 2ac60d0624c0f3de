"""Dataset samplers for DTU, BlendedMVS and Tanks & Temples (counterpart of
``mdfnet_tpu/data/datasets.py``).

Host-side, numpy-only index->item samplers that produce exactly the per-item
dicts the reference loaders emit, decoupled from any framework DataLoader:
batching and shuffling live in data/pipeline.py.

Directory layouts (reference load/getpath.py:4-45):
    DTU train:   <root>/Rectified/scan{X}_train/rect_{v+1:03d}_{l}_r5000.png
                 <root>/Cameras/{v:08d}_cam.txt     <root>/Cameras/pair.txt
                 <root>/Depths/scan{X}_train/depth_map_{v:04d}.pfm
    DTU eval:    <root>/scan{X}/images/{v:08d}.jpg  <root>/scan{X}/cams/...
                 <root>/pair.txt
    BlendedMVS:  <root>/<scene>/blended_images|cams|rendered_depth_maps/...
                 <root>/training_list.txt, per-scene cams/pair.txt
    Tanks:       <root>/<scene>/images|cams_1/..., per-scene pair.txt
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mdfnet_tpu_torch.data.formats import (
    read_cam_file, read_image, read_pair_file, read_pfm)

DTU_DEPTH_RANGE = np.array([425.0, 935.0], dtype=np.float32)


def _item_rng(seed: int, epoch: int, idx: int) -> np.random.RandomState:
    """Per-item deterministic RNG for robust view sampling.

    A single shared RandomState mutated from multiple loader threads is
    statistically racy and makes runs irreproducible; hashing (seed, epoch,
    idx) into an independent stream per item is thread-safe and gives every
    epoch a fresh (but reproducible) sampling, like the reference's global
    seeding intends (reference config.py:12-21).
    """
    mixed = (seed * 0x9E3779B97F4A7C15
             + epoch * 0xBF58476D1CE4E5B9
             + idx * 0x94D049BB133111EB) % (2 ** 64)
    return np.random.RandomState(mixed % (2 ** 32))


def _depth_pyramid(depth: np.ndarray) -> Dict[str, np.ndarray]:
    """4-level GT pyramid by nearest subsampling.

    The reference uses cv2.resize(..., INTER_NEAREST) to w//2^k (reference
    load/dtutrain.py:51-58); for even sizes that picks rows/cols 0, 2, 4, ...
    — equivalent to strided slicing, which avoids the cv2 dependency.
    """
    return {
        "3": np.ascontiguousarray(depth[::8, ::8]),
        "2": np.ascontiguousarray(depth[::4, ::4]),
        "1": np.ascontiguousarray(depth[::2, ::2]),
        "0": depth,
    }


class DTUTrainDataset:
    """Items = scan x 49 ref views x 7 lightings (reference load/dtutrain.py)."""

    def __init__(self, root: str, scans: Sequence[int],
                 lightings: Sequence[int] = tuple(range(7)), nviews: int = 5,
                 robust_sampling: bool = True, seed: int = 1):
        self.root = root
        self.nviews = nviews
        self.robust = robust_sampling
        self.seed = seed
        self.epoch = 0
        _, self.pairs = read_pair_file(os.path.join(root, "Cameras", "pair.txt"))
        self.items: List[Tuple[int, int, int, List[int]]] = [
            (scan, light, ref, srcs)
            for scan in scans for ref, srcs in self.pairs for light in lightings]

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch's per-item sampling streams (thread-safe)."""
        self.epoch = epoch

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan, light, ref, srcs = self.items[idx]
        if self.robust:
            rng = _item_rng(self.seed, self.epoch, idx)
            chosen = list(rng.choice(len(srcs) - 1, self.nviews - 1,
                                     replace=False) + 1)
            views = [ref] + [srcs[i] for i in chosen]
        else:
            views = [ref] + srcs[:self.nviews - 1]

        imgs, intr, extr = [], [], []
        scan_dir = f"scan{scan}_train"
        for i, vid in enumerate(views):
            img_path = os.path.join(self.root, "Rectified", scan_dir,
                                    f"rect_{vid + 1:03d}_{light}_r5000.png")
            cam_path = os.path.join(self.root, "Cameras", f"{vid:08d}_cam.txt")
            imgs.append(read_image(img_path))
            k, e, _ = read_cam_file(cam_path)
            intr.append(k)
            extr.append(e)
            if i == 0:
                dpath = os.path.join(self.root, "Depths", scan_dir,
                                     f"depth_map_{vid:04d}.pfm")
                gt = read_pfm(dpath)[0].astype(np.float32)

        return {
            "imgs": np.stack(imgs).astype(np.float32),  # (V, H, W, 3)
            "intrinsics": np.stack(intr),
            "extrinsics": np.stack(extr),
            "ref_depths": _depth_pyramid(gt),
            "depth_range": DTU_DEPTH_RANGE.copy(),
        }


class DTUEvalDataset:
    """DTU test scans at 1600x1200, cropped to height 1184 so all four scales
    divide (reference load/dtueval.py:34)."""

    def __init__(self, root: str, scans: Sequence[int], nviews: int = 5,
                 crop_height: int = 1184):
        self.root = root
        self.nviews = nviews
        self.crop_height = crop_height
        _, self.pairs = read_pair_file(os.path.join(root, "pair.txt"))
        self.items = [(scan, ref, srcs) for scan in scans
                      for ref, srcs in self.pairs]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        scan, ref, srcs = self.items[idx]
        views = [ref] + srcs[:self.nviews - 1]
        imgs, intr, extr = [], [], []
        for vid in views:
            img = read_image(os.path.join(self.root, f"scan{scan}", "images",
                                          f"{vid:08d}.jpg"))
            imgs.append(img[:self.crop_height])
            k, e, _ = read_cam_file(os.path.join(self.root, f"scan{scan}",
                                                 "cams", f"{vid:08d}_cam.txt"))
            intr.append(k)
            extr.append(e)
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "intrinsics": np.stack(intr),
            "extrinsics": np.stack(extr),
            "depth_range": DTU_DEPTH_RANGE.copy(),
            "filename": f"scan{scan}" + "/{}/" + f"{ref:08d}" + "{}",
        }


class BlendedMVSTrainDataset:
    """BlendedMVS 768x576 training scenes (reference load/blendedtrain.py):
    robust sampling from the top-7 srcs, per-scene depth range from the cam
    file's info line (min at index 0, max at index 3), short src lists padded
    by repeating the best src."""

    def __init__(self, root: str, nviews: int = 5, robust_sampling: bool = True,
                 seed: int = 1):
        self.root = root
        self.nviews = nviews
        self.robust = robust_sampling
        self.seed = seed
        self.epoch = 0
        with open(os.path.join(root, "training_list.txt")) as f:
            scans = [ln.strip() for ln in f if ln.strip()]
        self.items: List[Tuple[str, int, List[int]]] = []
        for scan in scans:
            _, pairs = read_pair_file(os.path.join(root, scan, "cams", "pair.txt"))
            for ref, srcs in pairs:
                if not srcs:
                    continue
                if len(srcs) < nviews:
                    srcs = srcs + [srcs[0]] * (nviews - len(srcs))
                self.items.append((scan, ref, srcs))

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch's per-item sampling streams (thread-safe)."""
        self.epoch = epoch

    def __getitem__(self, idx: int) -> Dict:
        scan, ref, srcs = self.items[idx]
        if self.robust:
            top = srcs[:7]
            rng = _item_rng(self.seed, self.epoch, idx)
            chosen = list(rng.choice(len(top) - 1, self.nviews - 1,
                                     replace=False) + 1)
            views = [ref] + [top[i] for i in chosen]
        else:
            views = [ref] + srcs[:self.nviews - 1]

        imgs, intr, extr = [], [], []
        depth_range = None
        for i, vid in enumerate(views):
            imgs.append(read_image(os.path.join(
                self.root, scan, "blended_images", f"{vid:08d}.jpg")))
            k, e, info = read_cam_file(os.path.join(
                self.root, scan, "cams", f"{vid:08d}_cam.txt"))
            intr.append(k)
            extr.append(e)
            if i == 0:
                depth_range = np.array([info[0], info[3]], dtype=np.float32)
                gt = read_pfm(os.path.join(
                    self.root, scan, "rendered_depth_maps",
                    f"{vid:08d}.pfm"))[0].astype(np.float32)

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "intrinsics": np.stack(intr),
            "extrinsics": np.stack(extr),
            "ref_depths": _depth_pyramid(gt),
            "depth_range": depth_range,
        }


class TanksEvalDataset:
    """Tanks & Temples eval: 1080-high images cropped to 1056, per-scene
    pair.txt and cams_1 camera files, ref view's depth range
    (reference load/tankseval.py)."""

    def __init__(self, root: str, scenes: Sequence[str], nviews: int = 11,
                 crop_height: int = 1056):
        self.root = root
        self.nviews = nviews
        self.crop_height = crop_height
        self.items: List[Tuple[str, int, List[int]]] = []
        for scene in scenes:
            _, pairs = read_pair_file(os.path.join(root, scene, "pair.txt"))
            for ref, srcs in pairs:
                self.items.append((scene, ref, srcs))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        scene, ref, srcs = self.items[idx]
        views = [ref] + srcs[:self.nviews - 1]
        imgs, intr, extr = [], [], []
        depth_range = None
        for i, vid in enumerate(views):
            img = read_image(os.path.join(self.root, scene, "images",
                                          f"{vid:08d}.jpg"))
            imgs.append(img[:self.crop_height])
            k, e, info = read_cam_file(os.path.join(
                self.root, scene, "cams_1", f"{vid:08d}_cam.txt"))
            intr.append(k)
            extr.append(e)
            if i == 0:
                # the reference feeds the raw info line and the model reads
                # columns 0/1 as min/max (tankseval.py:58-66, core.py:37)
                depth_range = np.array([info[0], info[1]], dtype=np.float32)
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "intrinsics": np.stack(intr),
            "extrinsics": np.stack(extr),
            "depth_range": depth_range,
            "filename": scene + "/{}/" + f"{ref:08d}" + "{}",
        }

"""Typed configuration of the port (counterpart of ``mdfnet_tpu/config.py``).

The same dataclasses, fields and defaults as the JAX package's, kept here so
that the port imports nothing of ``mdfnet_tpu``. ``models/registry.py`` reads
``ModelConfig``; the train and eval CLIs read the others.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network topology. Defaults reproduce the reference 4-scale MDF-Net
    (reference config.py:192-218)."""
    stages: int = 4
    chs: Tuple[int, ...] = (8, 16, 32, 64)
    ndepths: Tuple[int, ...] = (48, 24, 8)
    curve_classes: Tuple[Optional[str], ...] = (None, "gauss1", "laplace")
    prob_threshs: Tuple[float, ...] = (0.0, 0.95, 1e-5)
    ngroups: Tuple[int, ...] = (32, 16, 8)
    # compute dtype for conv stacks: "float32" | "bfloat16";
    # geometry/softmax/fitting always run f32.
    compute_dtype: str = "float32"
    # plane-sweep warp of the JAX package: "dense" | "pallas" | "fused" |
    # "gather". In the port, "fused" selects the fused train aggregate (the
    # stats kernel, then the aggregate kernel with a per-view BN affine);
    # every other value, and eval, run the same kernels.
    warp_impl: str = "dense"
    # JAX-only switches, kept so that configs carry over field for field
    pallas_conv: bool = False
    remat: bool = False
    wfold: bool = False
    # pluggable-unit extension points (the reference's unused alternatives)
    aggregate_impl: str = "vector"   # "vector" | "variance"
    hypo_impl: str = "fit"           # "fit" (MDF curve fitting) | "atv"
    refine_impl: str = "refine2"     # "refine2" | "refine1" (image-guided)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference config.py:47-89, train.py:11-68)."""
    nviews: int = 5
    robust_views: bool = True
    start_epoch: int = 1
    max_epochs: int = 30
    batch_size: int = 4
    lr: float = 1e-3
    lr_decay_factor: float = 0.9  # lr * (1 - (e-1)/max)^factor per epoch
    seed: int = 1
    checkpoint_dir: str = "pth"
    log_every: int = 10
    num_prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings (reference config.py:95-121)."""
    nviews: int = 5  # 5 for DTU, 11 for Tanks
    output_dir: str = "outputs"
    batch_size: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset roots and splits (reference config.py:127-180)."""
    root_dir: str = "/hy-tmp"
    dtu_train_subdir: str = "dtu640x512"
    dtu_eval_subdir: str = "dtu1600x1200"
    blendedmvs_subdir: str = "blendedmvs768x576"
    tanks_subdir: str = "TankandTemples"
    # DTU train/eval scan splits (reference config.py:131-150)
    dtu_train_scans: Tuple[int, ...] = (
        2, 6, 7, 8, 14, 16, 18, 19, 20, 22, 30, 31, 36, 39, 41, 42, 44,
        45, 46, 47, 50, 51, 52, 53, 55, 57, 58, 60, 61, 63, 64, 65, 68, 69,
        70, 71, 72, 74, 76, 83, 84, 85, 87, 88, 89, 90, 91, 92, 93, 94, 95,
        96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 107, 108, 109, 111,
        112, 113, 115, 116, 119, 120, 121, 122, 123, 124, 125, 126, 127, 128)
    dtu_eval_scans: Tuple[int, ...] = (
        1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49, 62,
        75, 77, 110, 114, 118)
    dtu_lightings: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)
    tanks_intermediate: Tuple[str, ...] = (
        "Family", "Francis", "Horse", "Lighthouse", "M60", "Panther",
        "Playground", "Train")
    tanks_advanced: Tuple[str, ...] = (
        "Auditorium", "Ballroom", "Courtroom", "Museum", "Temple", "Palace")
    # eval-time crops so all pyramid scales divide evenly
    dtu_eval_crop_height: int = 1184   # reference load/dtueval.py:34
    tanks_crop_height: int = 1056      # reference load/tankseval.py:36

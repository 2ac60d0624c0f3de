"""Training loop + CLI of the port (twin of ``mdfnet_tpu/train.py``).

    python -m mdfnet_tpu_torch.train -d dtu [--root DIR] [--scans 2,6]
        [--lightings N] [--epochs N] [--batch-size N] [--nviews N]
        [--ckpt-dir DIR] [-p CKPT.pth] [--fast] [--remat]
        [--world-size N] [--backend nccl|gloo] [--device cuda|cpu]

Per epoch: the polynomial LR, the mean loss appended to
``<ckpt-dir>/epoch_loss.txt`` and a checkpoint ``<ckpt-dir>/<dataset>_<epoch>.pth``
(``train_lib.save_checkpoint``). ``-p`` resumes from a port checkpoint
(weights, BatchNorm statistics and Adam's moments) or warm-starts from a
reference ``.pth`` (weights only). The DTU train set sits under
``<root>/dtu640x512``.

It trains on the card (``--device cuda``, the default; with no card it
exits with an error), where every kernel of the step is a hand-written CUDA
kernel; ``--fast`` runs the convs in bf16 (the JAX CLI's ``--fast``),
otherwise in f32 on the same kernels. ``--device cpu`` runs the plain
versions on the CPU. ``--remat`` recomputes the backbone, the aggregates
and the U-Nets in the backward (``models/core.py``).

Data parallelism (``parallel/mesh.py``, the JAX CLI's ``shard_map`` step):
``--world-size N`` ranks, one process each, started here with ``spawn``;
by default the largest divisor of the batch that is at most the number of
cards (one rank a card; on the CPU, 1). Each rank takes its contiguous
share of every global batch. One rank runs the single-process path with no
process group. ``--backend`` defaults to NCCL where each rank has a card of
its own, else gloo (ranks sharing a card, or ``--device cpu``). Only rank 0
writes ``epoch_loss.txt`` and the checkpoints; ``-p`` resumes every rank
from the same file.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import time

import torch

from mdfnet_tpu_torch.config import (DataConfig, MeshConfig, ModelConfig,
                                     TrainConfig)
from mdfnet_tpu_torch.data import (BatchLoader, BlendedMVSTrainDataset,
                                   DTUTrainDataset)
from mdfnet_tpu_torch.models.registry import build_model, resolve_device
from mdfnet_tpu_torch.parallel.mesh import (data_extent, default_backend,
                                            init_data_parallel,
                                            local_init_method, rank_device,
                                            shard_batch, spawn_ranks)
from mdfnet_tpu_torch.train_lib import (batch_to_device, make_optimizer,
                                        poly_lr, resume, save_checkpoint,
                                        set_lr, train_step)

log = logging.getLogger("mdfnet_tpu_torch.train")


def train(dataset, model_config: ModelConfig, train_config: TrainConfig,
          dataset_name: str = "dtu", pre_model: str | None = None,
          device: str | torch.device = "cuda", world: int | None = None,
          backend: str | None = None) -> None:
    """Train from ``train_config.start_epoch`` (or the resumed epoch) to
    ``max_epochs`` on ``device``: the card unless the caller asks for the
    CPU. ``world``: the data-parallel ranks (default: the largest divisor
    of the batch that is at most the number of cards; 1 on the CPU);
    ``backend``: their process group's (default :func:`default_backend`)."""
    device = resolve_device(device)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    world = data_extent(MeshConfig(data_parallel=world or -1),
                        train_config.batch_size, n_devices)
    if world == 1:
        _train(dataset, model_config, train_config, dataset_name, pre_model,
               device)
        return
    backend = backend or default_backend(world, device.type)
    if device.type == "cuda":
        # once, here: the ranks would each compile the kernels
        from mdfnet_tpu_torch.ops.cuda import build
        build.build()
    spawn_ranks(_train_rank, world, (
        dataset, model_config, train_config, dataset_name, pre_model,
        device.type, backend, local_init_method()))


def _train_rank(rank: int, world: int, dataset, model_config, train_config,
                dataset_name, pre_model, device_type, backend, init_method):
    """One rank of a data-parallel run (started by :func:`spawn_ranks`)."""
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s-%(levelname)s-rank {rank}: "
                               f"%(message)s")
    device = rank_device(rank, device_type)
    group = init_data_parallel(rank, world, backend, init_method)
    try:
        _train(dataset, model_config, train_config, dataset_name, pre_model,
               device, group=group, rank=rank, world=world)
    finally:
        torch.distributed.destroy_process_group()


def _train(dataset, model_config, train_config, dataset_name, pre_model,
           device, group=None, rank: int = 0, world: int = 1) -> None:
    """The loop of one process: the whole batch (``group`` None) or rank
    ``rank``'s share of it."""
    if rank == 0:
        os.makedirs(train_config.checkpoint_dir, exist_ok=True)
    model = build_model(model_config, seed=train_config.seed,
                        device=device).requires_grad_(True)
    optimizer = make_optimizer(model, train_config.lr)
    start_epoch = train_config.start_epoch
    if pre_model:
        start_epoch = resume(pre_model, model, optimizer)
        log.info("resumed from %s at epoch %d", pre_model, start_epoch)

    for epoch in range(start_epoch, train_config.max_epochs + 1):
        set_lr(optimizer, poly_lr(epoch, train_config.lr,
                                  train_config.max_epochs,
                                  train_config.lr_decay_factor))
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)   # per-(epoch, item) view sampling
        # a shuffle seeded by the epoch: a resumed run sees the same order,
        # and every rank the same global batches
        loader = BatchLoader(dataset, train_config.batch_size, shuffle=True,
                             drop_last=True, num_workers=2,
                             seed=train_config.seed + epoch)
        epoch_loss, n_batches = 0.0, 0
        for i, batch in enumerate(loader):
            t0 = time.perf_counter()
            if group is not None:
                batch = shard_batch(batch, rank, world)
            loss = float(train_step(model, optimizer,
                                    batch_to_device(batch, device),
                                    group=group))
            if not math.isfinite(loss):
                # fail fast on divergence: the last good checkpoint is the
                # previous epoch's
                raise FloatingPointError(
                    f"non-finite loss {loss} at epoch {epoch} batch {i}; "
                    f"resume from the last checkpoint with -p")
            epoch_loss += loss
            n_batches += 1
            if i % train_config.log_every == 0:
                log.info("epoch %d batch %d/%d loss %.5f (%.3fs)", epoch,
                         i + 1, len(loader), loss, time.perf_counter() - t0)

        mean_loss = epoch_loss / max(n_batches, 1)
        log.info("epoch %d mean loss %.5f", epoch, mean_loss)
        if rank == 0:
            with open(os.path.join(train_config.checkpoint_dir,
                                   "epoch_loss.txt"), "a") as f:
                f.write(f"{mean_loss}\n")
            save_checkpoint(os.path.join(train_config.checkpoint_dir,
                                         f"{dataset_name}_{epoch}.pth"),
                            model, optimizer, epoch)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s-%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="mdfnet_tpu_torch training")
    parser.add_argument("-p", "--pre_model", default=None,
                        help="checkpoint to resume (port or reference .pth)")
    parser.add_argument("-d", "--dataset", default="dtu",
                        choices=["dtu", "blendedmvs"])
    parser.add_argument("--root", default=None, help="dataset root override")
    parser.add_argument("--scans", default=None,
                        help="comma-separated scan ids (default: full split)")
    parser.add_argument("--lightings", type=int, default=None,
                        help="number of DTU lighting conditions (default: 7)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="max epochs (default: reference's 30)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--nviews", type=int, default=None)
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint directory (default: pth)")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 conv compute (f32 BN statistics, loss, "
                             "master weights and Adam)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbone, the aggregates and "
                             "the U-Nets in the backward: less activation "
                             "memory for more time")
    parser.add_argument("--world-size", type=int, default=None,
                        help="data-parallel ranks (default: the largest "
                             "divisor of the batch <= the number of cards)")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="the ranks' process group (default: nccl with "
                             "a card a rank, else gloo)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; fails without a card) or cpu "
                             "(the plain versions)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))

    data_cfg = DataConfig(root_dir=args.root) if args.root else DataConfig()
    model_cfg = ModelConfig(compute_dtype="bfloat16" if args.fast
                            else "float32", remat=args.remat)
    overrides = {}
    if args.epochs is not None:
        overrides["max_epochs"] = args.epochs
    if args.nviews is not None:
        overrides["nviews"] = args.nviews
    if args.ckpt_dir is not None:
        overrides["checkpoint_dir"] = args.ckpt_dir
    default_batch = 4 if args.dataset == "dtu" else 6
    overrides["batch_size"] = args.batch_size or default_batch
    train_cfg = TrainConfig(**overrides)

    if args.dataset == "dtu":
        scans = (tuple(int(s) for s in args.scans.split(","))
                 if args.scans else data_cfg.dtu_train_scans)
        lightings = (tuple(range(args.lightings)) if args.lightings
                     else data_cfg.dtu_lightings)
        dataset = DTUTrainDataset(
            os.path.join(data_cfg.root_dir, data_cfg.dtu_train_subdir),
            scans=scans, lightings=lightings, nviews=train_cfg.nviews,
            robust_sampling=train_cfg.robust_views)
    else:
        dataset = BlendedMVSTrainDataset(
            os.path.join(data_cfg.root_dir, data_cfg.blendedmvs_subdir),
            nviews=train_cfg.nviews, robust_sampling=train_cfg.robust_views)

    log.info("training on %s, %s convs", torch.cuda.get_device_name(0)
             if device.type == "cuda" else "cpu", model_cfg.compute_dtype)
    train(dataset, model_cfg, train_cfg, dataset_name=args.dataset,
          pre_model=args.pre_model, device=device, world=args.world_size,
          backend=args.backend)


if __name__ == "__main__":
    main()

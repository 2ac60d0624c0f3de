"""Data parallelism over ranks (counterpart of ``mdfnet_tpu/parallel/``)."""

from mdfnet_tpu_torch.parallel.mesh import (data_extent, data_world,
                                            default_backend,
                                            init_data_parallel,
                                            local_init_method, rank_device,
                                            shard_batch, spawn_ranks)

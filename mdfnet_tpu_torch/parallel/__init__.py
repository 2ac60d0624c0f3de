"""Data parallelism and spatial sharding over ranks (counterpart of
``mdfnet_tpu/parallel/``)."""

from mdfnet_tpu_torch.parallel import halo, spatial
from mdfnet_tpu_torch.parallel.halo import (all_gather_rows, current_ctx,
                                            halo_exchange, spatial_sharding)
from mdfnet_tpu_torch.parallel.mesh import (data_extent, data_world,
                                            default_backend,
                                            init_data_parallel,
                                            local_init_method, rank_device,
                                            shard_batch, spawn_ranks)
from mdfnet_tpu_torch.parallel.spatial import spatial_eval_forward

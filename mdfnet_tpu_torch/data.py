"""Host-side data helpers of the port: the synthetic scenes and the DTU
eval and train trees, the PFM / pair-file formats, the DTU train dataset
and the batch loader.

They are the JAX package's own JAX-free modules (``mdfnet_tpu.data``),
reused by import so both packages read and write the same bytes; callers of
the port import them from here.
"""
from mdfnet_tpu.data.datasets import DTUTrainDataset
from mdfnet_tpu.data.formats import read_pair_file, read_pfm, write_pair_file
from mdfnet_tpu.data.pipeline import BatchLoader
from mdfnet_tpu.data.synthetic import (make_batch, make_plane_scene,
                                       write_dtu_eval_tree,
                                       write_dtu_train_tree)

__all__ = ["BatchLoader", "DTUTrainDataset", "make_batch", "make_plane_scene",
           "read_pair_file", "read_pfm", "write_dtu_eval_tree",
           "write_dtu_train_tree", "write_pair_file"]

"""Host-side data layer of the port: the PFM / cam / pair file formats, the
DTU and BlendedMVS samplers, the batch loader and the synthetic scenes and
DTU trees (counterparts of ``mdfnet_tpu/data``, numpy only)."""
from mdfnet_tpu_torch.data.datasets import (BlendedMVSTrainDataset,
                                            DTUEvalDataset, DTUTrainDataset)
from mdfnet_tpu_torch.data.formats import (read_cam_file, read_image,
                                           read_pair_file, read_pfm,
                                           write_cam_file, write_depth_png,
                                           write_pair_file, write_pfm)
from mdfnet_tpu_torch.data.pipeline import BatchLoader
from mdfnet_tpu_torch.data.synthetic import (make_batch, make_plane_scene,
                                             make_structured_scene,
                                             write_dtu_eval_tree,
                                             write_dtu_train_tree)

__all__ = ["BatchLoader", "BlendedMVSTrainDataset", "DTUEvalDataset",
           "DTUTrainDataset", "make_batch", "make_plane_scene",
           "make_structured_scene", "read_cam_file", "read_image",
           "read_pair_file", "read_pfm", "write_cam_file", "write_depth_png",
           "write_dtu_eval_tree", "write_dtu_train_tree", "write_pair_file",
           "write_pfm"]

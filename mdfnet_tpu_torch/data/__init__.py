"""Host-side data layer of the port: the PFM / cam / pair file formats, the
DTU, BlendedMVS and Tanks & Temples samplers, the batch loader and the
synthetic scenes and DTU and Tanks trees (counterparts of
``mdfnet_tpu/data``, numpy only)."""
from mdfnet_tpu_torch.data.datasets import (BlendedMVSTrainDataset,
                                            DTUEvalDataset, DTUTrainDataset,
                                            TanksEvalDataset)
from mdfnet_tpu_torch.data.formats import (read_cam_file, read_image,
                                           read_pair_file, read_pfm,
                                           write_cam_file, write_depth_png,
                                           write_mask_png, write_pair_file,
                                           write_pfm)
from mdfnet_tpu_torch.data.pipeline import BatchLoader
from mdfnet_tpu_torch.data.synthetic import (make_batch, make_plane_scene,
                                             make_structured_scene,
                                             write_dtu_eval_tree,
                                             write_dtu_train_tree,
                                             write_tanks_eval_tree)

__all__ = ["BatchLoader", "BlendedMVSTrainDataset", "DTUEvalDataset",
           "DTUTrainDataset", "TanksEvalDataset", "make_batch",
           "make_plane_scene", "make_structured_scene", "read_cam_file",
           "read_image", "read_pair_file", "read_pfm", "write_cam_file",
           "write_depth_png", "write_dtu_eval_tree", "write_dtu_train_tree",
           "write_mask_png", "write_pair_file", "write_pfm",
           "write_tanks_eval_tree"]

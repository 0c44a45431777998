"""The parallelism layer (port of ``tpusr/dist``): meshes on
``torch.distributed``, data, tensor, pipeline and spatial parallelism, and
the multi-process bootstrap (``tpusr_torch.dist.bootstrap``)."""

from tpusr_torch.dist.mesh import (axis_size, batch_sharding, make_mesh,
                                   pad_to_multiple, replicate,
                                   replicated_sharding, shard_batch)
from tpusr_torch.dist.pp import (make_pp_edsr_apply, make_pp_mesh,
                                 make_pp_train_step, stack_res_params)
from tpusr_torch.dist.spatial import (full_image_esrgan_sr,
                                      make_ring_attention, spatial_sharding)
from tpusr_torch.dist.tp import make_tp_mesh, shard_params_tp, tp_spec

__all__ = ["axis_size", "batch_sharding", "full_image_esrgan_sr",
           "make_mesh", "make_pp_edsr_apply", "make_pp_mesh",
           "make_pp_train_step", "make_ring_attention", "make_tp_mesh",
           "pad_to_multiple", "replicate", "replicated_sharding",
           "shard_batch", "shard_params_tp", "spatial_sharding",
           "stack_res_params", "tp_spec"]

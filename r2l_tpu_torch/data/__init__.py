"""The R2L training data path (ray shards and the batch loader); the
dataset loaders are the modules ``blender``, ``llff`` and ``deepvoxels``."""
from .rayshards import (RayBatchLoader, RayShardDataset, get_pseudo_ratio,
                        shuffle_rays, write_ray_shards)

__all__ = ["RayBatchLoader", "RayShardDataset", "get_pseudo_ratio",
           "shuffle_rays", "write_ray_shards"]

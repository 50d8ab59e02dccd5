from . import voxel_hash, downsample, knn, moments

__all__ = ["voxel_hash", "downsample", "knn", "moments"]

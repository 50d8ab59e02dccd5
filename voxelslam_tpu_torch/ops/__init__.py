from . import voxel_hash, downsample, knn, moments, segment_add

__all__ = ["voxel_hash", "downsample", "knn", "moments", "segment_add"]

"""Window-level pieces of the global BA (port of the single-card part of
`voxelslam_tpu/parallel/`)."""
from . import dist_gba

__all__ = ["dist_gba"]

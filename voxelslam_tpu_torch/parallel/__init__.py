"""Window-level pieces of the global BA and their split over several cards
(port of `voxelslam_tpu/parallel/`)."""
from . import dist_gba, multihost

__all__ = ["dist_gba", "multihost"]

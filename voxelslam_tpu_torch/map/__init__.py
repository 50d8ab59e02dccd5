from . import voxel_map
from .voxel_map import (VoxelLevel, empty_map, insert_scan, refresh_planes,
                        match_points, marginalize, map_stats)

__all__ = ["voxel_map", "VoxelLevel", "empty_map", "insert_scan",
           "refresh_planes", "match_points", "marginalize", "map_stats"]

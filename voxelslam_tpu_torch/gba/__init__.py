"""Hierarchical global BA (port of `voxelslam_tpu/gba/`)."""
from .hba import HbaRunner  # noqa: F401

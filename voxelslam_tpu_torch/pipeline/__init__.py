from . import odometry
from .odometry import SlamPipeline, ScanPose

__all__ = ["odometry", "SlamPipeline", "ScanPose"]

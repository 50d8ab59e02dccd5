from . import odometry
from .odometry import SlamPipeline, ScanPose
from .loop import LoopPipeline, Keyframe, LoopCorrection
from .system import SlamSystem

__all__ = ["odometry", "SlamPipeline", "ScanPose", "LoopPipeline",
           "Keyframe", "LoopCorrection", "SlamSystem"]

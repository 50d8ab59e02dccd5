from . import lidar_factor, optimizers

__all__ = ["lidar_factor", "optimizers"]

from . import ekf, preintegration

__all__ = ["ekf", "preintegration"]

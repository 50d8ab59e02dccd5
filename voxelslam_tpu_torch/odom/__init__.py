from . import iekf

__all__ = ["iekf"]

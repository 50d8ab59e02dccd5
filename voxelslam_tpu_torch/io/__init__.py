from . import simulator

__all__ = ["simulator"]

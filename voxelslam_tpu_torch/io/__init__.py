from . import sessions, simulator

__all__ = ["sessions", "simulator"]

from . import so3, eig3, cluster, state
from .state import NavState, DIM, GRAVITY
from .cluster import Cluster

__all__ = ["so3", "eig3", "cluster", "state", "NavState", "DIM", "GRAVITY",
           "Cluster"]

from .planner import JointSpace, Path, PathSimplifier, PlannerResult, RRTConnect
from .validity import GvlValidityChecker, HierarchicalValidityChecker, MotionValidator

__all__ = [
    "GvlValidityChecker",
    "HierarchicalValidityChecker",
    "JointSpace",
    "MotionValidator",
    "Path",
    "PathSimplifier",
    "PlannerResult",
    "RRTConnect",
]

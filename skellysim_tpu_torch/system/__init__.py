from .sources import BackgroundFlow, PointSources
from .system import SimState, StepInfo, System

__all__ = ["BackgroundFlow", "PointSources", "SimState", "StepInfo", "System"]

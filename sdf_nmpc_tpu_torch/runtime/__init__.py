"""Host runtime: native sensor-frame ingestion and the mission state machine."""

from .mission import MissionMode, MissionServer, MissionTick
from .native import FrameRing

__all__ = ["FrameRing", "MissionMode", "MissionServer", "MissionTick"]

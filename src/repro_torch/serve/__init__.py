"""Session-level serving: the engine that routes sessions to replicas and
re-routes hot ones with the Mixed planner (:mod:`.engine`)."""

from .engine import ServeEngine, ServeReport, Session

__all__ = ["ServeEngine", "ServeReport", "Session"]

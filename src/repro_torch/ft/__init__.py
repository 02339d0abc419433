"""Fault tolerance of the port (mirrors ``repro/ft``): the
checkpoint-restart loop with failure injection, and the straggler
monitor."""
from .failure import InjectedFailure, RestartPolicy, run_with_restarts
from .straggler import StragglerMonitor, StragglerStats

__all__ = ["InjectedFailure", "RestartPolicy", "StragglerMonitor",
           "StragglerStats", "run_with_restarts"]

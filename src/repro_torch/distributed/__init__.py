"""Distributed runtime: for now only the host-side fault-tolerance pieces
(``repro.distributed.fault``) that the trainer uses."""

from .fault import (HeartbeatRegistry, RestartableLoop, SimulatedFailure,
                    StepWatchdog, elastic_plan)

__all__ = ["HeartbeatRegistry", "RestartableLoop", "SimulatedFailure",
           "StepWatchdog", "elastic_plan"]

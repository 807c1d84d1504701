from .faults import FaultInjected, FaultPlan, FaultSpec, activate, maybe_fire
from .guard import (
    Degradation,
    DegradationLog,
    DegradationWarning,
    retry_with_backoff,
)

__all__ = ["FaultInjected", "FaultPlan", "FaultSpec", "activate",
           "maybe_fire",
           "Degradation", "DegradationLog", "DegradationWarning",
           "retry_with_backoff"]

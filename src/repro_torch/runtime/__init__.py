from .fault_tolerance import (
    ElasticController,
    FailureDetector,
    HeartbeatMonitor,
    HostState,
    RestorePlan,
    StragglerDetector,
)
from .faults import FaultInjected, FaultPlan, FaultSpec, activate, maybe_fire
from .guard import (
    Degradation,
    DegradationLog,
    DegradationWarning,
    retry_with_backoff,
)

__all__ = ["ElasticController", "FailureDetector", "HeartbeatMonitor",
           "HostState", "RestorePlan", "StragglerDetector",
           "FaultInjected", "FaultPlan", "FaultSpec", "activate",
           "maybe_fire",
           "Degradation", "DegradationLog", "DegradationWarning",
           "retry_with_backoff"]

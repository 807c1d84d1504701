"""Opara core: the paper's contribution on PyTorch, recorded into CUDA graphs."""
from .graph import IntensityClass, OpCost, OpGraph, OpKind, OpNode
from .profiler import (
    HardwareSpec,
    ModelProfiler,
    OpProfile,
    ProfileTable,
    H100_NVL,
    H100_PCIE,
    H100_SXM,
    V5E,
    apply_profile,
    detach_profile,
    detect_hardware,
)
from .stream_alloc import StreamPlan, allocate_streams, count_syncs
from .nimble import allocate_streams_nimble
from .launch_order import (
    ORDER_POLICIES,
    critical_path_order,
    depth_first_order,
    opara_launch_order,
    resource_only_order,
    topo_order,
)
from .fusion import (
    Wave,
    WaveSchedule,
    build_waves,
    fusion_stats,
    regroup_waves,
    repack_waves,
)
from .simulator import (
    SimConfig,
    SimResult,
    estimate_makespan,
    sequential_makespan,
    simulate,
)
from .capture import (
    CapturedGraph,
    CudaGraphReplay,
    PlanValidationError,
    Step,
    capture,
    run_sequential_uncompiled,
)
from .scheduler import (
    ALLOC_POLICIES,
    RefineConfig,
    SchedulePlan,
    autotune,
    compare_policies,
    compile_plan,
    estimate_plan,
    refine,
    schedule,
    simulate_plan,
)
from .session import (
    CompiledModel,
    Session,
    SessionConfig,
    calibration_key,
    default_session,
    graph_signature,
    reset_default_session,
)
from .api import (
    cache_stats,
    calibrate,
    clear_caches,
    optimize,
    plan,
)

__all__ = [
    "IntensityClass", "OpCost", "OpGraph", "OpKind", "OpNode",
    "HardwareSpec", "ModelProfiler", "OpProfile", "ProfileTable", "V5E",
    "H100_NVL", "H100_PCIE", "H100_SXM",
    "apply_profile", "detach_profile", "detect_hardware",
    "StreamPlan", "allocate_streams", "count_syncs", "allocate_streams_nimble",
    "ORDER_POLICIES", "critical_path_order", "depth_first_order",
    "opara_launch_order", "resource_only_order", "topo_order",
    "Wave", "WaveSchedule", "build_waves", "fusion_stats", "regroup_waves",
    "repack_waves",
    "SimConfig", "SimResult", "estimate_makespan", "sequential_makespan",
    "simulate",
    "CapturedGraph", "CudaGraphReplay", "PlanValidationError", "Step",
    "capture", "run_sequential_uncompiled",
    "ALLOC_POLICIES", "RefineConfig", "SchedulePlan", "autotune",
    "compare_policies", "compile_plan", "estimate_plan", "refine",
    "schedule", "simulate_plan",
    "CompiledModel", "Session", "SessionConfig", "default_session",
    "reset_default_session",
    "cache_stats", "calibrate", "calibration_key", "clear_caches",
    "graph_signature", "optimize", "plan",
]

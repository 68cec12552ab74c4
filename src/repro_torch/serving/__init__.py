from .workload import (Workload, NodeDesc, Segment, LengthDist,
                       wmt_like_length_dist, fixed_length, get_workload,
                       from_model_config, PAPER_WORKLOADS)
from .npu_model import (NPUPerfModel, HardwareSpec, PAPER_NPU, TPU_V5E,
                        H100_SXM)
from .traffic import (Trace, poisson_trace, poisson_mixture, bursty_trace,
                      colocated_trace, with_sla_classes)
from .backend import (Backend, BackendError, BackendOOMError, MemoryStats,
                      MultiBackend, SanitizerStats, ServerLog,
                      TransientBackendError, run_label)
from .registry import ModelEntry, ModelRegistry
from .session import (ServingSession, RequestHandle, HandleState,
                      RetryPolicy, BrownoutConfig, run_trace,
                      run_mixture, DEFAULT_MODEL)
from .server import InferenceServer, SimExecutor, run_policy
from .metrics import ServeStats
from .faults import (FaultSpec, FaultInjectingBackend, parse_fault_spec,
                     parse_fault_specs)
from .engine import TorchEngine

__all__ = [
    "Workload", "NodeDesc", "Segment", "LengthDist", "wmt_like_length_dist",
    "fixed_length", "get_workload", "from_model_config", "PAPER_WORKLOADS",
    "NPUPerfModel", "HardwareSpec", "PAPER_NPU", "TPU_V5E", "H100_SXM",
    "Trace", "poisson_trace", "poisson_mixture", "bursty_trace",
    "colocated_trace", "with_sla_classes",
    "Backend", "BackendError", "BackendOOMError", "TransientBackendError",
    "MemoryStats", "MultiBackend", "SanitizerStats", "ServerLog", "run_label",
    "ModelEntry", "ModelRegistry",
    "ServingSession", "RequestHandle", "HandleState", "RetryPolicy",
    "BrownoutConfig", "run_trace", "run_mixture", "DEFAULT_MODEL",
    "InferenceServer", "SimExecutor", "run_policy", "ServeStats",
    "FaultSpec", "FaultInjectingBackend", "parse_fault_spec",
    "parse_fault_specs", "TorchEngine",
]


def __getattr__(name):
    if name == "Executor":                  # retired alias of Backend
        import warnings
        warnings.warn("Executor is deprecated; use repro_torch.serving.Backend",
                      DeprecationWarning, stacklevel=2)
        return Backend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

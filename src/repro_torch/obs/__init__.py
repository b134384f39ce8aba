from repro_torch.obs.layerwise import LayerwiseHistory
from repro_torch.obs.profiler import StepProfiler, profile
from repro_torch.obs.trace import NULL, Tracer, phase_summary

__all__ = ["LayerwiseHistory", "NULL", "StepProfiler", "Tracer",
           "phase_summary", "profile"]

from repro_torch.obs.trace import NULL, Tracer, phase_summary

__all__ = ["NULL", "Tracer", "phase_summary"]

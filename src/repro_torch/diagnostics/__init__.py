"""repro_torch.diagnostics — sharpness & loss-landscape instrumentation:
the port of ``repro.diagnostics``.

    hvp        Hessian-vector products on the flat (rows, 128) layout
    lanczos    m-step Lanczos: top-k eigenvalues, SLQ stem and density
    sharpness  SAM ε-ball sharpness + gradient-noise-scale estimator
    landscape  filter-normalized 1-D/2-D loss slices
    probes     Probe protocol + Lanczos/Sharpness/GradNoise probes
    sink       MetricsSink streaming (console/JSONL/CSV/multi)

Everything runs microbatch by microbatch at the training step's peak
activation memory and launches none of the port's kernels.
"""
from repro_torch.diagnostics.hvp import (FlatHVP, make_flat_hvp,
                                         padding_mask, scanned_grads,
                                         scanned_loss, tree_hvp)
# NB: the ``lanczos`` *function* stays module-scoped
# (``diagnostics.lanczos.lanczos``) so it doesn't shadow the submodule
from repro_torch.diagnostics.lanczos import (LanczosResult, lanczos_top_k,
                                             slq_spectral_density,
                                             spectral_density,
                                             spectral_density_stem,
                                             top_k_eigenvalues)
from repro_torch.diagnostics.landscape import (direction_between,
                                               filter_normalized_direction,
                                               loss_slice_1d, loss_slice_2d)
from repro_torch.diagnostics.probes import (GradNoiseProbe, LanczosProbe,
                                            Probe, SharpnessProbe,
                                            probe_due, should_run)
from repro_torch.diagnostics.sharpness import (gradient_noise_scale,
                                               sam_sharpness)
from repro_torch.diagnostics.sink import (BufferedSink, ConsoleSink,
                                          CsvSink, JsonlSink, MemorySink,
                                          MetricsSink, MultiSink, NullSink,
                                          export_recorder, validate_jsonl)

__all__ = [
    "BufferedSink", "ConsoleSink", "CsvSink", "FlatHVP",
    "GradNoiseProbe", "JsonlSink",
    "LanczosProbe", "LanczosResult", "MemorySink", "MetricsSink",
    "MultiSink",
    "NullSink", "Probe", "SharpnessProbe", "direction_between",
    "export_recorder", "filter_normalized_direction",
    "gradient_noise_scale", "lanczos_top_k", "loss_slice_1d",
    "loss_slice_2d", "make_flat_hvp", "padding_mask", "probe_due",
    "sam_sharpness",
    "scanned_grads", "scanned_loss", "should_run",
    "slq_spectral_density", "spectral_density", "spectral_density_stem",
    "top_k_eigenvalues", "tree_hvp", "validate_jsonl",
]

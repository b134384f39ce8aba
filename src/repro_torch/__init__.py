"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Module names mirror ``src/repro/`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only, never ``jax`` and nothing
of ``repro``; the JAX package stays the reference that the tests hold
this one against.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking
for CUDA on a host without it raises instead of running on the CPU
(see :func:`repro_torch.device.resolve`). Kernels dispatch by the
tensors' device: a CUDA tensor launches the hand-written Hopper kernel,
a CPU tensor runs its plain PyTorch version.
"""

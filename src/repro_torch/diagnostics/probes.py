"""The ``Probe`` protocol and the sharpness/curvature probes: the port of
``repro.diagnostics.probes``.

A probe is any object with a ``name``, an ``every`` (run at steps
where ``step % every == 0``) and ``__call__(step, state) -> {metric:
float}``. The trainer's ``fit(..., options=FitOptions(callbacks=[...],
sink=...))`` runs due probes after the optimizer step and streams
their results (keys prefixed ``{name}/``) through the metrics sink
beside the per-step training metrics.

Every concrete probe splits ``__call__`` into ``dispatch(step, state)``
— enqueue the computation on the params' device and return its device
tensors, with nothing read back — and ``resolve(raw) -> {metric:
float}``, the host-side read-back. ``__call__`` is
``resolve(dispatch(step, state))``.

Scheduling: probes with a dynamic cadence expose ``due(step) ->
bool``; :func:`probe_due` is the one scheduling predicate the trainer
uses — it consults ``due`` when present and falls back to the static
``step % every == 0`` rule.

Probes are separate computations over a held probe batch: they read
the params and never write them (nor the optimizer state), and they
launch none of the port's kernels (``kernels.ops.launches`` does not
move). With a stacked ``[K, B/K, ...]`` probe batch every probe runs
microbatch by microbatch, as training does.

* :class:`LanczosProbe`  — top-k Hessian eigenvalues (λ_max first)
  via flat-layout HVPs + m-step Lanczos;
* :class:`SharpnessProbe` — SAM ε-ball sharpness;
* :class:`GradNoiseProbe` — McCandlish simple gradient noise scale.

Each takes ``mesh=`` / ``data_axes=`` (the data-parallel path of
``hvp`` and ``sharpness``): every rank calls the probe with the same
held batch, computes on its shard and holds the averaged result; the
random draws (the Lanczos seed) come from generators seeded alike on
every rank, so they are the same everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import flatten
from repro_torch.core.base import tree_leaves
from repro_torch.diagnostics import hvp, sharpness
from repro_torch.diagnostics.lanczos import (BlockInner, LanczosResult,
                                             lanczos, top_k_eigenvalues)

PyTree = Any


@runtime_checkable
class Probe(Protocol):
    name: str
    every: int

    def __call__(self, step: int, state) -> dict[str, float]:
        ...


def should_run(step: int, every: int) -> bool:
    """The probe schedule: every N steps, starting at step 0."""
    return every > 0 and step % every == 0


def probe_due(probe, step: int) -> bool:
    """The scheduling predicate for probes/callbacks: a probe with a
    ``due(step)`` method (adaptive cadence) decides itself; otherwise
    the static ``step % every == 0`` rule applies."""
    due = getattr(probe, "due", None)
    if callable(due):
        return bool(due(step))
    return should_run(step, getattr(probe, "every", 1))


def _host_floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """0-d device tensors -> floats, in one read-back."""
    values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def seed_vector(spec: flatten.FlatSpec, seed: int, device) -> torch.Tensor:
    """A Lanczos seed: ``padding_mask · N(0, 1)`` drawn from a generator
    seeded ``seed`` on ``device`` (not the JAX PRNG's samples)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    v0 = torch.randn((spec.num_rows, flatten.LANES), generator=gen,
                     dtype=torch.float32, device=device)
    return v0.mul_(hvp.padding_mask(spec, device))


def placed_seed_vector(spec: flatten.FlatSpec, params: PyTree, task,
                       place, seed: int, device) -> torch.Tensor:
    """This rank's blocks of the Lanczos seed the whole params would get
    (:func:`seed_vector` over the whole tree's flat layout, drawn whole,
    each leaf's block under ``place`` kept), in ``spec``, the flat
    layout of this rank's blocks: a GSPMD probe starts from the
    single-rank probe's vector, so its early Ritz values are the
    single-rank ones (they depend on the seed)."""
    from repro_torch.core.base import (tree_flatten_with_path,
                                       tree_from_paths, tree_get)
    pairs = list(tree_flatten_with_path(params))
    whole = tree_from_paths(params, {
        p: torch.empty(place.whole[p], dtype=x.dtype, device="meta")
        for p, x in pairs})
    wspec = hvp.build_spec(task, whole)
    views = flatten.unpack(seed_vector(wspec, seed, device), wspec, whole)
    return flatten.pack(tree_from_paths(params, {
        p: place.block(p, tree_get(views, p)) for p, _ in pairs}), spec)


@dataclasses.dataclass
class LanczosProbe:
    """Top-k Hessian eigenvalues of the task loss on a held batch.

    Emits ``{"lambda_max": λ₁, "eig_2": λ₂, ...}``. The HVP runs on the
    flat ``(rows, 128)`` layout; the Lanczos seed is a fixed-seed
    Gaussian projected off the padding coordinates, so trajectories
    across steps are comparable (same Krylov seed every probe).
    ``reorth=False`` keeps no Krylov basis on the device and holds the
    previous Lanczos vector in host memory, what a full-size model
    needs (``lanczos.lanczos``). ``placement=`` (the GSPMD step's
    ``launch.sharding.Placement``, the state holding this rank's
    blocks): every rank of the placement's mesh calls the probe with
    the global held batch; the products are the global batch's
    (``hvp.make_flat_hvp(placement=)``), the vectors this rank's blocks
    of the single-rank ones (:func:`placed_seed_vector`) and the inner
    products summed over the mesh (``lanczos.BlockInner``).
    """
    task: Any
    batch: PyTree
    every: int = 10
    num_iters: int = 16
    top_k: int = 1
    accum_steps: int = 1
    reorth: bool = True
    seed: int = 0
    mesh: Any = None
    data_axes: Any = None
    placement: Any = None
    name: str = "lanczos"

    def __post_init__(self):
        if not 1 <= self.top_k <= self.num_iters:
            raise ValueError(f"top_k={self.top_k} must be in "
                             f"[1, num_iters={self.num_iters}]")
        hvp.check_stacked(self.batch, self.accum_steps)

    def dispatch(self, step: int, state) -> LanczosResult:
        """Run Lanczos on the device; returns the device ``(alphas,
        betas)`` without reading them back."""
        place = self.placement
        op = hvp.make_flat_hvp(self.task, state.params, self.batch,
                               accum_steps=self.accum_steps,
                               mesh=self.mesh, data_axes=self.data_axes,
                               placement=place)
        device = tree_leaves(state.params)[0].device
        # the seed is handed over, not kept: Lanczos frees it once it
        # has its normalized copy, so without reorthogonalization the
        # device holds one flat f32 vector during each matvec
        if place is None:
            return lanczos(op.matvec, seed_vector(op.spec, self.seed,
                                                  device),
                           self.num_iters, reorth=self.reorth)
        return lanczos(op.matvec, placed_seed_vector(
            op.spec, state.params, self.task, place, self.seed, device),
            self.num_iters, reorth=self.reorth,
            inner=BlockInner(op.spec, place))

    def resolve(self, raw: LanczosResult) -> dict[str, float]:
        """Host eigenvalues of the tridiagonal (reads the device back)."""
        evals = top_k_eigenvalues(raw.alphas, raw.betas, self.top_k)
        out = {"lambda_max": float(evals[0])}
        for j in range(1, self.top_k):
            out[f"eig_{j + 1}"] = float(evals[j])
        return out

    def __call__(self, step: int, state) -> dict[str, float]:
        return self.resolve(self.dispatch(step, state))


@dataclasses.dataclass
class SharpnessProbe:
    """SAM ε-ball sharpness of the task loss on a held batch."""
    task: Any
    batch: PyTree
    every: int = 10
    rho: float = 0.05
    accum_steps: int = 1
    mesh: Any = None
    data_axes: Any = None
    name: str = "sharpness"

    def dispatch(self, step: int, state) -> dict[str, torch.Tensor]:
        return sharpness.sam_sharpness(self.task, state.params, self.batch,
                                       rho=self.rho,
                                       accum_steps=self.accum_steps,
                                       mesh=self.mesh,
                                       data_axes=self.data_axes)

    def resolve(self, raw) -> dict[str, float]:
        return _host_floats(raw)

    def __call__(self, step: int, state) -> dict[str, float]:
        return self.resolve(self.dispatch(step, state))


@dataclasses.dataclass
class GradNoiseProbe:
    """Simple gradient noise scale from the stacked probe batch's
    per-microbatch gradients. Needs two batch sizes to contrast:
    ``accum_steps >= 2`` on one device, or ``mesh=`` with a data width
    >= 2 (the per-rank gradients are the small-batch samples, at any
    ``accum_steps``)."""
    task: Any
    batch: PyTree
    accum_steps: int
    every: int = 10
    mesh: Any = None
    data_axes: Any = None
    name: str = "gns"

    def __post_init__(self):
        dp = hvp.mesh_dp_size(self.mesh, self.data_axes)
        if self.accum_steps * dp < 2:
            raise ValueError(
                "GradNoiseProbe needs accum_steps >= 2 (stacked "
                "microbatches) or a mesh with data width >= 2; got "
                f"accum_steps={self.accum_steps}, data_parallel={dp}")

    def dispatch(self, step: int, state) -> dict[str, torch.Tensor]:
        return sharpness.gradient_noise_scale(
            self.task, state.params, self.batch,
            accum_steps=self.accum_steps, mesh=self.mesh,
            data_axes=self.data_axes)

    def resolve(self, raw) -> dict[str, float]:
        return _host_floats(raw)

    def __call__(self, step: int, state) -> dict[str, float]:
        return self.resolve(self.dispatch(step, state))

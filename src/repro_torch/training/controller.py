"""Noise-scale-driven adaptive batch-size controller: the port of
``repro.training.controller``.

McCandlish et al.'s simple gradient noise scale ``B_noise =
tr(Σ)/‖G‖²`` estimates the batch size where a larger batch stops
paying. A :class:`~repro_torch.diagnostics.probes.GradNoiseProbe` on a
held batch measures it every ``config.every`` steps; the controller
smooths it, snaps it to a representable global batch and retargets the
run, which reproduces the McCandlish schedule: small batches early,
large ones late.

The knobs are the data-parallel width D (how many ranks the
microbatch spreads over, at most ``config.data_max``) and the
accumulation depth K, at a fixed per-rank microbatch: ``global batch =
D × K × microbatch``. The snap policy fills the data axis first.
Changing K only changes how many microbatches a step sums and changing
D how many shards are averaged, so the peak memory per rank (one
microbatch of activations and one f32 gradient accumulator) does not
move, and under ``use_kernel="fused"`` every step is one norm and one
apply launch per rank at every (D, K).

The world holds ``data_max`` ranks, each running the same controller on
the same readings. A step at D < ``data_max`` runs on the mesh of the
first D ranks (``mesh_for``, ``distributed.make_data_mesh``); the ranks
past D compute a shard too, but add ``-0.0`` to the average in its
place (``Mesh.mean_``), so every rank ends the step with the same bits
as a world of D ranks would. At D = 1 over a world of several ranks the
single-device step runs and rank 0's gradients are handed to the
others. Every decision uses rank 0's reading and rank 0's clock
(broadcast at each boundary), so the ranks switch together.

LR co-scaling: each visited K builds its own train step around an
optimizer made by ``optimizer_factory(global_batch)``, so the LR (and
TVLARS's γ_min) follow the batch the step trains at; the stateful
``schedules.batch_scaled_lr(batch_size_fn=)`` reports the LR in effect
(``controller.lr``, the ``controller/lr`` metric). The optimizer state
depends only on the params, so it carries across switches. Steps are
built once per visited K and cached (``compiles`` counts the steps
built).

The controller is itself a probe (``name="controller"``, due every
``config.every`` steps, or by the adaptive cadence), so
``trainer.fit(options=FitOptions(controller=...))`` streams its
decisions through the metrics sink as ``controller/*``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import schedules
from repro_torch.core.base import GradientTransform
from repro_torch.diagnostics.probes import should_run
from repro_torch import distributed

SNAP_MODES = ("pow2", "linear")
CADENCE_MODES = ("static", "adaptive")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Decision-rule knobs for :class:`AdaptiveBatchController`.

    ``microbatch``   fixed per-device pass batch; global = D·K·microbatch.
    ``batch_min/max``  global-batch clamp (inclusive), multiples of the
                     microbatch.
    ``every``        decision cadence in steps; under
                     ``cadence="adaptive"`` the ceiling of the interval.
    ``cadence``      "static" (a boundary every ``every`` steps) or
                     "adaptive": the interval halves (down to
                     ``min_every`` or the cost floor) while the smoothed
                     noise scale moves more than ``drift_threshold``
                     relatively between boundaries, and doubles back up
                     to ``every`` when it is stable; the cost floor keeps
                     probe time under ``probe_budget`` of train time.
    ``min_every``    adaptive floor on the interval (>= 1).
    ``drift_threshold``  relative change of the smoothed noise scale
                     between boundaries counted as drift.
    ``probe_budget`` ceiling on probe seconds per train second, in (0, 1].
    ``deadband``     a candidate batch within ``±deadband × current`` is
                     ignored (no switch, no step built).
    ``ema``          smoothing weight on the previous estimate (0 = take
                     each reading as it is).
    ``snap``         "pow2" snaps K to powers of two; "linear" allows any
                     integer K.
    ``data_max``     maximum data-parallel width D (a power of two; 1 =
                     the K-only controller); the world holds this many
                     ranks.
    """
    microbatch: int
    batch_min: int
    batch_max: int
    every: int = 10
    deadband: float = 0.25
    ema: float = 0.5
    snap: str = "pow2"
    data_max: int = 1
    cadence: str = "static"
    min_every: int = 1
    drift_threshold: float = 0.25
    probe_budget: float = 0.1

    def __post_init__(self):
        if self.cadence not in CADENCE_MODES:
            raise ValueError(
                f"cadence={self.cadence!r}; one of {CADENCE_MODES}")
        if not 1 <= self.min_every <= self.every:
            raise ValueError(
                f"min_every={self.min_every} must be in "
                f"[1, every={self.every}]")
        if self.drift_threshold < 0.0:
            raise ValueError(f"drift_threshold must be >= 0, "
                             f"got {self.drift_threshold}")
        if not 0.0 < self.probe_budget <= 1.0:
            raise ValueError(f"probe_budget must be in (0, 1], "
                             f"got {self.probe_budget}")
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, "
                             f"got {self.microbatch}")
        if self.batch_min < self.microbatch:
            raise ValueError(
                f"batch_min={self.batch_min} must be >= microbatch="
                f"{self.microbatch} (K >= 1)")
        if self.batch_max < self.batch_min:
            raise ValueError(f"batch_max={self.batch_max} < batch_min="
                             f"{self.batch_min}")
        if self.batch_min % self.microbatch or \
                self.batch_max % self.microbatch:
            raise ValueError(
                f"batch_min/batch_max ({self.batch_min}/{self.batch_max}) "
                f"must be multiples of microbatch={self.microbatch}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")
        if self.deadband < 0.0:
            raise ValueError(f"deadband must be >= 0, "
                             f"got {self.deadband}")
        if self.snap not in SNAP_MODES:
            raise ValueError(f"snap={self.snap!r}; one of {SNAP_MODES}")
        if self.data_max < 1 or self.data_max & (self.data_max - 1):
            raise ValueError(
                f"data_max={self.data_max} must be a power of two >= 1 "
                f"(mesh data widths are)")

    @property
    def k_min(self) -> int:
        return self.batch_min // self.microbatch

    @property
    def k_max(self) -> int:
        return self.batch_max // self.microbatch


def snap_accum_steps(target_batch: float, cfg: ControllerConfig) -> int:
    """A target global batch as a representable K in [k_min, k_max] at
    D = 1: the nearest ``snap`` point of ``K × microbatch``."""
    k = max(float(target_batch) / cfg.microbatch, 1e-9)
    if cfg.snap == "pow2":
        k = 2.0 ** round(math.log2(k))
    return int(min(max(round(k), cfg.k_min), cfg.k_max))


def snap_targets(target_batch: float,
                 cfg: ControllerConfig) -> tuple[int, int]:
    """A target global batch as representable ``(D, K)``: D takes the
    largest power of two the target covers (at most ``data_max``, never
    past ``batch_max``), K the rest under the ``snap`` and clamp rules;
    at D = 1 this is :func:`snap_accum_steps`."""
    f = max(float(target_batch) / cfg.microbatch, 1e-9)

    def k_bounds(d: int) -> tuple[int, int]:
        per = d * cfg.microbatch
        return max(1, -(-cfg.batch_min // per)), cfg.batch_max // per

    d = 1
    if cfg.data_max > 1 and f > 1.0:
        d = 2 ** int(math.floor(math.log2(min(f, cfg.data_max))))
        # shrink D until some K has batch_min <= D·K·mb <= batch_max
        while d > 1 and k_bounds(d)[0] * d * cfg.microbatch \
                > cfg.batch_max:
            d //= 2
    k_lo, k_hi = k_bounds(d)
    k = max(f / d, 1e-9)
    if cfg.snap == "pow2":
        k = 2.0 ** round(math.log2(k))
    k = int(min(max(round(k), k_lo), k_hi))
    return d, k


def decide_targets(b_noise: float, current_batch: int,
                   cfg: ControllerConfig) -> Optional[tuple[int, int]]:
    """The B_noise → (D, K) rule: target the noise scale, snap it, and
    hold (``None``) when the candidate is the current batch or within
    the relative deadband of it. A non-finite or non-positive B_noise
    always holds."""
    if not math.isfinite(b_noise) or b_noise <= 0.0:
        return None
    d, k = snap_targets(b_noise, cfg)
    candidate = d * k * cfg.microbatch
    if candidate == current_batch:
        return None
    if abs(candidate - current_batch) <= cfg.deadband * current_batch:
        return None
    return d, k


def decide_global_batch(b_noise: float, current_batch: int,
                        cfg: ControllerConfig) -> int:
    """The decided global batch as one int (``current_batch`` when the
    rule holds)."""
    decided = decide_targets(b_noise, current_batch, cfg)
    if decided is None:
        return current_batch
    d, k = decided
    return d * k * cfg.microbatch


class AdaptiveBatchController:
    """Closed-loop batch-size controller: B_noise probe → (D, K)
    retarget → LR re-scale, as a ``fit`` callback (see the module
    docstring).

    ``make_step``: ``(optimizer, accum_steps) -> train_step`` when
    ``config.data_max == 1``; ``(optimizer, accum_steps, mesh) ->
    train_step`` when ``data_max > 1``, ``mesh`` from :meth:`mesh_for`
    (``None`` at D = 1 in a world of one rank; pass it to
    ``trainer.make_train_step(mesh=...)``).
    ``optimizer_factory``: ``(global_batch) -> GradientTransform``; must
    scale the LR from the batch and keep a state that does not depend
    on it. ``noise_probe``: ``(step, state) -> {"grad_noise_scale":
    float, ...}``, with optional ``dispatch`` / ``resolve`` for
    ``probe_lead > 0`` (launch the probe that many steps before its
    boundary, read it back at the boundary). ``init_batch`` defaults to
    ``config.batch_min``. ``lr_fn`` reports the LR of the current
    batch; by default the stateful ``schedules.batch_scaled_lr(base_lr,
    base_batch_size=..., rule=scaling_rule, batch_size_fn=<current
    batch>)``. ``init_data_parallel`` is the starting D: ``None`` fills
    the data axis from step 0 (the widest power of two ≤ ``data_max``
    that keeps ``init_batch`` exactly representable). ``mesh_factory``:
    ``(d) -> Mesh`` (default ``distributed.make_data_mesh``); meshes are
    cached per D.
    """

    name = "controller"

    def __init__(self, make_step: Callable[..., Any],
                 optimizer_factory: Callable[[int], GradientTransform],
                 noise_probe: Callable[[int, Any], dict],
                 config: ControllerConfig, *,
                 init_batch: Optional[int] = None,
                 init_data_parallel: Optional[int] = None,
                 mesh_factory: Optional[Callable[[int], Any]] = None,
                 base_lr: float = 1.0, base_batch_size: int = 256,
                 scaling_rule: str = "sqrt",
                 lr_fn: Optional[Callable[[], float]] = None,
                 probe_lead: int = 0):
        if probe_lead < 0:
            raise ValueError(f"probe_lead must be >= 0, got {probe_lead}")
        self.config = config
        self.every = config.every
        self._make_step = make_step
        self._optimizer_factory = optimizer_factory
        self.noise_probe = noise_probe
        self.probe_lead = int(probe_lead)
        self._pending: Optional[tuple[int, Any, float]] = None
        # adaptive cadence: the interval, the next boundary, the last
        # boundary's (step, time) and the smoothed probe seconds
        self._interval = config.every
        self._next_due = 0
        self._last_boundary: Optional[tuple[int, float]] = None
        self._probe_seconds: Optional[float] = None
        # default: the first d ranks, so per-D meshes share ranks
        self._mesh_factory = mesh_factory or distributed.make_data_mesh
        init_batch = config.batch_min if init_batch is None else init_batch
        if init_data_parallel is None:
            # fill the data axis from step 0: the widest power-of-two D
            # that keeps init_batch exactly representable
            init_data_parallel = 1
            if init_batch % config.microbatch == 0:
                f = init_batch // config.microbatch
                while init_data_parallel * 2 <= config.data_max \
                        and f % (init_data_parallel * 2) == 0:
                    init_data_parallel *= 2
        if init_data_parallel < 1 or \
                init_data_parallel > config.data_max:
            raise ValueError(
                f"init_data_parallel={init_data_parallel} outside "
                f"[1, data_max={config.data_max}]")
        per_pull = init_data_parallel * config.microbatch
        if init_batch % per_pull:
            raise ValueError(
                f"init_batch={init_batch} must be a multiple of "
                f"init_data_parallel*microbatch={per_pull}")
        if not config.batch_min <= init_batch <= config.batch_max:
            raise ValueError(
                f"init_batch={init_batch} outside "
                f"[{config.batch_min}, {config.batch_max}]")
        self._dp = int(init_data_parallel)
        self._k = int(init_batch // per_pull)
        self._lr_fn = lr_fn if lr_fn is not None else \
            schedules.batch_scaled_lr(
                base_lr, base_batch_size=base_batch_size,
                rule=scaling_rule,
                batch_size_fn=lambda: self.global_batch)
        self._b_ema: Optional[float] = None
        self._optimizers: dict[int, GradientTransform] = {}
        self._meshes: dict[int, Any] = {}
        self._raw_steps: dict[tuple[int, int], Any] = {}
        self._run_steps: set = set()
        self._streams: list = []
        self.compiles = 0
        self.switches = 0

    # ------------------------------------------------------------ state
    @property
    def global_batch(self) -> int:
        return self._dp * self._k * self.config.microbatch

    @property
    def accum_steps(self) -> int:
        return self._k

    @property
    def data_parallel(self) -> int:
        return self._dp

    @property
    def targets(self) -> tuple[int, int]:
        return self._dp, self._k

    @property
    def lr(self) -> float:
        return float(self._lr_fn())

    @property
    def visited_ks(self) -> tuple[int, ...]:
        return tuple(sorted({k for _, k in self._raw_steps}))

    @property
    def visited_targets(self) -> tuple[tuple[int, int], ...]:
        return tuple(sorted(self._raw_steps))

    def mesh_for(self, data_parallel: Optional[int] = None):
        """The (cached) mesh for a data width: ``None`` for D = 1 in a
        world of one rank, else ``mesh_factory(d)`` over the world."""
        d = self._dp if data_parallel is None else data_parallel
        if d not in self._meshes:
            alone = distributed.world().size == 1
            self._meshes[d] = None if d == 1 and alone \
                else self._mesh_factory(d)
        return self._meshes[d]

    def optimizer(self, global_batch: Optional[int] = None
                  ) -> GradientTransform:
        """The (cached) optimizer for ``global_batch``: build the initial
        ``TrainState`` with ``controller.optimizer()`` so step 0 trains
        at the starting batch."""
        b = self.global_batch if global_batch is None else global_batch
        if b not in self._optimizers:
            self._optimizers[b] = self._optimizer_factory(b)
        return self._optimizers[b]

    def _key(self, accum_steps: Optional[int],
             data_parallel: Optional[int]) -> tuple[int, int]:
        return (self._dp if data_parallel is None else data_parallel,
                self._k if accum_steps is None else accum_steps)

    def raw_step(self, accum_steps: Optional[int] = None,
                 data_parallel: Optional[int] = None):
        """The step for (D, K) (cached), built by ``make_step``."""
        d, k = self._key(accum_steps, data_parallel)
        if (d, k) not in self._raw_steps:
            opt = self.optimizer(d * k * self.config.microbatch)
            if self.config.data_max > 1:
                step = self._make_step(opt, k, self.mesh_for(d))
            else:
                step = self._make_step(opt, k)
            self._raw_steps[(d, k)] = step
        return self._raw_steps[(d, k)]

    def step_fn(self, accum_steps: Optional[int] = None,
                data_parallel: Optional[int] = None):
        """The train step for (D, K) (default: the current pair), built on
        the first visit (``compiles`` counts them) and cached; a revisit
        is a lookup. It takes the global batch the stream yields; each
        rank computes its shard (``pipeline.shard_batch``)."""
        key = self._key(accum_steps, data_parallel)
        if key not in self._run_steps:
            self._run_steps.add(key)
            self.compiles += 1
        return self.raw_step(key[1], key[0])

    def attach(self, stream) -> None:
        """Register a stream to retarget on (D, K) switches (anything with
        ``set_accum_steps`` and a matching ``microbatch``, plus
        ``set_data_parallel`` when ``data_max > 1``);
        ``fit(controller=...)`` attaches its batch stream."""
        if not hasattr(stream, "set_accum_steps"):
            raise TypeError(
                f"controller stream must expose set_accum_steps(k) "
                f"(e.g. data.pipeline.MicrobatchedStream); got "
                f"{type(stream).__name__}")
        if self.config.data_max > 1 and \
                not hasattr(stream, "set_data_parallel"):
            raise TypeError(
                f"data_max={self.config.data_max} > 1 needs a stream "
                f"with set_data_parallel(d) (e.g. "
                f"data.pipeline.MicrobatchedStream); got "
                f"{type(stream).__name__}")
        if stream.microbatch != self.config.microbatch:
            raise ValueError(
                f"stream microbatch {stream.microbatch} != controller "
                f"microbatch {self.config.microbatch}")
        if stream not in self._streams:
            self._streams.append(stream)
        self._sync_stream(stream)

    def _sync_stream(self, stream) -> None:
        stream.set_accum_steps(self._k)
        if hasattr(stream, "set_data_parallel"):
            stream.set_data_parallel(self._dp)

    # ------------------------------------------------------- scheduling
    @property
    def probe_interval(self) -> int:
        """Steps between boundaries (``every`` under static cadence)."""
        return self._interval if self.config.cadence == "adaptive" \
            else self.every

    def due(self, step: int) -> bool:
        """The boundary schedule ``fit`` consults (``probes.probe_due``)."""
        if self.config.cadence == "static":
            return should_run(step, self.every)
        return step >= self._next_due

    def _boundary_after(self, step: int) -> int:
        if self.config.cadence == "static":
            return (step // self.every + 1) * self.every
        return max(self._next_due, step + 1)

    def prepare(self, step: int, state) -> None:
        """Per-step hook (``fit`` calls it every step, before
        ``probe_due``): with ``probe_lead > 0`` and a probe that has
        ``dispatch``, launch the noise probe ``probe_lead`` steps ahead
        of the next boundary. Its outputs are fresh tensors, enqueued
        before the next step's in-place update."""
        if self.probe_lead <= 0 or self._pending is not None:
            return
        if not hasattr(self.noise_probe, "dispatch"):
            return
        if self.due(step):
            return
        if step + self.probe_lead >= self._boundary_after(step):
            self._pending = (step, self.noise_probe.dispatch(step, state),
                             time.perf_counter())

    def _rank0(self, *values: float) -> tuple:
        """``values`` as rank 0 has them, on every rank of a world of
        several (one broadcast), so that every rank decides alike."""
        if distributed.world().size == 1:
            return values
        mesh = self.mesh_for(self.config.data_max)
        t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
        mesh.broadcast_([t])
        return tuple(t.tolist())

    def _measure(self, step: int, state) -> tuple[float, float]:
        """(B_noise, probe seconds) at a boundary: resolve the probe
        dispatched ahead (reading it back waits for the card) or run it
        now."""
        t0 = time.perf_counter()
        if self._pending is not None:
            _, raw, t_disp = self._pending
            self._pending = None
            out = self.noise_probe.resolve(raw)
            seconds = time.perf_counter() - t_disp
        else:
            out = self.noise_probe(step, state)
            seconds = time.perf_counter() - t0
        return float(out["grad_noise_scale"]), seconds

    def _update_cadence(self, step: int, prev_ema: Optional[float],
                        probe_seconds: float) -> None:
        """Adaptive interval: halve while the smoothed noise scale
        drifts, double back towards ``every`` when stable, never below
        the cost floor (no-op under static cadence)."""
        cfg = self.config
        self._probe_seconds = probe_seconds \
            if self._probe_seconds is None \
            else 0.5 * self._probe_seconds + 0.5 * probe_seconds
        if cfg.cadence != "adaptive":
            return
        now, = self._rank0(time.perf_counter())
        floor = cfg.min_every
        if self._last_boundary is not None:
            lb_step, lb_t = self._last_boundary
            per_step = (now - lb_t) / max(step - lb_step, 1)
            if per_step > 0.0 and self._probe_seconds is not None:
                floor = max(floor, math.ceil(
                    self._probe_seconds / (cfg.probe_budget * per_step)))
        self._last_boundary = (step, now)
        drifting = True       # the first boundary has nothing to compare
        if prev_ema is not None and self._b_ema is not None:
            drifting = abs(self._b_ema - prev_ema) \
                > cfg.drift_threshold * abs(prev_ema)
        if drifting:
            self._interval = max(self._interval // 2, 1)
        else:
            self._interval = self._interval * 2
        self._interval = int(min(max(self._interval, floor), cfg.every))
        self._next_due = step + self._interval

    # -------------------------------------------------------- decisions
    def retarget(self, global_batch: int,
                 data_parallel: Optional[int] = None) -> bool:
        """Set the global batch directly (the decision's apply path, and
        scripted schedules); ``data_parallel=None`` keeps the current D.
        Returns True if (D, K) changed; takes effect at the next
        ``next(stream)`` / ``step_fn()``."""
        cfg = self.config
        d = self._dp if data_parallel is None else int(data_parallel)
        if d < 1 or d > cfg.data_max:
            raise ValueError(
                f"data_parallel={d} outside [1, data_max={cfg.data_max}]")
        if global_batch % (d * cfg.microbatch):
            raise ValueError(
                f"global_batch={global_batch} not a multiple of "
                f"data_parallel*microbatch={d * cfg.microbatch}")
        if not cfg.batch_min <= global_batch <= cfg.batch_max:
            raise ValueError(
                f"global_batch={global_batch} outside "
                f"[{cfg.batch_min}, {cfg.batch_max}]")
        k = global_batch // (d * cfg.microbatch)
        if (d, k) == (self._dp, self._k):
            return False
        self._dp, self._k = d, k
        self.switches += 1
        for stream in self._streams:
            self._sync_stream(stream)
        return True

    def __call__(self, step: int, state) -> dict[str, float]:
        """A boundary: measure B_noise, decide, apply; returns the
        ``controller/*`` metrics for the sink."""
        prev_ema = self._b_ema
        measured, probe_seconds = self._rank0(*self._measure(step, state))
        # an invalid reading (a noise-dominated ‖G‖² estimate) carries no
        # information: it stays out of the EMA and the controller holds
        valid = math.isfinite(measured) and measured > 0.0
        if valid:
            self._b_ema = measured if self._b_ema is None else \
                self.config.ema * self._b_ema \
                + (1.0 - self.config.ema) * measured
        smoothed = self._b_ema if self._b_ema is not None else measured
        decided = decide_targets(smoothed, self.global_batch,
                                 self.config) if valid else None
        if decided is None:
            cached = (self._dp, self._k) in self._run_steps
            changed = False
        else:
            d, k = decided
            cached = (d, k) in self._run_steps
            changed = self.retarget(d * k * self.config.microbatch,
                                    data_parallel=d)
        self._update_cadence(step, prev_ema, probe_seconds)
        return {"b_noise": measured, "b_noise_ema": smoothed,
                "global_batch": float(self.global_batch),
                "accum_steps": float(self._k),
                "data_parallel": float(self._dp),
                "lr": self.lr, "changed": float(changed),
                "step_cached": float(cached),
                "probe_interval": float(self.probe_interval),
                "probe_seconds": float(probe_seconds)}

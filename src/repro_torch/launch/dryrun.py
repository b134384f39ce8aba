"""Dry run: trace every (arch × input shape × mesh) of the reference's
production meshes on the ``meta`` device, one rank, without allocating.

The port of ``repro.launch.dryrun`` and the purpose of
``repro.launch.hlo_analysis``: a pre-flight check of shapes, memory,
FLOPs and collective bytes under the port's own rules
(``launch.sharding``), before a card is asked for. It runs on ``meta``
whatever the host has: no tensor holds data, no card is needed and
nothing is allocated, so a 72B model's train step on a (16, 16) mesh
traces in seconds on a laptop.

Per combination it builds the step a rank of the mesh would run
(:func:`build_step`: the train step for ``train_4k``, the forward's
last-position logits for ``prefill_32k``, one serve step for the
decode shapes), with the reference's shardings, and runs it once on
meta tensors of the rank's blocks, recording:

* ``argument_bytes``: the rank's blocks of the state (params and
  optimizer state, ``state_pspecs(fsdp=True)``) or params and cache,
  and of the batch;
* ``peak_bytes``: the argument bytes plus the peak of the bytes held by
  the tensors the step creates (:class:`LiveBytes`, a dispatch mode
  that follows every storage to its release): the card's
  ``max_memory_allocated`` for the same step, but for the allocator's
  rounding and the kernels' own work buffers;
* ``flops``: matmul FLOPs (``torch.utils.flop_counter.FlopCounterMode``;
  a product counts 2·M·N·K, the backward's products included), and the
  decode kernels' own (``kernels.ops.meta_flops``);
* ``collectives``: per name, the count and bytes of every collective a
  rank makes (:class:`DryMesh` writes the records a real run writes to
  ``Mesh.collectives``);
* ``launches``: the Hopper kernels' launches the step stands for
  (``kernels.ops.meta_launches``);
* the status, ``ok`` or ``skipped`` with ``supports_shape``'s reason,
  and the seconds taken.

The reference needs ``hlo_analysis`` because XLA's cost analysis counts
a while loop's body once (a scan over layers); tracing eagerly runs
every layer, recomputation and microbatch as the card would, so each
op is counted as often as it runs and the weighting is inherent. The
reference's ``cpu_upcast_f32_bytes`` terms are an artefact of XLA's CPU
backend (bf16 dot operands upcast to f32 buffers) and have no
counterpart here.

The meshes are the reference's (``repro.launch.mesh``): ``single`` is
(16, 16) over (data, model); ``multi`` is (2, 16, 16) over (pod, data,
model), traced as a data axis of 32: ``launch.sharding`` gives the data
axes ``("pod", "data")`` jointly, and one axis of 32 cuts every leaf
and batch into the same blocks (``tests/test_torch_dryrun.py`` holds
that leaf by leaf). Sequence parallelism is on for the full-sequence
kinds where the model axis divides the sequence, as in the reference.

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh single
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time
import traceback
import weakref
from typing import Any, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch import distributed as dist_lib
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 input_specs, supports_shape)
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import ops
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L
from repro_torch.serving.decode import make_serve_step
from repro_torch.training import TrainState, make_train_step

META = torch.device("meta")
# the reference's production meshes as (data, model): multi's pod and
# data axes traced as one data axis
MESHES = {"single": (16, 16), "multi": (32, 16)}
SAVE_DIR = "experiments/dryrun_torch"


class DryMesh(dist_lib.Mesh):
    """A ``(data, model)`` mesh standing in for rank ``rank`` of a world
    that is not joined: its coordinates, groups and collectives are a
    real mesh's, but every call to the backend does nothing (the
    tensors are meta tensors of the shapes a real collective returns),
    so :attr:`collectives` gets the records a real run of the same step
    writes, count and bytes."""

    def __init__(self, data: int, model: int = 1, rank: int = 0):
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.world = self.data * self.model
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {rank} of a {data} x {model} mesh")
        self.backend = "dry"
        self.device = META
        self.member = True
        data_index, model_index = divmod(self.rank, self.model)
        self.coords = {"data": data_index, "model": model_index}
        self.shard = data_index
        self.collectives = collections.defaultdict(
            lambda: {"calls": 0, "seconds": 0.0, "bytes": 0})
        self._row = self._column = self._all = None

    def __repr__(self) -> str:
        return (f"DryMesh(data={self.data}, model={self.model}, "
                f"rank={self.rank})")

    def _all_reduce(self, t, op, group) -> None:
        pass

    def _all_gather(self, parts, t, group) -> None:
        pass

    def _broadcast(self, t, src, group) -> None:
        pass

    def _gather_to(self, t, into, dst, group) -> None:
        pass

    def _reduce_scatter(self, out, t, group) -> None:
        pass

    def all_gather_object(self, value: Any) -> list:
        return [value] * self.world

    def barrier(self) -> None:
        pass


def production_mesh(multi_pod: bool = False) -> DryMesh:
    """The reference's production mesh (``make_production_mesh``) as a
    :class:`DryMesh` for rank 0."""
    return DryMesh(*MESHES["multi" if multi_pod else "single"])


class LiveBytes(TorchDispatchMode):
    """Inside the block, the bytes held by the storages that ops create
    (``live``) and their peak (``peak``): each new storage is counted
    once, when an op first returns it, and released when it is freed
    (views and in-place results share their input's storage and add
    nothing). Storages made before the block are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(t.untyped_storage()) for t in _pytree_leaves(
            (args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in _pytree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in inputs or getattr(st, "_live_bytes_seen", False):
                continue
            st._live_bytes_seen = True
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def tensor_bytes(tree) -> int:
    """Bytes of ``tree``'s distinct tensors (a view counts its own
    elements: a rank's block of a batch)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class DryStep(NamedTuple):
    """A rank's step: ``fn(*args)`` runs it; ``argument_bytes`` are the
    rank's blocks of its arguments; ``kind`` is the shape's."""
    fn: Any
    args: tuple
    argument_bytes: int
    kind: str


def _inputs(cfg, shape_name: str, device) -> dict:
    """``input_specs`` on meta, or real inputs of the same shapes and
    dtypes on another device (seeded tokens below the vocabulary,
    normal extra embeddings, position 0): the same step run for real,
    as the tests hold the dry run to it."""
    specs = input_specs(cfg, shape_name)
    if torch.device(device).type == "meta":
        return specs
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k, v in specs.items():
        if k == "pos":
            x = torch.zeros(v.shape, dtype=v.dtype)
        elif v.dtype.is_floating_point:
            x = torch.randn(v.shape, generator=gen).to(v.dtype)
        else:
            x = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=v.dtype)
        out[k] = x.to(device)
    return out


def build_step(arch_id: str, shape_name: str, mesh, *,
               optimizer_name: str = "tvlars", seq_parallel: bool = True,
               use_kernel="fused", device=META) -> DryStep:
    """The step rank ``mesh.rank`` of ``mesh`` runs for (arch, shape), on
    meta tensors of its blocks (the reference's ``build_lowerable``):

    * train: ``build_optimizer(optimizer_name, total_steps=10_000,
      learning_rate=10.0, batch_size=b·s//2048, weight_decay=5e-4)``
      (``use_kernel``: the fused path by default), the state placed by
      ``state_pspecs(fsdp=True)``, one ``make_train_step(mesh=,
      placement=)`` step on the global batch;
    * prefill: ``Model.apply`` on the rank's data block of the batch,
      returning ``logits[:, -1:]``;
    * decode: one ``make_serve_step(model, mesh)`` step against a
      ``seq_len``-deep cache of the rank's data block of the batch,
      placed by ``cache_pspecs`` (KV heads, T or head dim).

    The batch splits over the data axis where it divides, else is
    replicated. The sequence splits over the model axis (sequence
    parallelism, ``layers.set_batch_sharding(seq_axis="model")``) for
    the full-sequence kinds where the axis divides it, with
    ``seq_parallel``. Leaves the declaration set; :func:`dryrun_one`
    clears it. ``device`` other than meta (with a joined world's mesh)
    builds the same step for real."""
    cfg = get_config(arch_id)
    model = get_model(cfg)
    spec = INPUT_SHAPES[shape_name]
    kind, b, s = spec["kind"], spec["global_batch"], spec["seq_len"]
    specs = _inputs(cfg, shape_name, device)
    m = mesh.shape["model"]
    seq_axis = "model" if (seq_parallel and kind != "decode" and m > 1
                           and s % m == 0) else None
    L.set_batch_sharding(("data",), seq_axis, model_size=m, mesh=mesh)
    # the data row's block of the batch (all of it where the data axis
    # does not divide it: replicated, the reference's batch_pspecs)
    blocks = {k: v[mesh.data_block(b)] for k, v in specs.items()
              if v.dim() > 0}

    if kind == "train":
        params = model.init(0, device=device, mesh=mesh, fsdp=True)
        place = convert.placement(cfg, mesh)
        opt = build_optimizer(optimizer_name, total_steps=10_000,
                              learning_rate=10.0, batch_size=b * s // 2048,
                              weight_decay=5e-4, use_kernel=use_kernel,
                              segments=model.segments, device=device,
                              placement=place)
        state = TrainState.create(params, opt)
        step = make_train_step(model, opt, mesh=mesh, placement=place)
        return DryStep(step, (state, dict(specs)),
                       tensor_bytes(state) + tensor_bytes(blocks), kind)

    params = model.init(0, device=device, mesh=mesh)
    if kind == "prefill":
        def forward(params, tokens, extra):
            with L.batch_sharding(mesh):
                return model.apply(params, tokens, extra)[:, -1:]

        args = (params, blocks["tokens"], blocks.get("extra_embeds"))
        return DryStep(forward, args,
                       tensor_bytes(params) + tensor_bytes(blocks), kind)

    rows = blocks["tokens"].shape[0]
    with L.batch_sharding(mesh):
        cache = model.init_cache(params, rows, s,
                                 blocks.get("extra_embeds"))
    # the engine's per-row depths; the reference's 0-d int32 pos
    pos = specs["pos"].expand(rows).contiguous()
    serve = make_serve_step(model, mesh)
    args = (params, cache, blocks["tokens"], pos)
    return DryStep(serve, args, tensor_bytes(params) + tensor_bytes(cache)
                   + tensor_bytes(blocks["tokens"]) + specs["pos"].numel()
                   * specs["pos"].element_size(), kind)


def trace(step: DryStep, mesh) -> dict:
    """Run ``step`` once on meta; the measurements of the module
    docstring (but the status), ``mesh``'s records included."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh.collectives.clear()
    ops.reset_meta_launches()
    with FlopCounterMode(display=False) as flops, LiveBytes() as live:
        out = step.fn(*step.args)
        del out
    colls = {k: {"count": v["calls"], "bytes": v["bytes"]}
             for k, v in sorted(mesh.collectives.items())}
    return {
        "argument_bytes": step.argument_bytes,
        "peak_bytes": step.argument_bytes + live.peak,
        "flops": int(flops.get_total_flops())
        + sum(ops.meta_flops.values()),
        "collectives": colls,
        "collective_bytes": sum(v["bytes"] for v in colls.values()),
        "launches": {k: v for k, v in ops.meta_launches.items() if v},
    }


def dryrun_one(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               optimizer_name: str = "tvlars",
               save_dir: Optional[str] = SAVE_DIR, verbose: bool = True,
               seq_parallel: bool = True) -> dict:
    """Build and trace one (arch, shape, mesh) for rank 0; the result
    dict (saved as JSON under ``save_dir``)."""
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = supports_shape(get_config(arch_id), shape_name)
    if not ok:
        result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped", "reason": reason}
        _save(save_dir, result)
        if verbose:
            print(f"[skip] {arch_id} × {shape_name}: {reason}")
        return result
    t0 = time.perf_counter()
    mesh = production_mesh(multi_pod)
    try:
        step = build_step(arch_id, shape_name, mesh,
                          optimizer_name=optimizer_name,
                          seq_parallel=seq_parallel)
        got = trace(step, mesh)
    finally:
        L.set_batch_sharding(None)
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "optimizer": optimizer_name,
              "num_devices": mesh.world,
              "seconds": time.perf_counter() - t0, **got}
    _save(save_dir, result)
    if verbose:
        gib = result["peak_bytes"] / 2**30
        print(f"[ok]   {arch_id} × {shape_name} × {mesh_name}: "
              f"{gib:.2f} GiB/rank, {result['flops']:.3e} flops/rank, "
              f"{result['collective_bytes'] / 2**30:.3f} GiB "
              f"collective/rank ({result['seconds']:.1f} s)")
    return result


def _save(save_dir: Optional[str], result: dict) -> None:
    if not save_dir:
        return
    os.makedirs(save_dir, exist_ok=True)
    fname = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
             ".json").replace("/", "_")
    with open(os.path.join(save_dir, fname), "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--optimizer", default="tvlars")
    ap.add_argument("--save-dir", default=SAVE_DIR)
    ap.add_argument("--keep-going", action="store_true",
                    help="continue past failures (report at end)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    dryrun_one(arch, shape, multi_pod=mp,
                               optimizer_name=args.optimizer,
                               save_dir=args.save_dir)
                except Exception:
                    failures.append((arch, shape, mp))
                    print(f"[FAIL] {arch} × {shape} × "
                          f"{'multi' if mp else 'single'}")
                    traceback.print_exc()
                    if not args.keep_going:
                        raise
    if failures:
        print(f"\n{len(failures)} failures: {failures}")
        return 1
    print("\nAll dry-runs passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

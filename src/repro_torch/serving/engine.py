"""Continuous-batching LM serving engine.

One :class:`Engine` owns a fixed-slot decode batch (``ServeConfig.
slots`` rows, ``max_len`` cache entries each — the
:class:`~repro_torch.serving.kv_cache.PagedKVCache` pool), a waiting
queue, and one decode step. Requests are admitted into free slots via
single-shot batched prefill (``model.prefill``: one full-sequence
forward + KV dump, padded to power-of-two length/count buckets), then
every ``step()`` advances ALL occupied slots one token in one decode
call — requests enter and leave mid-flight without changing any
device shape:

* the cache is always ``[slots, T]`` per layer and decode appends into
  it in place (on CUDA, inside the Hopper decode kernel),
* per-slot depths ride in as a ``[slots]`` int32 position tensor on
  the device,
* free slots decode garbage that is never read (their mask attends
  position 0 only; admission overwrites the whole slot row).

``stats()["kernel_launches"]`` counts the decode-attention kernel
launches this engine's decode steps made, every mode
(``kernels.ops.decode_launches``);
it stays 0 on the CPU, where the plain version runs. A family without
a batched prefill (ssm, hybrid, encdec) is refused, as the reference's
engine refuses it; serve those through ``serving.generate``. A vlm
needs ``extra``, one block of image embeddings ``[slots, T_img, D]``:
the pool's cross K/V start from it, and an admission batch of ``nb``
requests is prefilled on its rows ``extra[:nb]``, so the i-th request
of a batch reads row i whatever its slot, as in the reference.

``mesh=`` serves on a ``(D, M)`` mesh, one engine per rank: each rank
holds its blocks of the params (``Model.init(mesh=)``,
``convert.shard_params`` or ``from_checkpoint(shardings=)``) and a KV
pool of its blocks (``layers.cache_block``, ``cache_pspecs``' rule: its
KV heads, else block r of T, else block r of the head dim, of every KV
head), and every prefill and decode
step runs under ``layers.batch_sharding(mesh)``: the row-parallel
partials are summed and the logits gathered over the model row. The
slots split over the data axis (``Mesh.data_block``, the reference's
batch-over-data placement): data row j's pool holds slots ``[j·S/D,
(j+1)·S/D)``, and it prefills and decodes those slots only; the sampled
tokens are gathered over the data column, so every rank holds every
slot's token and takes the same scheduler decisions (all S slots when
D does not divide S). A sampled step draws for all S rows (the
admission: all rows of the batch) exactly as the D = 1 engine does and
keeps its own, so tokens do not depend on the split. An admission
batch keeps F10's meaning across rows: its i-th request reads row i of
``extra``. ``drain`` fails unless every rank of the mesh holds the
same tokens (a rank past a mesh narrower than its world takes no
part). The decode kernel runs on each rank's share of the heads, in
its partial mode on every head over the rank's block of T, or in its
scores and apply modes over the rank's block of the head dim.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch import device as _device
from repro_torch.configs.base import torch_dtype
from repro_torch.core.base import tree_leaves
from repro_torch.distributed import all_equal
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models.registry import NEEDS_EXTRA, get_model
from repro_torch.models.transformer import check_model_axis
from repro_torch.obs import trace
from repro_torch.serving import sampling
from repro_torch.serving.kv_cache import PagedKVCache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The one public serving configuration.

    slots: decode-batch width (concurrent in-flight requests).
    max_len: KV cache entries per slot; every request must satisfy
        ``prompt_len + max_new_tokens <= max_len``.
    page_size: KV page granularity (tokens); ``max_len`` must divide
        into whole pages.
    prefill_batch: max requests admitted in one batched prefill.
    sampling: :class:`SamplingParams` (default greedy).
    cache_dtype: KV pool storage dtype override (e.g. "bfloat16" to
        halve pool bytes; decode accumulates in f32 either way).
    """
    slots: int = 8
    max_len: int = 256
    page_size: int = 16
    prefill_batch: int = 4
    sampling: sampling.SamplingParams = dataclasses.field(
        default_factory=sampling.SamplingParams)
    cache_dtype: Optional[str] = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.cache_dtype is not None:
            torch_dtype(self.cache_dtype)      # raises ValueError
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.max_len < 1 or self.max_len % self.page_size:
            raise ValueError(
                f"max_len ({self.max_len}) must be a positive multiple "
                f"of page_size ({self.page_size})")
        if self.prefill_batch < 1:
            raise ValueError(
                f"prefill_batch must be >= 1, got {self.prefill_batch}")


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    submitted: float                   # perf_counter
    tokens: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RequestResult:
    id: int
    prompt: np.ndarray
    tokens: list                       # generated ids (ints)
    prompt_len: int
    finished: bool                     # False = evicted mid-flight
    submitted: float
    completed: float

    @property
    def latency_s(self) -> float:
        return self.completed - self.submitted


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class Engine:
    """``submit`` / ``step`` / ``drain`` — the whole public surface.

    ``submit`` enqueues a request and returns its id; ``step`` runs one
    scheduler iteration (admit waiting requests into free slots via
    batched prefill, then one decode step over the full slot batch) and
    returns the requests that finished during it; ``drain`` steps until
    the engine is empty and returns every finished result. ``params``
    must lie on ``device``.
    """

    def __init__(self, model, params, config: ServeConfig, *,
                 device="cuda", tracer=None, extra=None, mesh=None):
        if model.prefill is None:
            raise ValueError(
                f"family {model.cfg.family!r} has no batched-prefill "
                f"lowering; the serving engine requires model.prefill "
                f"(supported: dense / moe / gemma3-style windowed)")
        if model.cfg.family in NEEDS_EXTRA and extra is None:
            raise ValueError(
                f"family {model.cfg.family!r} needs an extra-embeddings "
                f"frontend; pass extra= (one [slots, ...] block) or "
                f"serve a text-only family")
        dev = _device.resolve(device)
        pdev = params["embed"]["table"].device
        if pdev.type != dev.type or (
                dev.index is not None and pdev.index != dev.index):
            raise ValueError(f"params lie on {pdev}, engine device is "
                             f"{dev}")
        check_model_axis(model.cfg, params, mesh)
        if config.cache_dtype:
            model = get_model(model.cfg.replace(
                kv_cache_dtype=config.cache_dtype))
        self.device = pdev
        self.mesh = mesh
        self.tracer = trace.NULL if tracer is None else tracer
        self.model = model
        self.params = params
        self.config = config
        # an admission batch can never exceed the free slots
        self._prefill_cap = min(config.prefill_batch, config.slots)
        self._extra = None if extra is None else extra.to(pdev)
        # the slots this rank's data row holds
        self._rows = slice(0, config.slots) if mesh is None \
            else mesh.data_block(config.slots)
        self._split = self._rows != slice(0, config.slots)
        with L.batch_sharding(mesh):
            self._kv = PagedKVCache(
                model, params, config,
                None if self._extra is None else self._extra[self._rows],
                self._rows.stop - self._rows.start)
        self._pos = np.zeros(config.slots, np.int32)
        self._tok = np.zeros(config.slots, np.int32)
        self._active: list = [None] * config.slots
        self._free = list(range(config.slots - 1, -1, -1))
        self._waiting: collections.deque = collections.deque()
        self._results: dict[int, RequestResult] = {}
        self._next_id = 0
        self._steps = 0
        self._decode_steps = 0
        self._prefills = 0
        self._row_prefills = 0
        self._kernel_launches = 0
        self._tokens_generated = 0
        self._gen = torch.Generator(device=pdev)
        self._gen.manual_seed(config.sampling.seed)
        self._sampler = sampling.make_sampler(config.sampling)

    # -- public API -------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, model, config: ServeConfig, *,
                        device="cuda", mesh=None, shardings=None,
                        tracer=None, extra=None) -> "Engine":
        """Build an engine on the params of a checkpoint in the JAX
        package's stacked LM layout (``convert.jax_template``), written
        by either package: restored onto ``device`` against the
        config's template, then unstacked into the port's lists.
        ``mesh=`` / ``shardings=`` restore through the placement-aware
        reader onto this rank's device and serve on ``mesh`` (or on the
        shardings' mesh): ``mesh=`` alone replicates every leaf, as the
        reference's does; ``shardings=`` (placements over the stacked
        template, e.g. ``launch.sharding.named(mesh, state_pspecs(mesh,
        jax_template(cfg)))``) keeps this rank's block of each split
        leaf."""
        stacked = checkpoint.restore(path, convert.jax_template(model.cfg),
                                     device=device, mesh=mesh,
                                     shardings=shardings)
        dev = tree_leaves(stacked)[0].device
        params = convert.params_from_jax(model.cfg, stacked, device=dev)
        if mesh is None and shardings is not None:
            mesh = tree_leaves(shardings)[0].mesh
        return cls(model, params, config, device=dev, tracer=tracer,
                   extra=extra, mesh=mesh)

    def submit(self, prompt: Union[Sequence[int], np.ndarray], *,
               max_new_tokens: int = 16) -> int:
        """Enqueue one request; returns its id (admission happens at
        the next ``step``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.config.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len "
                f"{self.config.max_len}")
        rid = self._next_id
        self._next_id += 1
        self._waiting.append(Request(rid, prompt, max_new_tokens,
                                     time.perf_counter()))
        return rid

    def step(self) -> list[RequestResult]:
        """One scheduler iteration: admit -> decode -> finish.

        Each phase records a trace-v1 span (``admit`` wraps the
        scheduler move incl. the ``prefill`` device work inside it;
        ``decode`` is the asynchronous dispatch, ``sample`` the device
        sync that brings the sampled tokens to the host, ``finish`` the
        host bookkeeping)."""
        tr = self.tracer
        with tr.span("admit", step=self._steps,
                     waiting=len(self._waiting)), \
                L.batch_sharding(self.mesh):
            finished = self._admit()
        if any(r is not None for r in self._active):
            rows = self._rows
            tok = torch.tensor(self._tok[rows, None], device=self.device)
            pos = torch.tensor(self._pos[rows], device=self.device)
            with tr.span("decode", step=self._steps,
                         active=self.active_count), \
                    L.batch_sharding(self.mesh):
                before = ops.decode_launches()
                logits, self._kv.cache = self.model.decode_step(
                    self.params, self._kv.cache, tok, pos)
                nxt = self._sample(logits[:, -1], rows, self.config.slots)
                self._kernel_launches += ops.decode_launches() - before
            with tr.span("sample", step=self._steps):
                if self._split:
                    nxt = self.mesh.data_gather(nxt, 0)
                nxt = nxt.cpu().numpy()
            self._decode_steps += 1
            with tr.span("finish", step=self._steps):
                for s, req in enumerate(self._active):
                    if req is None:
                        continue
                    req.tokens.append(int(nxt[s]))
                    self._tok[s] = nxt[s]
                    self._pos[s] += 1
                    self._tokens_generated += 1
                    self._kv.table.ensure(s, int(self._pos[s]) + 1)
                    if len(req.tokens) >= req.max_new_tokens:
                        finished.append(self._finish(s, done=True))
        self._steps += 1
        return finished

    def drain(self) -> list[RequestResult]:
        """Step until no request is waiting or in flight; returns every
        result that finished during the drain. On a mesh of several
        ranks it raises unless every rank holds the same results."""
        budget = 64 + sum(r.max_new_tokens for r in self._waiting) \
            + sum(r.max_new_tokens for r in self._active
                  if r is not None)
        out: list[RequestResult] = []
        while self._waiting or any(r is not None for r in self._active):
            out.extend(self.step())
            budget -= 1
            if budget < 0:
                raise RuntimeError(
                    "drain did not converge — scheduler bug (a step "
                    "must either admit or generate)")
        # over the mesh's ranks, which alone run the engine's steps
        if not all_equal(self.mesh, sorted((r.id, r.tokens) for r in out)):
            raise RuntimeError(f"drain: the ranks of {self.mesh} hold "
                               f"different tokens")
        return out

    def evict(self, request_id: int) -> RequestResult:
        """Abort an in-flight (or waiting) request, freeing its slot
        and pages; the partial result is marked unfinished."""
        for s, req in enumerate(self._active):
            if req is not None and req.id == request_id:
                return self._finish(s, done=False)
        for req in list(self._waiting):
            if req.id == request_id:
                self._waiting.remove(req)
                res = RequestResult(req.id, req.prompt, req.tokens,
                                    int(req.prompt.size), False,
                                    req.submitted, time.perf_counter())
                self._results[req.id] = res
                return res
        raise KeyError(f"no waiting or in-flight request {request_id}")

    def result(self, request_id: int) -> RequestResult:
        return self._results[request_id]

    # -- scheduler internals ----------------------------------------------

    def _sample(self, logits: torch.Tensor, rows, n: int) -> torch.Tensor:
        """Tokens for ``logits``, the rows ``rows`` (a slice or an index
        list) of a batch of ``n``: a sampling engine draws for all ``n``
        rows as the single-rank engine does (the other rows' logits
        zeros) and keeps its own, so the generator's state and every
        row's draw do not depend on the data split."""
        if self.config.sampling.temperature == 0.0 or logits.shape[0] == n:
            return self._sampler(logits, self._gen)
        idx = torch.arange(n, device=logits.device)[rows]
        full = torch.zeros((n, logits.shape[-1]), dtype=logits.dtype,
                           device=logits.device)
        full.index_copy_(0, idx, logits)
        return self._sampler(full, self._gen)[idx]

    def _admit(self) -> list[RequestResult]:
        """Move waiting requests into free slots through ONE batched
        prefill (padded to pow2 count/length buckets)."""
        batch: list[tuple[Request, int]] = []
        while self._waiting and self._free \
                and len(batch) < self._prefill_cap:
            batch.append((self._waiting.popleft(), self._free.pop()))
        if not batch:
            return []
        nb = min(_next_pow2(len(batch)), self._prefill_cap)
        nb = max(nb, len(batch))
        max_prompt = max(r.prompt.size for r, _ in batch)
        lb = min(max(_next_pow2(max_prompt), self.config.page_size),
                 self.config.max_len)
        lb = max(lb, max_prompt)
        tokens = np.zeros((nb, lb), np.int64)
        lens = np.ones(nb, np.int64)
        for i, (req, _) in enumerate(batch):
            tokens[i, :req.prompt.size] = req.prompt
            lens[i] = req.prompt.size
        # the batch rows whose slots this rank's data row holds (all of
        # them without a data split); row i keeps its index i: extra row
        # i (F10) and its place among the sampler's rows
        lo, hi = self._rows.start, self._rows.stop
        mine = [i for i, (_, slot) in enumerate(batch) if lo <= slot < hi] \
            if self._split else list(range(nb))
        with self.tracer.span("prefill", step=self._steps, batch=nb,
                              length=lb):
            first = torch.zeros(nb, dtype=torch.int32, device=self.device)
            if mine:
                lens_t = torch.tensor(lens[mine], device=self.device)
                logits, pf_cache = self.model.prefill(
                    self.params, torch.tensor(tokens[mine],
                                              device=self.device),
                    self.config.max_len, lens_t, logits_at=lens_t - 1,
                    extra=None if self._extra is None
                    else self._extra[:nb][mine])
                first[mine] = self._sample(logits[:, 0], mine, nb)
                self._row_prefills += 1
            elif self.config.sampling.temperature > 0.0:
                # the draws the other rows' samplers make
                self._sample(torch.zeros((0, self.model.cfg.vocab_size),
                                         device=self.device), [], nb)
            if self._split:
                # the data row holding each batch row's slot
                owner = torch.tensor([slot // (hi - lo) for _, slot in batch]
                                     + [0] * (nb - len(batch)),
                                     device=self.device)
                every = self.mesh.data_gather(first[None], 0)  # [D, nb]
                first = every[owner, torch.arange(nb, device=self.device)]
            first = first.cpu().numpy()
        self._prefills += 1
        finished = []
        local = {i: k for k, i in enumerate(mine)}
        for i, (req, slot) in enumerate(batch):
            if i in local:
                self._kv.insert(pf_cache, local[i], slot - lo)
            self._kv.table.ensure(slot, int(req.prompt.size) + 1)
            self._pos[slot] = req.prompt.size
            self._tok[slot] = first[i]
            req.tokens.append(int(first[i]))
            self._tokens_generated += 1
            self._active[slot] = req
            if len(req.tokens) >= req.max_new_tokens:
                finished.append(self._finish(slot, done=True))
        return finished

    def _finish(self, slot: int, *, done: bool) -> RequestResult:
        req = self._active[slot]
        self._active[slot] = None
        self._free.append(slot)
        self._kv.table.release(slot)
        self._pos[slot] = 0
        self._tok[slot] = 0
        res = RequestResult(req.id, req.prompt, req.tokens,
                            int(req.prompt.size), done, req.submitted,
                            time.perf_counter())
        self._results[req.id] = res
        return res

    # -- introspection ----------------------------------------------------

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self._active)

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    def stats(self) -> dict:
        return {"steps": self._steps,
                "decode_steps": self._decode_steps,
                "prefills": self._prefills,
                "row_prefills": self._row_prefills,
                "row_slots": self._rows.stop - self._rows.start,
                "tokens_generated": self._tokens_generated,
                "active": self.active_count,
                "waiting": self.queue_depth,
                "kernel_launches": self._kernel_launches,
                **self._kv.table.stats()}

"""The port's side of the data-parallel parity tests: functions that run
on every rank of a gloo world on the CPU (``launch.mesh.spawn``).

Not collected, and imports torch, numpy and ``repro_torch`` only: a
spawned rank imports this module afresh. Inputs arrive as numpy trees
(the reference's own params and batches, made by the test process);
every function returns, from every rank, its numbers as numpy arrays
and whether the ranks' states were bitwise equal (``fingerprint``
gathered over the world), so the test process compares them with the
reference's results.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.cnn import apply_mlp_classifier
from repro_torch.models.convert import (classifier_params_from_jax,
                                        params_from_jax, params_to_jax)
from repro_torch.training import (TrainState, classifier_task, lm_task,
                                  make_train_step)
from repro_torch.training.train_state import fingerprint, replicate

LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, d_ff=128, vocab_size=128, remat=False)


def lm_model():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    return get_model(ModelConfig(**LM))


def _np(tree) -> list:
    """The leaves as numpy arrays; bf16 ones as their uint16 bits."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return [one(x) for x in tree_leaves(tree)]


def _batch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return tuple(torch.from_numpy(np.array(v)) for v in tree)


def _stack(batch, k: int):
    if k == 1:
        return batch
    return tree_map(lambda x: x.reshape((k, x.shape[0] // k)
                                        + tuple(x.shape[1:])), batch)


def _setup(workload: str, inputs: dict, use_kernel, precision="f32"):
    name = "tvlars" if use_kernel == "fused" else "wa-lars"
    if workload == "mlp":
        task = classifier_task(apply_mlp_classifier)
        params = classifier_params_from_jax(inputs["mlp"], device="cpu")
        segments = None
    else:
        model = lm_model()
        task = lm_task(model)
        params = params_from_jax(model.cfg, inputs["lm"], device="cpu")
        segments = model.segments
    opt = build_optimizer(name, total_steps=10, learning_rate=1.0,
                          use_kernel=use_kernel, precision=precision,
                          segments=segments, device="cpu")
    return task, opt, params


def _params_np(workload, params) -> list:
    if workload == "lm":
        return _np(params_to_jax(lm_model().cfg, params))
    return _np(params)


class _Count:
    """Counts the calls of one ``ops`` function (the plain versions that
    stand in for the kernel launches on the CPU)."""

    def __init__(self, name: str):
        self.name, self.calls = name, 0
        self.real = getattr(ops, name)

    def __enter__(self):
        def counting(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)
        setattr(ops, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.real)


def _one_step(mesh, workload, k, inputs, use_kernel="fused"):
    """One mesh step from the initial state, and on rank 0 the port's
    single-device step on the same global batch."""
    task, opt, params = _setup(workload, inputs, use_kernel)
    batch = _stack(_batch(inputs[f"{workload}-batch-{k}"]), k)
    counted = "segmented_update" if use_kernel == "fused" else "lars_apply"
    state = replicate(TrainState.create(params, opt), mesh)
    # LWN / LGN / LNR per leaf of the MLP (an LM tree's norms go by the
    # reference's stacked leaves: its layerwise/* below)
    step = make_train_step(task, opt, accum_steps=k, mesh=mesh,
                           record_norms=workload == "mlp", layerwise=True)
    with _Count(counted) as count:
        state, m = step(state, batch)
    out = {"equal": mesh_lib.all_equal(mesh, fingerprint(state)),
           "calls": count.calls}
    if mesh.rank != 0:
        return out
    out.update(params=_params_np(workload, state.params),
               opt_state=_np(state.opt_state),
               **{k_: float(m[k_]) for k_ in ("loss", "grad_norm")},
               **{k_: m[f"layerwise/{k_}"].numpy()
                  for k_ in ("w_norm", "g_norm", "trust_ratio")},
               **{k_: getattr(m["layer_norms"], k_).numpy()
                  for k_ in ("lwn", "lgn", "lnr") if "layer_norms" in m})
    task, opt, params = _setup(workload, inputs, use_kernel)
    single = make_train_step(task, opt, accum_steps=k)
    with _Count(counted) as count:
        s1, m1 = single(TrainState.create(params, opt), batch)
    out.update(single_params=_params_np(workload, s1.params),
               single_loss=float(m1["loss"]), single_calls=count.calls)
    return out


def steps_world(d: int, cases: list, inputs: dict, ckpt_dir: str) -> dict:
    """Every step case of data width ``d``; at d = 2 the checkpoints are
    saved from this world, at d = 4 restored into it."""
    torch.set_num_threads(1)
    from repro_torch.checkpoint import checkpoint as ck
    mesh = mesh_lib.make_data_mesh(d)
    res = {f"{w}-K{k}-D{d_}-{uk}": _one_step(mesh, w, k, inputs, uk)
           for w, k, d_, uk in cases}
    for precision in ("f32", "bf16_master"):
        path = f"{ckpt_dir}/{precision}"
        task, opt, params = _setup("mlp", inputs, "fused", precision)
        if d == 2:
            state = replicate(TrainState.create(params, opt), mesh)
            state, _ = make_train_step(task, opt, mesh=mesh)(
                state, _batch(inputs["mlp-batch-1"]))
            ck.save(path, ck.train_state_tree(state), step=1, mesh=mesh)
            res[f"saved-{precision}"] = {"state": _np(
                ck.train_state_tree(state)), "fingerprint": fingerprint(
                    state)}
            continue
        like = TrainState.create(params, opt)
        try:
            ck.restore_train_state(path, like, mesh=mesh)
        except ValueError as e:
            res[f"refused-cuda-{precision}"] = str(e)
        got = ck.restore_train_state(path, like, mesh=mesh, device="cpu")
        fp = fingerprint(got)
        nxt, _ = make_train_step(task, opt, mesh=mesh)(
            got, _batch(inputs["mlp-batch-1"]))
        res[f"restored-{precision}"] = {
            "equal": mesh_lib.all_equal(mesh, fp), "fingerprint": fp,
            "step": got.step, "next": _np(nxt.params),
            "device": str(tree_leaves(got.params)[0].device)}
    res["mean"] = mean_world(d)
    return res


def mean_draws(rank: int) -> list:
    """Rank ``rank``'s f32 tensors for :func:`mean_world`: odd sizes,
    ``-0.0`` at even positions on every rank."""
    gen = torch.Generator().manual_seed(100 + rank)
    out = [torch.randn(n, generator=gen) for n in (7, 15, 1, 9)]
    for t in out:
        t[::2] = -0.0
    return out


def mean_world(d: int) -> dict:
    """``Mesh.mean_`` at D = 2 and D = ``d`` over this world, with
    buckets of 4 values so that they split and join leaves; ranks past
    D = 2 contribute nothing."""
    from repro_torch import distributed
    out = {}
    real = distributed.BUCKET_BYTES
    distributed.BUCKET_BYTES = 16
    try:
        for width in sorted({2, d}):
            mesh = mesh_lib.make_data_mesh(width)
            got = mean_draws(mesh.rank)
            mesh.mean_(got)
            out[width] = {"values": [t.numpy() for t in got],
                          "equal": mesh_lib.all_equal(mesh, fingerprint(got))}
    finally:
        distributed.BUCKET_BYTES = real
    return out


def probes_world(inputs: dict) -> dict:
    """The noise scale at D = 2 over this world of 4 (ranks 2 and 3
    past the mesh), Lanczos and SAM at D = 4, and the controller
    scenario."""
    torch.set_num_threads(1)
    from repro_torch.diagnostics import hvp, sharpness
    from repro_torch.diagnostics.lanczos import lanczos, top_k_eigenvalues
    task = classifier_task(apply_mlp_classifier)
    params = classifier_params_from_jax(inputs["mlp"], device="cpu")
    batch = _batch(inputs["mlp-batch-16"])
    mesh2, mesh4 = mesh_lib.make_data_mesh(2), mesh_lib.make_data_mesh(4)
    res = {}
    gns = sharpness.gradient_noise_scale(task, params, batch,
                                         accum_steps=1, mesh=mesh2)
    res["gns"] = {k: float(v) for k, v in gns.items()}
    res["gns_equal"] = mesh_lib.all_equal(mesh4, res["gns"])
    stacked = _stack(batch, 2)
    op = hvp.make_flat_hvp(task, params, stacked, accum_steps=2, mesh=mesh4)
    v0 = torch.from_numpy(np.array(inputs["v0"]))
    hv0 = op.matvec(v0)
    lz = lanczos(op.matvec, v0, 8)
    res["hv0"] = hv0.numpy()
    res["lambda_max"] = float(top_k_eigenvalues(lz.alphas, lz.betas, 1)[0])
    res["hv0_equal"] = mesh_lib.all_equal(mesh4, hv0.numpy().tobytes())
    sam = sharpness.sam_sharpness(task, params, stacked, accum_steps=2,
                                  mesh=mesh4)
    res["sam"] = {k: float(v) for k, v in sam.items()}
    res["sam_equal"] = mesh_lib.all_equal(mesh4, res["sam"])
    res["controller"] = _controller(inputs)
    return res


def _controller(inputs: dict) -> dict:
    """``test_controller_retargets_data_axis``'s scenario on this world
    of 4 ranks, on the reference's samples; every step's record, the
    controller's counts, the optimizer calls per step and whether the
    ranks' states were bitwise equal after every step."""
    from repro_torch.data import pipeline
    from repro_torch.diagnostics import sink as sinks
    from repro_torch.training import (AdaptiveBatchController,
                                      ControllerConfig, FitOptions, fit)
    mb = inputs["mb"]
    cfg = ControllerConfig(microbatch=mb, batch_min=mb, batch_max=64 * mb,
                           every=2, deadband=0.0, ema=0.0, data_max=4)
    task = classifier_task(apply_mlp_classifier)
    readings = inputs["readings"]

    def opt_for(b):
        return build_optimizer("tvlars", total_steps=20, learning_rate=1.0,
                               batch_size=b, base_batch_size=64,
                               use_kernel="fused", device="cpu")

    ctl = AdaptiveBatchController(
        lambda opt, k, mesh: make_train_step(task, opt, accum_steps=k,
                                             mesh=mesh),
        opt_for, lambda step, state: {
            "grad_noise_scale": readings.get(step, float("nan"))},
        cfg, init_batch=mb, base_lr=1.0, base_batch_size=64)
    params = classifier_params_from_jax(inputs["mlp"], device="cpu")
    state = replicate(TrainState.create(params, ctl.optimizer()),
                      ctl.mesh_for(4))
    images, labels = (torch.from_numpy(np.array(x))
                      for x in inputs["samples"])
    stream = pipeline.MicrobatchedStream(
        lambda start, count: (images[start:start + count],
                              labels[start:start + count]), mb)
    prints = []

    class Watch:
        """After every step: this rank's fingerprint and the optimizer
        calls so far."""
        name, every = "watch", 1

        def __call__(self, step, state_):
            prints.append((fingerprint(state_), count.calls))
            return {}

    sink = sinks.MemorySink()
    with _Count("segmented_update") as count:
        state, _ = fit(None, state, stream, inputs["steps"],
                       options=FitOptions(sink=sink, callbacks=[Watch()],
                                          controller=ctl,
                                          rank=ctl.mesh_for(4).rank))
    mesh = ctl.mesh_for(4)
    return {"records": sink.records, "compiles": ctl.compiles,
            "switches": ctl.switches,
            "visited": [list(t) for t in ctl.visited_targets],
            "calls": [c for _, c in prints],
            "equal": mesh_lib.all_equal(mesh, [p for p, _ in prints]),
            "state": _np(state) if mesh.rank == 0 else None}


def fail_on_rank(bad: int) -> int:
    """Raises on rank ``bad`` (the others then wait at the barrier)."""
    rank = mesh_lib.world().rank
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def sleep_for(seconds: float) -> None:
    import time
    time.sleep(seconds)

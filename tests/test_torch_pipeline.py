"""The port's sample sources and microbatch streams
(``repro_torch.data.synthetic`` / ``repro_torch.data.pipeline``) on the
CPU.

* The three sample sources are partition-invariant: any split of
  ``[start, start + n)`` gives the same samples, exactly.
* ``MicrobatchedStream`` keeps its position across K (and D) switches.
* ``PrefetchingStream`` yields the wrapped stream's samples, also across
  a retarget at step n (drain and rewind), ends a finite stream, raises
  a producer's error on the consumer, and survives a stress of many
  retargets with a short switch interval.
* ``LengthBucketedStream`` yields every sample exactly once, trimmed to
  its bucket, and deterministically.
* Fed the reference's own source output (as numpy), the port's
  ``MicrobatchedStream`` and ``LengthBucketedStream`` give the
  reference's batches bitwise.
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro_torch.data import pipeline, synthetic

DATA = synthetic.ClassificationData(num_classes=4, image_size=8, seed=0,
                                    label_noise=0.2)


def _sources():
    return {
        "classification": synthetic.classification_sample_source(
            DATA, seed=3, device="cpu"),
        "lm": synthetic.lm_sample_source(12, 37, seed=1, device="cpu"),
        "lm_varlen": synthetic.lm_varlen_sample_source(
            16, 11, seed=2, min_seq=2, device="cpu"),
    }


def _leaves(batch):
    if isinstance(batch, dict):
        return [batch[k] for k in sorted(batch)]
    if isinstance(batch, (tuple, list)):
        return list(batch)
    return [batch]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["classification", "lm", "lm_varlen"])
@pytest.mark.parametrize("start,cuts", [(0, (3, 5)), (7, (1, 2, 6)),
                                        (100, (4,))])
def test_sources_are_partition_invariant(name, start, cuts):
    src = _sources()[name]
    n = 8
    whole = src(start, n)
    bounds = [0, *cuts, n]
    parts = [src(start + a, b - a) for a, b in zip(bounds, bounds[1:])]
    joined = [torch.cat(xs) for xs in zip(*(_leaves(p) for p in parts))]
    for x, y in zip(_leaves(whole), joined):
        assert torch.equal(x, y)
    # a fresh source with the same seed gives the same samples
    _assert_same(_sources()[name](start, n), whole)


def test_sources_differ_by_seed_and_keep_their_contracts():
    a = synthetic.lm_sample_source(16, 97, seed=0, device="cpu")(0, 4)
    b = synthetic.lm_sample_source(16, 97, seed=1, device="cpu")(0, 4)
    assert not torch.equal(a["tokens"], b["tokens"])
    # the bigram chain: labels are the next tokens, steps in {0, 1, 2}
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    step = (a["labels"] - 5 * a["tokens"] - 1) % 97
    assert set(step[:, :-1].unique().tolist()) <= {0, 1, 2}
    v = synthetic.lm_varlen_sample_source(16, 11, min_seq=2,
                                          device="cpu")(0, 32)
    lengths = v["length"]
    assert ((2 <= lengths) & (lengths <= 16)).all()
    for i, ln in enumerate(lengths.tolist()):
        assert (v["tokens"][i, ln:] == 0).all()
        assert (v["labels"][i, ln:] == 0).all()
    with pytest.raises(ValueError, match="min_seq"):
        synthetic.lm_varlen_sample_source(8, 11, min_seq=9, device="cpu")
    x, y = synthetic.classification_sample_source(DATA, device="cpu")(0, 6)
    assert x.shape == (6, 8, 8, 3) and y.dtype == torch.int64
    assert ((0 <= y) & (y < 4)).all()


def _arange_source(start, count):
    return torch.arange(start, start + count)


def test_stream_keeps_its_position_across_k_switches():
    s = pipeline.MicrobatchedStream(_arange_source, microbatch=2,
                                    accum_steps=2)
    assert next(s).tolist() == [[0, 1], [2, 3]]
    s.set_accum_steps(3)
    assert next(s).tolist() == [[4, 5], [6, 7], [8, 9]]
    s.set_accum_steps(1)
    assert next(s).tolist() == [10, 11]
    s.set_data_parallel(2)
    assert next(s).tolist() == [12, 13, 14, 15]
    assert s.position == 16 and s.global_batch == 4
    fresh = pipeline.MicrobatchedStream(_arange_source, microbatch=2,
                                        accum_steps=2, position=16)
    assert next(fresh).tolist() == [[16, 17], [18, 19]]
    with pytest.raises(ValueError, match=">= 1"):
        s.set_accum_steps(0)
    with pytest.raises(ValueError, match=">= 1"):
        s.set_data_parallel(0)
    with pytest.raises(ValueError, match="microbatch"):
        pipeline.MicrobatchedStream(_arange_source, microbatch=0)


def test_stack_microbatches_and_fixed_iterator():
    batch = {"x": torch.arange(12).reshape(6, 2), "y": torch.arange(6)}
    st = pipeline.stack_microbatches(batch, 3)
    assert st["x"].shape == (3, 2, 2) and st["y"].tolist() == [[0, 1],
                                                                [2, 3],
                                                                [4, 5]]
    assert pipeline.stack_microbatches(batch, 1) is batch
    with pytest.raises(ValueError, match="divisible"):
        pipeline.stack_microbatches(batch, 4)
    with pytest.raises(ValueError, match=">= 1"):
        pipeline.stack_microbatches(batch, 0)
    # the move keeps the old import path
    assert synthetic.stack_microbatches is pipeline.stack_microbatches
    it = pipeline.microbatched_iterator(iter([batch, batch]), 2)
    assert [b["y"].shape for b in it] == [(2, 3), (2, 3)]
    placed = pipeline.place_batch((torch.zeros(2), torch.ones(3)), "cpu")
    assert [t.device.type for t in placed] == ["cpu", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.place_batch(batch, "cuda")


def test_prefetch_sample_identity():
    src = _sources()["classification"]
    plain = pipeline.MicrobatchedStream(src, microbatch=4, accum_steps=2)
    with pipeline.PrefetchingStream(
            pipeline.MicrobatchedStream(src, microbatch=4, accum_steps=2),
            place=lambda b: pipeline.place_batch(b, "cpu")) as pre:
        assert (pre.microbatch, pre.accum_steps, pre.data_parallel,
                pre.global_batch) == (4, 2, 1, 8)
        for _ in range(6):
            _assert_same(next(plain), next(pre))
        # the producer runs ahead of the consumer, never behind
        assert pre.position >= plain.position


@pytest.mark.parametrize("retarget", ["accum", "data_parallel"])
@pytest.mark.parametrize("at", [0, 1, 5])
def test_prefetch_switch_at_step_n_is_sample_identical(retarget, at):
    src = _sources()["lm"]
    plain = pipeline.MicrobatchedStream(src, microbatch=2, accum_steps=1)
    pre = pipeline.PrefetchingStream(
        pipeline.MicrobatchedStream(src, microbatch=2, accum_steps=1),
        size=3)
    try:
        for i in range(10):
            if i == at:
                for s in (plain, pre):
                    if retarget == "accum":
                        s.set_accum_steps(4)
                    else:
                        s.set_data_parallel(2)
            if i == 8:      # a no-op retarget drains nothing
                pre.set_accum_steps(pre.accum_steps)
                plain.set_accum_steps(1)
                pre.set_accum_steps(1)
            _assert_same(next(plain), next(pre))
    finally:
        pre.close()


def test_prefetch_finite_stream_and_errors():
    with pipeline.PrefetchingStream(iter(range(3))) as pre:
        assert list(pre) == [0, 1, 2]
        with pytest.raises(StopIteration):
            next(pre)

    def boom():
        yield 1
        raise RuntimeError("producer died")

    pre = pipeline.PrefetchingStream(boom(), size=1)
    assert next(pre) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        next(pre)
    pre.close()
    with pytest.raises(ValueError, match="size"):
        pipeline.PrefetchingStream(iter(()), size=0)
    # retargeting rewinds the wrapped stream: it needs a sample position

    class Unpositioned:
        microbatch, accum_steps = 1, 1

        def __next__(self):
            return torch.zeros(1)

        def set_accum_steps(self, k):
            self.accum_steps = k

    pre = pipeline.PrefetchingStream(Unpositioned(), size=2)
    try:
        next(pre)
        deadline = time.monotonic() + 30
        while len(pre._buf) < 2 and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert len(pre._buf) == 2
        with pytest.raises(RuntimeError, match="position"):
            pre.set_accum_steps(2)
    finally:
        pre.close()


def test_prefetch_retarget_stress():
    """Many retargets against a producer that is always refilling, with
    a short switch interval: the batches stay those of the plain
    stream."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        plain = pipeline.MicrobatchedStream(_arange_source, microbatch=3)
        pre = pipeline.PrefetchingStream(
            pipeline.MicrobatchedStream(_arange_source, microbatch=3),
            size=4)
        ks = [1, 2, 5, 3, 1, 4]
        try:
            for i in range(300):
                if i % 7 == 3:
                    k = ks[(i // 7) % len(ks)]
                    plain.set_accum_steps(k)
                    pre.set_accum_steps(k)
                assert torch.equal(next(plain), next(pre)), i
        finally:
            pre.close()
        assert not pre._thread.is_alive()
    finally:
        sys.setswitchinterval(old)


def test_prefetch_retarget_waits_for_a_pull_in_flight():
    """A batch the producer has pulled reaches the buffer before a
    retarget can drain it: the pull lock is held until the append (the
    reference releases it first, so a retarget landing in between keeps
    a batch of the old shape, ROADMAP F12)."""
    gate = threading.Semaphore(0)

    def gated(start, count):
        gate.acquire()
        return _arange_source(start, count)

    plain = pipeline.MicrobatchedStream(_arange_source, microbatch=3)
    pre = pipeline.PrefetchingStream(
        pipeline.MicrobatchedStream(gated, microbatch=3), size=2)
    try:
        gate.release()
        assert torch.equal(next(plain), next(pre))
        with pre._cv:                   # the next pull cannot be appended
            gate.release()
            deadline = time.monotonic() + 10.0
            while pre.position < 6 and time.monotonic() < deadline:
                time.sleep(0.001)
            assert pre.position == 6    # pulled, waiting to append
            free = pre._plock.acquire(timeout=0.2)
            if free:
                pre._plock.release()
        assert not free
        for _ in range(8):
            gate.release()
        plain.set_accum_steps(4)
        pre.set_accum_steps(4)
        for _ in range(3):
            assert torch.equal(next(plain), next(pre))
    finally:
        for _ in range(8):
            gate.release()
        pre.close()
    assert not pre._thread.is_alive()


def _indexed_varlen(max_seq, seed=0):
    base = synthetic.lm_varlen_sample_source(max_seq, 11, seed=seed,
                                             min_seq=2, device="cpu")

    def source(start, count):
        b = dict(base(start, count))
        b["idx"] = torch.arange(start, start + count)
        return b

    return source


def test_bucketed_stream_covers_every_sample_once():
    bounds = (4, 8, 16)
    bs = pipeline.LengthBucketedStream(_indexed_varlen(16), microbatch=4,
                                       boundaries=bounds, lookahead=3)
    seen = []
    for _ in range(15):
        b = next(bs)
        width = b["tokens"].shape[1]
        assert width in bounds and b["labels"].shape[1] == width
        assert (b["length"] <= width).all()
        seen.extend(b["idx"].tolist())
    assert len(seen) == len(set(seen)) == 60
    assert bs.position == 60 + bs.queued()


def test_bucketed_stream_deterministic_and_validates():
    def mk():
        return pipeline.LengthBucketedStream(_indexed_varlen(16), 4,
                                             boundaries=(4, 8, 16))
    a, b = mk(), mk()
    for _ in range(5):
        _assert_same(next(a), next(b))
    with pytest.raises(ValueError, match="boundaries"):
        pipeline.LengthBucketedStream(_indexed_varlen(8), 4, boundaries=())
    with pytest.raises(ValueError, match="boundaries"):
        pipeline.LengthBucketedStream(_indexed_varlen(8), 4,
                                      boundaries=(4, 4))
    with pytest.raises(ValueError, match="microbatch"):
        pipeline.LengthBucketedStream(_indexed_varlen(8), 0,
                                      boundaries=(8,))
    with pytest.raises(ValueError, match="lookahead"):
        pipeline.LengthBucketedStream(_indexed_varlen(8), 2,
                                      boundaries=(8,), lookahead=0)


def _from_reference(jsource):
    """The reference source's output as torch tensors (numpy bits)."""
    def source(start, count):
        out = jsource(start, count)
        conv = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
        if isinstance(out, dict):
            return {k: conv(v) for k, v in out.items()}
        return tuple(conv(v) for v in out)
    return source


def _np_leaves(batch):
    if isinstance(batch, dict):
        return [np.asarray(batch[k]) for k in sorted(batch)]
    return [np.asarray(x) for x in batch]


@pytest.mark.parametrize("kind", ["classification", "lm"])
def test_microbatched_stream_matches_reference_on_its_samples(kind):
    if kind == "classification":
        jsrc = jsynthetic.classification_sample_source(
            jsynthetic.ClassificationData(num_classes=4, image_size=8,
                                          seed=0), seed=5)
    else:
        jsrc = jsynthetic.lm_sample_source(seq_len=8, vocab=32, seed=1)
    ref = jpipeline.MicrobatchedStream(jsrc, microbatch=2, accum_steps=1)
    port = pipeline.MicrobatchedStream(_from_reference(jsrc), microbatch=2,
                                       accum_steps=1)
    for k, d in [(1, 1), (3, 1), (3, 1), (2, 2), (1, 1)]:
        for s in (ref, port):
            s.set_accum_steps(k)
            s.set_data_parallel(d)
        want, got = _np_leaves(next(ref)), _np_leaves(next(port))
        for a, b in zip(want, got):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ref.position == port.position


def test_bucketed_stream_matches_reference_on_its_samples():
    jsrc = jsynthetic.lm_varlen_sample_source(16, vocab=11, seed=4,
                                              min_seq=2)
    ref = jpipeline.LengthBucketedStream(jsrc, 3, boundaries=(4, 8, 16),
                                         lookahead=2)
    port = pipeline.LengthBucketedStream(_from_reference(jsrc), 3,
                                         boundaries=(4, 8, 16),
                                         lookahead=2)
    for _ in range(8):
        want, got = next(ref), next(port)
        assert sorted(want) == sorted(got)
        for k in want:
            a, b = np.asarray(want[k]), got[k].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)
    assert ref.position == port.position and ref.queued() == port.queued()

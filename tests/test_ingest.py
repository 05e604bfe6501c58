"""Overlapped ingest (runtime/ingest.py): correctness + ordering."""

import numpy as np
import pytest

import jax.numpy as jnp

from radiocore_tpu.runtime.ingest import IngestPipe, ThreadedIngest, stage_chunk


RNG = np.random.default_rng(5)


def _chunks(n, size):
    return [(RNG.standard_normal(size) + 1j * RNG.standard_normal(size))
            .astype(np.complex64) for _ in range(n)]


def test_stage_chunk_roundtrip():
    arr = _chunks(1, 4096)[0]
    dev = stage_chunk(arr)
    assert dev.dtype == jnp.complex64
    np.testing.assert_array_equal(np.asarray(dev), arr)


def test_stage_chunk_non_c64_input():
    arr = (np.arange(64) + 1j * np.arange(64)).astype(np.complex128)
    dev = stage_chunk(arr)
    np.testing.assert_array_equal(np.asarray(dev),
                                  arr.astype(np.complex64))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipe_preserves_order_and_values(depth):
    chunks = _chunks(7, 1024)
    out = list(IngestPipe(depth=depth).stream(chunks))
    assert len(out) == len(chunks)
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_pipe_prefetches_ahead():
    """With depth=2 the pipe must have staged chunk k+1 before yielding
    chunk k (the overlap property)."""
    staged = []

    class Recorder:
        def __init__(self, arrs):
            self._arrs = arrs

        def __iter__(self):
            for i, a in enumerate(self._arrs):
                staged.append(i)
                yield a

    chunks = _chunks(4, 256)
    pipe = IngestPipe(depth=2)
    consumed = []
    for k, dev in enumerate(pipe.stream(iter(Recorder(chunks)))):
        consumed.append(k)
        # When chunk k is yielded, chunk k+1 has already been pulled
        # from the source (its H2D was issued).
        assert len(staged) >= min(k + 2, len(chunks))


def test_threaded_ingest_roundtrip():
    chunks = _chunks(5, 512)
    ti = ThreadedIngest(depth=2, maxsize=8)  # 5 puts + close fit
    for c in chunks:
        ti.put(c)
    ti.close()
    out = [np.asarray(x) for x in ti]
    assert len(out) == 5
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got, want)


def test_threaded_ingest_producer_reuses_buffer():
    """ThreadedIngest.put copies: a producer that mutates its staging
    buffer immediately after put() (before the consumer thread ever
    stages the chunk) must not corrupt the enqueued data — staging
    happens later, on the consumer side, at depth >= 2."""
    chunks = _chunks(4, 512)
    ti = ThreadedIngest(depth=2, maxsize=8)
    buf = np.empty(512, np.complex64)
    for c in chunks:
        buf[:] = c
        ti.put(buf)          # producer reuses ONE buffer for every chunk
        buf[:] = -1.0        # mutate before the consumer drains anything
    ti.close()
    out = [np.asarray(x) for x in ti]
    assert len(out) == len(chunks)
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got, want)


def test_mutated_host_buffer_isolation():
    """The producer may reuse its staging buffer after the consumer has
    consumed the chunk (the receive_fm pattern: depth+1 buffers)."""
    buf = _chunks(1, 2048)[0]
    first = buf.copy()
    pipe = IngestPipe(depth=1)  # sync: chunk consumed before reuse

    def gen():
        yield buf
        buf[:] = 0  # simulate ring overwrite AFTER the yield returned
        yield buf

    out = [np.asarray(x) for x in pipe.stream(gen())]
    np.testing.assert_array_equal(out[0], first)
    np.testing.assert_array_equal(out[1], np.zeros_like(first))

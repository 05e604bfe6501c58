"""Overlapped host→device IQ ingest (double-buffered staging).

The reference overlaps SDR reads with GPU compute through cuSignal's
pinned/managed shared memory (reference ``radiocore/tools/buffer.py:
42-44``); the producer thread lands samples in memory the GPU can read
directly. The JAX equivalent of that double buffering is async
dispatch: ``jax.device_put`` and jitted calls enqueue and return
immediately, so issuing chunk N+1's H2D copy *before* consuming chunk
N's result overlaps the DMA with N's compute. The ``interleaved f32 →
complex64`` unpack runs on the device.

:class:`IngestPipe` wraps any iterator of host complex64 chunks and
yields device complex64 chunks one transfer ahead.  IQ bytes cross the
boundary exactly once, as raw float32 pairs (no host-side re-pack: a
``complex64`` numpy array IS interleaved float32 — we transfer a view).
"""

from __future__ import annotations

import threading
import queue as _queue
from typing import Iterable, Iterator, Optional

import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def _unpack(planes: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(planes[..., 0], planes[..., 1])


def stage_chunk(arr: np.ndarray) -> jnp.ndarray:
    """Start an async H2D transfer of a host complex64 chunk; returns the
    (lazy) device complex64 array."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.complex64:
        arr = arr.astype(np.complex64)
    planes = arr.view(np.float32).reshape(arr.shape + (2,))
    return _unpack(jax.device_put(planes))  # async: enqueues the DMA


class IngestPipe:
    """Double-buffered device ingest over an iterator of host chunks.

    ``depth`` chunks are kept in flight: chunk N+1's H2D DMA is issued
    before chunk N is yielded to the consumer, so the transfer engine
    runs concurrently with the consumer's compute. ``depth=1`` reproduces
    the synchronous behavior (for A/B measurement).
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = depth

    def stream(self, host_chunks: Iterable[np.ndarray]
               ) -> Iterator[jnp.ndarray]:
        # Callers that recycle staging buffers must keep >= depth+1 of
        # them (receive_fm does): ``jax.device_put`` may still be reading
        # a host buffer until its chunk has been consumed.
        pending: list[jnp.ndarray] = []
        for arr in host_chunks:
            pending.append(stage_chunk(arr))
            if len(pending) >= self.depth:
                yield pending.pop(0)
        while pending:
            yield pending.pop(0)


class ThreadedIngest:
    """IngestPipe fed from a producer thread (the ``receive_fm`` shape).

    The producer calls :meth:`put` with host chunks (e.g. straight out of
    a RingBuffer); the consumer iterates. Staging happens on the
    *consumer* side (JAX dispatch is not thread-safe-free; keeping all
    device interaction on one thread avoids cross-thread dispatch), but
    the handoff queue plus ``depth`` in-flight transfers still overlap
    producer IO, H2D DMA, and compute.
    """

    _DONE = object()

    def __init__(self, depth: int = 2, maxsize: int = 4):
        self._q: _queue.Queue = _queue.Queue(maxsize=maxsize)
        self._pipe = IngestPipe(depth=depth)

    def put(self, arr: np.ndarray, timeout: Optional[float] = None) -> None:
        """Enqueue one host chunk. The chunk is COPIED here: staging
        happens later on the consumer thread, so without the copy a
        producer that recycles its buffer (the RingBuffer shape) could
        mutate a chunk before its H2D transfer is even issued."""
        self._q.put(np.array(arr, copy=True), timeout=timeout)

    def close(self) -> None:
        """Signal end-of-stream; the consumer iterator then drains and stops."""
        self._q.put(self._DONE)

    def __iter__(self) -> Iterator[jnp.ndarray]:
        def host_iter():
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                yield item
        return self._pipe.stream(host_iter())

"""Fixed-size staging buffer (host or device resident).

Parity surface with reference ``radiocore/tools/buffer.py:10-93``
(``data``, ``consume()``, ``size``, ``dtype``, ``is_locked``), with the
CUDA managed-memory option replaced by an optional device-resident
``jax.Array`` (``device=True``) for pre-staged device buffers.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Union

import numpy as np
import jax
import jax.numpy as jnp


class Buffer:
    def __init__(self, size: Union[int, float], dtype: str = "complex64",
                 lock: bool = False, device: bool = False,
                 cuda: bool = False):
        # ``cuda`` kept for reference signature parity; ``device`` is the
        # Device-resident analog of the reference's cuSignal shared memory
        # (reference: buffer.py:42-44).
        self._size = int(size)
        self._dtype = np.dtype(dtype)
        self._device = bool(device or cuda)
        self._mtx = threading.Lock() if lock else None

        if self._device:
            self._array = jnp.zeros(self._size, dtype=self._dtype)
        else:
            self._array = np.zeros(self._size, dtype=self._dtype)

    @property
    def dtype(self):
        """Element dtype."""
        return self._array.dtype

    @property
    def size(self) -> int:
        """Element count."""
        return self._size

    def __len__(self) -> int:
        return self._size

    @property
    def is_device(self) -> bool:
        """True when the storage is a device array."""
        return self._device

    @property
    def is_cuda(self) -> bool:  # parity alias
        return self._device

    @property
    def is_locked(self) -> bool:
        """Reference API alias (reference Buffer.is_cuda): device-resident?"""
        """True while a consume() view is outstanding."""
        if self._mtx is None:
            raise ValueError("locking is not enabled in this instance")
        return self._mtx.locked()

    @property
    def data(self):
        return self._array

    @data.setter
    def data(self, value):
        # Device arrays are immutable; replacing wholesale is the JAX idiom.
        self._array = value

    @contextmanager
    def consume(self):
        """Yield a writable array; writes persist after the context exits.

        Host buffers yield the raw ndarray (the reference contract,
        reference: ``tests/test_buffer.py:8-30``). Device buffers yield a
        host-backed staging COPY — a ``jax.Array`` is immutable, so
        in-place writes against it would be silently dropped — and
        upload it back on exit. For pure reads of a device buffer use
        ``.data`` directly (no staging round-trip).
        """
        if self._mtx is not None:
            with self._mtx:
                yield from self._consume_inner()
        else:
            yield from self._consume_inner()

    def _consume_inner(self):
        if not self._device:
            yield self._array
            return
        staging = np.array(self._array)  # owning copy: always writable
        yield staging
        self._array = jnp.asarray(staging)

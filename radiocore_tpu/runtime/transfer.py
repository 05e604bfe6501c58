"""Host↔device conversion helpers for the reference-parity model classes.

The reference's device boundary is CuPy's ``asarray``/``asnumpy``
(reference ``radiocore/analog/fm.py:60,69-70``); these are the JAX
equivalents with the dtype each model expects. The streaming apps move
IQ through :mod:`radiocore_tpu.runtime.ingest` instead.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def to_device_c64(x) -> jax.Array:
    """Put ``x`` on the device as complex64."""
    if isinstance(x, jax.Array):
        return x.astype(jnp.complex64)
    return jax.device_put(np.asarray(x, dtype=np.complex64))


def to_device_f32(x) -> jax.Array:
    """Put a real array on the device as float32."""
    if isinstance(x, jax.Array):
        return x.astype(jnp.float32)
    return jax.device_put(np.asarray(x, dtype=np.float32))


def to_host(x) -> np.ndarray:
    """Fetch ``x`` to a host NumPy array (waits for the device)."""
    return np.asarray(x)

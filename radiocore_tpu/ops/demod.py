"""Quadrature (FM) demodulation.

The reference computes ``angle → unwrap → diff → pad((1,0)) → /π``
(reference: ``radiocore/analog/fm.py:60-65``). The device form avoids
the sequential ``unwrap`` entirely: the wrapped phase difference of
consecutive samples is ``angle(x[n] · conj(x[n-1]))``, which equals
``diff(unwrap(angle(x)))`` exactly (both land in (-π, π]) and is a pure
elementwise expression XLA fuses into one pass.
"""

from __future__ import annotations

import jax.numpy as jnp


def quadrature_demod(iq: jnp.ndarray, gain: float | None = None) -> jnp.ndarray:
    """Demodulate FM from complex baseband along the last axis.

    Output has the same length as the input: the first sample is 0,
    matching the reference's ``pad((1, 0))``
    (reference: ``radiocore/analog/fm.py:63``). Default gain is ``1/π``
    (reference: ``radiocore/analog/fm.py:64``).
    """
    d = iq[..., 1:] * jnp.conj(iq[..., :-1])
    ph = jnp.angle(d)
    if gain is None:
        gain = 1.0 / jnp.pi
    ph = ph * gain
    pad = [(0, 0)] * (ph.ndim - 1) + [(1, 0)]
    return jnp.pad(ph, pad)

"""FFTs along the last axis: native XLA FFT, plus the four-step
Cooley–Tukey decomposition as an explicit building block.

On the GPU XLA lowers ``jnp.fft`` to cuFFT, which plans any length
natively (radix 2, 3, 5, 7 and Bluestein for the rest), including the
reference's canonical station rate 250 000 = 2⁴·5⁶
(reference: ``examples/receive_fm.py:12-21``); the CPU's pocketfft does
the same. On an H100 native cuFFT also beat the decomposition at every
band size measured, 2^24 to 2^26 and 3·2^23 (PERF.md). So :func:`fft`,
:func:`ifft`, :func:`rfft` and :func:`irfft` are the native transforms.

The four-step algorithm — ``N = N1·N2``; reshape to (N1, N2); FFT the
columns (length N1); multiply the twiddles ``W_N^{k1·j}``; FFT the rows
(length N2); transpose — stays for two users:

* :func:`fft_decomposed`, one explicit level of it (the transpose-based
  distributed FFT of ``parallel/fft_sharded.py`` has the same shape,
  SURVEY.md §2.5);
* ``set_policy("fourstep")``, which routes every transform above
  ``_SMALL_NATIVE`` through the recursive decomposition so tests and
  ``benchmarks/fft_probe.py`` can check and time it against native.

All functions operate along the last axis with arbitrary leading batch
dims, matching the rest of :mod:`radiocore_tpu.ops`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

# Sub-transforms at or below this length stay native under the
# 'fourstep' policy (the recursion's leaves).
_SMALL_NATIVE = 8192

_policy = "native"  # "native" | "fourstep"


def set_policy(policy: str) -> None:
    """Route transforms: 'native' (default) or 'fourstep' (recursive
    four-step decomposition down to ``_SMALL_NATIVE``-point leaves)."""
    global _policy
    if policy not in ("native", "fourstep"):
        raise ValueError(policy)
    _policy = policy
    _plan.cache_clear()


def _prime_factors(n: int) -> List[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _split(n: int) -> Tuple[int, int]:
    """Split n = a·b with a ≤ b as balanced as the factorization allows."""
    factors = sorted(_prime_factors(n), reverse=True)
    a = 1
    for f in factors:
        if a * f <= int(np.sqrt(n)) + 1:
            a *= f
    if a == 1:  # all factors huge (near-prime): take the smallest factor
        a = factors[-1]
    return a, n // a


@functools.lru_cache(maxsize=256)
def _plan(n: int) -> Optional[Tuple[int, int]]:
    """None → native; (N1, N2) → four-step split (members planned recursively)."""
    if _policy == "native" or n <= _SMALL_NATIVE:
        return None
    n1, n2 = _split(n)
    if n1 == 1 or n2 == 1:
        raise ValueError(
            f"FFT size {n} is prime: the four-step decomposition needs "
            f"a composite size")
    return n1, n2


def _twiddles(n1: int, n2: int, sign: float) -> np.ndarray:
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    j = np.arange(n2, dtype=np.float64)[None, :]
    return np.exp(sign * 2j * np.pi * k1 * j / (n1 * n2)).astype(np.complex64)


# Twiddle matrices above this element count are computed ON DEVICE at
# run time (iota → cos/sin, fused by XLA into the multiply — never
# materialized in device memory); smaller ones stay host-NumPy constants
# baked into the HLO (exact float64 phases). A baked literal of a large
# split is as big as the signal (256 MB for 2^25 points): it bloats the
# program, its compile time and its memory, and reads as many bytes as
# the multiply it feeds. On-device precision is fine: the f32 outer
# product k1·j errs by ≤ ~ε·n, and the phase is 2π·(k1·j)/n, so the
# phase error is ≤ ~2πε ≈ 4e-7 rad independent of n.
_TWIDDLE_DEVICE_MIN = 1 << 20


def _apply_twiddle(z: jnp.ndarray, n1: int, n2: int,
                   sign: float) -> jnp.ndarray:
    if n1 * n2 < _TWIDDLE_DEVICE_MIN:
        return z * jnp.asarray(_twiddles(n1, n2, sign))
    k1 = jax.lax.iota(jnp.float32, n1)
    j = jax.lax.iota(jnp.float32, n2)
    ang = (sign * 2.0 * np.pi / (n1 * n2)) * (k1[:, None] * j[None, :])
    return z * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))


def _fft_rec(x: jnp.ndarray, sign: float) -> jnp.ndarray:
    """Unnormalized DFT (sign=-1 forward, +1 backward) along the last axis."""
    n = x.shape[-1]
    plan = _plan(n)
    if plan is None:
        return jnp.fft.fft(x, axis=-1) if sign < 0 else (
            jnp.fft.ifft(x, axis=-1) * n)
    n1, n2 = plan
    lead = x.shape[:-1]
    a = x.reshape(lead + (n1, n2))
    # Length-n1 FFT along the column axis: move it last for the recursion.
    z = _fft_rec(jnp.moveaxis(a, -2, -1), sign)          # (..., n2, n1)
    z = jnp.moveaxis(z, -1, -2)                          # (..., n1, n2)
    z = _apply_twiddle(z, n1, n2, sign)
    xm = _fft_rec(z, sign)                               # (..., n1, n2) rows
    # Output index k = k1 + n1·k2 → transpose so k2 is the outer axis.
    return jnp.swapaxes(xm, -1, -2).reshape(lead + (n,))


def fft(x: jnp.ndarray) -> jnp.ndarray:
    """Forward FFT along the last axis (planned)."""
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        x = x.astype(jnp.complex64)
    return _fft_rec(x, -1.0)


def fft_decomposed(x: jnp.ndarray, sign: float = -1.0) -> jnp.ndarray:
    """One four-step level with planner-routed sub-FFTs, whatever the
    policy (unnormalized; sign=-1 forward)."""
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        x = x.astype(jnp.complex64)
    n = x.shape[-1]
    n1, n2 = _split(n)
    if n1 == 1 or n2 == 1:
        return _fft_rec(x, sign)
    lead = x.shape[:-1]
    a = x.reshape(lead + (n1, n2))
    z = _fft_rec(jnp.moveaxis(a, -2, -1), sign)          # (..., n2, n1)
    z = jnp.moveaxis(z, -1, -2)
    z = _apply_twiddle(z, n1, n2, sign)
    xm = _fft_rec(z, sign)
    return jnp.swapaxes(xm, -1, -2).reshape(lead + (n,))


def ifft_decomposed(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse counterpart of :func:`fft_decomposed` (normalized)."""
    return fft_decomposed(x, +1.0) / x.shape[-1]


def ifft(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse FFT along the last axis (planned, normalized)."""
    x = jnp.asarray(x)
    return _fft_rec(x, +1.0) / x.shape[-1]


def rfft(x: jnp.ndarray) -> jnp.ndarray:
    """Real-input FFT along the last axis → n//2+1 bins (planned).

    Native path uses the backend's rfft; the decomposed path computes the
    full complex FFT and slices.
    """
    n = x.shape[-1]
    if _plan(n) is None:
        return jnp.fft.rfft(x, axis=-1)
    return fft(x)[..., :n // 2 + 1]


def irfft(X: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse real FFT along the last axis to length ``n`` (planned)."""
    X = jnp.asarray(X)
    n = int(n)
    if _plan(n) is None:
        return jnp.fft.irfft(X, n=n, axis=-1)
    # Rebuild the Hermitian spectrum; clamp DC/Nyquist imag parts like irfft.
    m = X.shape[-1]
    need = n // 2 + 1
    if m < need:
        pad = [(0, 0)] * (X.ndim - 1) + [(0, need - m)]
        X = jnp.pad(X, pad)
    else:
        X = X[..., :need]
    X = X.at[..., 0].set(jnp.real(X[..., 0]).astype(X.dtype))
    if n % 2 == 0:
        X = X.at[..., -1].set(jnp.real(X[..., -1]).astype(X.dtype))
        mid = X[..., 1:-1]
    else:
        mid = X[..., 1:]
    full = jnp.concatenate([X, jnp.conj(mid[..., ::-1])], axis=-1)
    return jnp.real(ifft(full))

"""Batched channel extraction from a full-band spectrum.

Core of the Tuner / fused pipeline: for channel c with spectrum roll
``s_c``, scipy's ``resample(roll(X, s_c)·W, m, domain='freq')`` keeps the
bins around DC of the rolled spectrum — which form ONE contiguous
(wrapping) run of the *unrolled* spectrum. So extraction needs no
large gather: each channel is a static contiguous slice of
``concat([X, X[:run]])``, reordered and windowed, followed by one batched
IFFT. Static slices compile to contiguous copies that XLA fuses with
the window multiply; a gather would read the band in scattered order.

Shift/window/Nyquist-fold semantics exactly match
``resample_spectrum(roll(X, s)·W, m)`` — asserted by tests.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from radiocore_tpu.ops import design
from radiocore_tpu.ops import fft as _fft


def extraction_plan(n: int, shifts: Sequence[int], bandwidth: int):
    """Host-side constants: slice starts, window vector, fix weight."""
    m = int(bandwidth)
    m2 = m // 2 + 1
    win = np.fft.fftshift(design.window("hann", n))

    neg = m - m2                       # number of negative-frequency bins
    run = m + (1 if m % 2 == 0 else 0)  # extra leading fix bin when even
    # Rolled-bin positions covered by the run, in slice order.
    if m % 2 == 0:
        rolled = np.concatenate([[n - m // 2],
                                 np.arange(n - neg, n), np.arange(m2)])
    else:
        rolled = np.concatenate([np.arange(n - neg, n), np.arange(m2)])
    starts = [int((rolled[0] - s) % n) for s in shifts]

    # Window sampled at rolled positions, in OUTPUT order [pos, neg].
    w_out = np.concatenate([win[:m2], win[n - neg:]]).astype(np.float32)
    w_fix = np.float32(win[n - m // 2]) if m % 2 == 0 else None
    return starts, w_out, w_fix, m2, run


@functools.lru_cache(maxsize=32)
def make_extractor(n: int, shifts: Tuple[int, ...],
                   bandwidth: int) -> Callable:
    """Jit-compatible ``spectrum (n,) → channels (C, bandwidth)`` fn.

    Two lowerings: when the channel plan tiles the band uniformly with
    spacing == bandwidth (the critical multi-FM layout), ALL channels'
    runs are one rolled spectrum reshaped ``(C, m)`` — two static slices
    and a reshape. Otherwise, one static slice per channel.
    """
    m = int(bandwidth)
    c = len(shifts)
    starts, w_out, w_fix, m2, run = extraction_plan(n, shifts, m)
    neg = m - m2
    s_fac = n / m
    # Host NumPy constant: XLA embeds it in the program.
    w_j = w_out

    uniform = (c > 1 and n >= c * m
               and all((starts[i] - starts[0]) % n == (i * m) % n
                       for i in range(c)))

    def finish(y_all: jnp.ndarray) -> jnp.ndarray:
        # Barrier pins a canonical layout: without it the SPMD partitioner
        # may hand the CPU FFT runtime a non-dim0-major layout (RET_CHECK).
        y_all = jax.lax.optimization_barrier(y_all)
        return _fft.ifft(y_all / s_fac)

    def extract_uniform(spectrum: jnp.ndarray) -> jnp.ndarray:
        a0 = starts[0]
        need = c * m + 1
        base = jnp.concatenate(
            [spectrum[..., a0:], spectrum[..., :a0],
             spectrum[..., a0:a0 + 1]], axis=-1)[..., :need]
        rows = base[..., :c * m].reshape(spectrum.shape[:-1] + (c, m))
        # Element ``m`` of each run is the next row's first element.
        nxt = jnp.concatenate([rows[..., 1:, :1], base[..., None, -1:]],
                              axis=-2)                     # (..., C, 1)
        if m % 2 == 0:
            pos = jnp.concatenate([rows[..., m // 2:], nxt], axis=-1)
            y = jnp.concatenate([pos, rows[..., 1:m // 2]], axis=-1) * w_j
            y = y.at[..., m2 - 1].add(rows[..., 0] * w_fix)
        else:
            pos = jnp.concatenate([rows[..., neg:], nxt], axis=-1)[..., :m2]
            y = jnp.concatenate([pos, rows[..., :neg]], axis=-1) * w_j
        return finish(y)

    def extract_slices(spectrum: jnp.ndarray) -> jnp.ndarray:
        ext = jnp.concatenate([spectrum, spectrum[..., :run]], axis=-1)
        rows = []
        for a0 in starts:
            sl = ext[..., a0:a0 + run]
            if m % 2 == 0:
                y = jnp.concatenate([sl[..., m // 2:], sl[..., 1:m // 2]],
                                    axis=-1) * w_j
                y = y.at[..., m2 - 1].add(sl[..., 0] * w_fix)
            else:
                y = jnp.concatenate([sl[..., neg:], sl[..., :neg]],
                                    axis=-1) * w_j
            rows.append(y)
        return finish(jnp.stack(rows, axis=-2))

    return extract_uniform if uniform else extract_slices

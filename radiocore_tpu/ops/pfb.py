"""Critically-sampled polyphase filterbank (PFB) analysis channelizer.

The reference's Tuner channelizes with a full-band FFT + per-channel
spectrum resample (reference: ``radiocore/tools/tuner.py:137-161``) —
O(N·log N) on the whole band every second plus a gather per channel. The
PFB is the classic radio-astronomy/SDR alternative (PAPERS.md [1][2]):
a length ``M·P`` prototype lowpass folded into ``M`` branches, a
depthwise branch convolution, and an M-point FFT per output frame —
O(N·(P + log M)) for ALL M channels at once, uniform spacing ``fs/M``.

Device mapping: the branch convolution is P shifted multiply-adds over
the frame matrix (one fused pass), the per-frame FFT is a batched
length-M FFT.
Streaming state is the trailing ``(P−1)·M`` input samples.

Convention: channel k is centered at ``k·fs/M`` (wrapping negatives),
output sample rate ``fs/M`` per channel, unit passband gain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from scipy import signal as _sig

from radiocore_tpu.ops import fft as _fft


def pfb_taps(n_channels: int, taps_per_branch: int = 8,
             cutoff_scale: float = 1.0, window: str = "hamming") -> np.ndarray:
    """Prototype lowpass for an M-channel PFB (length ``M·P``), unit DC gain."""
    m, p = int(n_channels), int(taps_per_branch)
    h = _sig.firwin(m * p, cutoff_scale / m, window=window)
    return (h / h.sum()).astype(np.float64)


def pfb_init(n_channels: int, taps_per_branch: int = 8,
             batch_shape: Tuple[int, ...] = (),
             dtype=jnp.complex64) -> jnp.ndarray:
    """Initial streaming history: the ``(P−1)·M`` samples before the chunk."""
    m, p = int(n_channels), int(taps_per_branch)
    return jnp.zeros(batch_shape + ((p - 1) * m,), dtype=dtype)


def _branch_conv(z: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Depthwise conv over frames: z (..., S, M), kernels (M, P) →
    (..., S−P+1, M); out[t, m] = Σ_q z[t+q, m]·kernels[m, q].

    Lowering: P statically-unrolled shifted multiply-adds. Each tap is
    an elementwise op over the frame matrix — XLA fuses the chain into
    one pass, in full f32 (no matrix-unit contraction, so no reduced-
    precision input rounding), and the whole conv stays bound by memory
    bandwidth. A grouped ``lax.conv`` would need HIGHEST precision for
    the same accuracy."""
    p = kernels.shape[-1]
    t_out = z.shape[-2] - p + 1
    kern = jnp.asarray(kernels)
    if jnp.iscomplexobj(z):
        kern = kern.astype(jnp.real(z).dtype)
    else:
        kern = kern.astype(z.dtype)
    acc = z[..., 0:t_out, :] * kern[:, 0]
    for q in range(1, p):
        acc = acc + z[..., q:q + t_out, :] * kern[:, q]
    return acc


def pfb_channelize(x: jnp.ndarray, taps: np.ndarray, n_channels: int,
                   history: Optional[jnp.ndarray] = None
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Channelize ``x`` (..., N) into ``(..., N/M, M)`` + new history.

    Causal streaming form: frame t of channel k is
    ``Σ_m e^{-2πi·m·k/M} Σ_p h[p·M+m]·x[(t−p)·M+m]`` with ``x`` read
    through the carried history. Chunks stitch seamlessly.
    """
    m = int(n_channels)
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % m:
        raise ValueError("taps length must be a multiple of n_channels")
    p = len(taps) // m
    n = x.shape[-1]
    if n % m:
        raise ValueError(f"chunk ({n}) must divide by n_channels ({m})")

    if history is None:
        history = pfb_init(m, p, x.shape[:-1], x.dtype)
    xh = jnp.concatenate([history.astype(x.dtype), x], axis=-1)
    new_history = xh[..., -(p - 1) * m:] if p > 1 else xh[..., :0]

    z = xh.reshape(x.shape[:-1] + (-1, m))                # (..., T+P−1, M)
    # Branch kernels: reversed-in-p taps per branch (correlation form).
    # The elementwise lowering handles complex frames directly (real
    # taps broadcast over I/Q) — no plane split needed.
    kernels = np.ascontiguousarray(
        np.asarray(taps).reshape(p, m).T[:, ::-1], dtype=np.float32)
    y = _branch_conv(z, jnp.asarray(kernels)).astype(x.dtype)

    # M-point DFT over the branch axis picks channel centers k·fs/M
    # (unit passband gain: taps are normalized to Σh = 1).
    channels = _fft.fft(y)
    return channels, new_history

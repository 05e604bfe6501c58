"""Device-resident signal synthesis and audio measurement.

Everything here runs inside jit on the accelerator: stereo-multiplex FM
IQ generation and tone-SNR measurement, so a check can run with only
scalars crossing to the host (SURVEY.md §3.1's device-boundary
discipline).

The signal convention mirrors the host-side float64 oracles in
``tests/oracles.py`` (which themselves encode the modulation the
reference demodulator inverts, reference: ``radiocore/analog/wbfm.py:
66-105``): multiplex = (L+R)/2 + pilot·sin(2π·19k·t) −
sin(2π·38k·t)·(L−R)·w, IQ = exp(jπ·gain·Σ multiplex).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp


_PHASE_BLOCK = 4096


def _sin_tone(n: int, f: float, fs: float, k0: int = 0) -> jnp.ndarray:
    """``sin(2π·f·k/fs)`` for k = k0..k0+n−1, precise in float32.

    Naive ``sin(2π·f·t)`` in float32 drifts ~1e-2 rad by t = 1 s at FM
    pilot frequencies. Instead the fractional phase ``frac(k·f/fs)`` is
    computed with split arithmetic: k = B·q + r with the per-block
    fractional increment ``frac(B·f/fs)`` precomputed on host in float64,
    so every on-device product stays small enough for float32.
    """
    b = _PHASE_BLOCK
    x1 = float(np.mod(np.float64(f) / fs, 1.0))
    xb = float(np.mod(np.float64(f) * b / fs, 1.0))
    k = jnp.arange(k0, k0 + n, dtype=jnp.int32)
    q = (k // b).astype(jnp.float32)
    r = (k % b).astype(jnp.float32)
    frac = jnp.mod(jnp.mod(q * xb, 1.0) + jnp.mod(r * x1, 1.0), 1.0)
    return jnp.sin(2 * jnp.pi * frac)


def stereo_multiplex(n: int, fs: float, f_left: float, f_right: float,
                     pilot_amp: float = 0.1, audio_amp: float = 0.3,
                     compensate_window: bool = True,
                     k0: int = 0) -> jnp.ndarray:
    """Broadcast-FM stereo multiplex message signal (trace-time shapes).

    ``k0`` is the starting sample index (chunk streaming continuation).
    """
    left = audio_amp * _sin_tone(n, f_left, fs, k0)
    right = audio_amp * _sin_tone(n, f_right, fs, k0)
    pilot = pilot_amp * _sin_tone(n, 19e3, fs, k0)
    sub = -_sin_tone(n, 38e3, fs, k0)
    sub_gain = 1.0
    if compensate_window:
        sub_gain = 1.0 / (0.54 + 0.46 * np.cos(2 * np.pi * 38e3 / fs))
    mpx = (left + right) / 2 + pilot + sub * (left - right) * sub_gain
    return mpx.astype(jnp.float32)


def fm_modulate(message: jnp.ndarray, deviation_gain: float = 0.25,
                phase0: jnp.ndarray | float = 0.0
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FM-modulate a real message onto complex baseband, carrying phase.

    Returns ``(iq complex64, end_phase)`` so chunked streams stay
    phase-continuous across calls.
    """
    phase = phase0 + jnp.pi * deviation_gain * jnp.cumsum(
        message.astype(jnp.float32))
    iq = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return iq.astype(jnp.complex64), phase[-1]


@functools.partial(jax.jit, static_argnames=(
    "n", "fs", "f_left", "f_right", "deviation_gain"))
def stereo_fm_iq(n: int, fs: float, f_left: float, f_right: float,
                 deviation_gain: float = 0.25) -> jnp.ndarray:
    """One jitted call: device-resident stereo FM IQ test signal."""
    mpx = stereo_multiplex(n, fs, f_left, f_right)
    iq, _ = fm_modulate(mpx, deviation_gain)
    return iq


def tone_snr_db(x: jnp.ndarray, fs: float, f_tone: float,
                guard_bins: int = 3, n_fft: int = 32768,
                skip: int = 2048) -> jnp.ndarray:
    """Tone-bin power vs everything else, in dB — computed on device.

    Device analog of ``tests/oracles.tone_snr_db``: takes an
    ``n_fft``-sample window (power-of-two)
    starting at ``skip`` (clear of filter transients), Hann-windowed.
    Returns a scalar device array; only this scalar crosses to the host.
    """
    seg = jax.lax.slice_in_dim(x, skip, skip + n_fft, axis=0)
    win = jnp.asarray(np.hanning(n_fft).astype(np.float32))
    spec = jnp.abs(jnp.fft.rfft(seg.astype(jnp.float32) * win)) ** 2
    bin_f = int(round(f_tone * n_fft / fs))
    lo = max(bin_f - guard_bins, 0)
    hi = bin_f + guard_bins + 1
    sig_p = jnp.sum(jax.lax.slice_in_dim(spec, lo, hi, axis=0))
    noise_p = jnp.sum(spec) - sig_p
    return 10.0 * jnp.log10(sig_p / jnp.maximum(noise_p, 1e-30))

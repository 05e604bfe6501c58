"""Analytic signal (Hilbert transform) and pilot-tone harmonic synthesis.

Device core of the reference's ``PLL``, which is not a feedback loop
but an analytic-signal phase tracker: raise ``hilbert(pilot)`` to an
integer power to multiply its instantaneous phase — regenerating the
38 kHz stereo subcarrier from the 19 kHz pilot at unit amplitude
(reference: ``radiocore/analog/pll.py:25-58``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from radiocore_tpu.ops import design
from radiocore_tpu.ops import fft as _fft


def analytic_signal(x: jnp.ndarray) -> jnp.ndarray:
    """Analytic signal along the last axis: FFT, zero negative freqs, IFFT.

    Matches ``scipy.signal.hilbert``
    (reference: ``radiocore/analog/pll.py:34``). Input must be real.
    """
    n = x.shape[-1]
    h = jnp.asarray(design.hilbert_multiplier(n), dtype=x.dtype)
    X = _fft.fft(x)
    return _fft.ifft(X * h)


def pll_harmonic(analytic: jnp.ndarray, mult: int = 1,
                 part: str = "imag") -> jnp.ndarray:
    """Unit-amplitude harmonic of an analytic signal's instantaneous phase.

    ``part='real'`` → ``Re(aᵐ)/|aᵐ|``; ``part='imag'`` → ``Im(aᵐ)/|aᵐ|``
    (reference: ``radiocore/analog/pll.py:36-58``). For integer ``mult``
    the power lowers to repeated multiplication (``lax.integer_pow``).
    """
    a = analytic ** mult
    mag = jnp.abs(a)
    comp = jnp.real(a) if part == "real" else jnp.imag(a)
    return comp / mag

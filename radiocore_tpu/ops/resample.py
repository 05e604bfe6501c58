"""FFT-domain arbitrary-ratio resampling (the Fourier method).

Device core of the reference's ``Decimate`` and ``Tuner`` back-ends,
which call ``scipy.signal.resample`` / ``cusignal.resample``
(reference: ``radiocore/analog/decimate.py:47-48``,
``radiocore/tools/tuner.py:160-161``). Semantics replicate scipy's
spectrum fold exactly — including the unpaired-Nyquist-bin handling and
the one-sided window folding on the real path — so the NumPy/SciPy
reference path doubles as the numerical oracle (SURVEY.md §4).

Everything is a pure function of statically-shaped inputs: output length
and the spectral window are Python/NumPy constants baked in at trace
time, so XLA sees fixed FFT plans.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from radiocore_tpu.ops import fft as _fft


def _fold_window_onesided(win: np.ndarray, n_rfft: int) -> np.ndarray:
    """Fold a full-length spectral window onto one-sided rfft bins.

    ``W1[l] = (W[l] + W[-l]) / 2`` for ``l > 0`` — scipy's treatment so a
    real signal and its complex cast produce identical results.
    """
    w = np.asarray(win, dtype=np.float64).copy()
    w1 = w[:n_rfft].copy()
    tail = w[-(n_rfft - 1):][::-1]  # W[-l] for l = 1..n_rfft-1
    w1[1:] = (w1[1:] + tail) / 2.0
    return w1


def resample_fft(x: jnp.ndarray, num: int,
                 window: Optional[np.ndarray] = None) -> jnp.ndarray:
    """Resample ``x`` to ``num`` samples along the last axis.

    Matches ``scipy.signal.resample(x, num, window=window, axis=-1)`` for
    real and complex inputs. ``window``, if given, is a length-``n`` host
    NumPy array applied directly to the (unshifted) spectrum — the
    reference always passes ``fftshift(get_window(...))``
    (reference: ``radiocore/analog/decimate.py:32-33``).

    Supports arbitrary leading batch dimensions.
    """
    n_x = x.shape[-1]
    num = int(num)
    s_fac = n_x / num

    if jnp.iscomplexobj(x):
        X = _fft.fft(x)
        if window is not None:
            X = X * jnp.asarray(np.asarray(window), dtype=X.real.dtype)
        return resample_spectrum(X, num)

    # Real path: one-sided FFT with folded window (scipy rfft branch).
    X = _fft.rfft(x)
    n_rfft = n_x // 2 + 1
    if window is not None:
        w1 = _fold_window_onesided(window, n_rfft)
        X = X * jnp.asarray(w1, dtype=X.real.dtype)
    m = min(num, n_x)
    m2 = m // 2 + 1
    X = X[..., :m2]
    if m % 2 == 0 and num != n_x:
        # Unpaired bin at m//2: doubled when downsampling (bin pair folds
        # into one), halved when upsampling (one bin splits into a pair).
        X = X.at[..., m // 2].multiply(2.0 if num < n_x else 0.5)
    return _fft.irfft(X / s_fac, n=num)


def resample_spectrum(X: jnp.ndarray, num: int) -> jnp.ndarray:
    """Resample given an already-computed two-sided spectrum (domain='freq').

    The ``Tuner`` path: one full-band FFT is shared by all channels and
    each channel extracts its slice here
    (reference: ``radiocore/tools/tuner.py:160-161`` with
    ``resample(..., domain="freq")``).
    """
    X = jnp.asarray(X)
    n_x = X.shape[-1]
    num = int(num)
    s_fac = n_x / num
    m = min(num, n_x)
    m2 = m // 2 + 1

    if num == n_x:
        Y = X
    elif num < n_x:
        # Downsampling: keep m2 positive bins and m-m2 negative bins.
        pos = X[..., :m2]
        if m % 2 == 0:
            # Unpaired bin: unite the ±m/2 pair into one bin.
            pos = pos.at[..., -1].add(X[..., n_x - m // 2])
        neg = X[..., n_x - (m - m2):]
        Y = jnp.concatenate([pos, neg], axis=-1)
    else:
        # Upsampling: zero-pad the middle, split unpaired bin when m even.
        pos = X[..., :m2]
        neg = X[..., n_x - (m - m2):] if m > m2 else X[..., :0]
        if m % 2 == 0:
            pos = pos.at[..., -1].multiply(0.5)
            mid = jnp.zeros(X.shape[:-1] + (num - m - 1,), dtype=X.dtype)
            mirrored = pos[..., -1:]  # bin at num - m//2
            Y = jnp.concatenate([pos, mid, mirrored, neg], axis=-1)
        else:
            mid = jnp.zeros(X.shape[:-1] + (num - m,), dtype=X.dtype)
            Y = jnp.concatenate([pos, mid, neg], axis=-1)

    return _fft.ifft(Y / s_fac)

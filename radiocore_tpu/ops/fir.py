"""FIR filtering primitives: causal, zero-phase, and streaming-stateful.

Replacement for the reference's cuSignal/scipy ``lfilter`` and
``filtfilt`` calls (reference: ``radiocore/analog/bandpass.py:72``,
``radiocore/analog/deemphasis.py:64``). Two lowerings of the same math:
a direct ``lax.conv_general_dilated`` and an FFT overlap-save form.

All functions support arbitrary leading batch dimensions and operate on
the last axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


# Overlap-save block length (samples of output per FFT block).
_OS_BLOCK = 1 << 15


def _as_taps(taps, dtype) -> jnp.ndarray:
    t = jnp.asarray(np.asarray(taps)) if isinstance(taps, np.ndarray) else jnp.asarray(taps)
    return t.astype(dtype)


def _corr_valid(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Valid-mode cross-correlation along the last axis.

    ``out[..., n] = Σ_k x[..., n+k] · kernel[k]`` — the native orientation
    of the XLA conv op (no kernel flip).
    """
    if jnp.iscomplexobj(x):
        # XLA conv is real-valued: filter I and Q independently (taps real).
        kr = jnp.real(kernel).astype(jnp.real(x).dtype)
        return (_corr_valid(jnp.real(x), kr)
                + 1j * _corr_valid(jnp.imag(x), kr)).astype(x.dtype)
    lead = x.shape[:-1]
    xb = x.reshape((-1, 1, x.shape[-1]))
    k = kernel.reshape((1, 1, -1)).astype(x.dtype)
    # HIGHEST: at DEFAULT precision an f32 conv may run in TF32 on the
    # GPU's tensor cores, which keeps ~3 decimal digits (~1e-3 relative
    # FIR error against a float64 oracle). The radio's fidelity bounds
    # need full f32.
    y = jax.lax.conv_general_dilated(
        xb, k, window_strides=(1,), padding="VALID",
        precision=jax.lax.Precision.HIGHEST)
    return y.reshape(lead + (y.shape[-1],))


def fir_causal(x: jnp.ndarray, taps,
               history: Optional[jnp.ndarray] = None,
               impl: str = "auto") -> jnp.ndarray:
    """Causal FIR: ``y[n] = Σ_k b[k]·x[n-k]`` with explicit input history.

    ``history`` supplies the ``num_taps-1`` samples "before" ``x`` (the
    streaming state); defaults to zeros — identical to
    ``scipy.signal.lfilter(b, 1, x)`` with zero initial conditions.

    ``impl``: 'conv' (XLA conv), 'fft' (overlap-save FFT form,
    :func:`fir_overlap_save`), or 'auto': 'fft' once the signal fills
    one overlap-save block and the taps are host constants, else 'conv'.
    On an H100 the overlap-save form took 1.50 ms against the conv's
    5.39 ms for 129 taps on (2, 2^24) f32, and 0.200 against 0.231 ms
    for 51 taps on (64, 49 152) (device time, benchmarks/fft_micro.py);
    below one block it would pad every signal to a whole block.
    """
    if impl not in ("auto", "conv", "fft"):
        raise ValueError(f"unknown FIR impl {impl!r}")
    if impl == "auto":
        long = x.shape[-1] >= _OS_BLOCK >= np.shape(taps)[0]
        host_taps = isinstance(taps, (np.ndarray, list, tuple))
        impl = "fft" if long and host_taps else "conv"
    if impl == "fft":
        return fir_overlap_save(x, taps, history=history)
    taps = _as_taps(taps, x.dtype)
    t = taps.shape[0]
    if history is None:
        history = jnp.zeros(x.shape[:-1] + (t - 1,), dtype=x.dtype)
    xp = jnp.concatenate([history.astype(x.dtype), x], axis=-1)
    return _corr_valid(xp, taps[::-1])


def fir_stream(x: jnp.ndarray, taps,
               history: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming causal FIR: returns ``(y, new_history)``.

    Equivalent to ``scipy.signal.lfilter(b, 1, x, zi=state)`` where the
    carried state is the raw trailing input samples — the mechanism behind
    the reference's stateful de-emphasis across 1-second chunks
    (reference: ``radiocore/analog/deemphasis.py:64``).

    Routes through :func:`fir_causal`'s impl=auto.
    """
    t = int(np.shape(taps)[0])
    y = fir_causal(x, taps, history=history)
    if t - 1 <= x.shape[-1]:
        new_history = x[..., x.shape[-1] - (t - 1):]
    else:
        new_history = jnp.concatenate(
            [history.astype(x.dtype), x], axis=-1)[..., -(t - 1):]
    return y, new_history


def fir_overlap_save(x: jnp.ndarray, taps,
                     history: Optional[jnp.ndarray] = None,
                     block: int = _OS_BLOCK) -> jnp.ndarray:
    """Causal FIR via FFT overlap-save (for very long signals/wideband).

    Identical output to :func:`fir_causal`; cost is O(N·log(block))
    independent of tap count — the right regime for the wideband
    configs (BASELINE.md config 4: 61.44 MS/s overlap-save FIR). Blocks
    of ``block`` samples are filtered with an FFT of ``block + 2^k ≥
    block + T - 1`` using a precomputed tap spectrum; the carried
    ``history`` works exactly like :func:`fir_stream`'s.
    """
    taps_np = np.asarray(taps, dtype=np.float64)
    t = len(taps_np)
    n = x.shape[-1]
    block = int(block)
    if block < t:
        raise ValueError(f"block ({block}) must be >= num_taps ({t})")
    nfft = 1
    while nfft < block + t - 1:
        nfft *= 2
    h_spec = np.fft.rfft(taps_np, nfft)

    if history is None:
        history = jnp.zeros(x.shape[:-1] + (t - 1,), dtype=x.dtype)
    xp = jnp.concatenate([history.astype(x.dtype), x], axis=-1)

    n_blocks = -(-n // block)
    # Pad so the body reshape AND the final block's (t-1)-tail both exist.
    pad = n_blocks * block + (t - 1) - (xp.shape[-1])
    xp = jnp.pad(xp, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    # Overlapping segments, segment b = xp[b·block : b·block+block+t-1],
    # built from ONE reshape + small concats (a python-unrolled
    # stack-of-slices lowers to hundreds of copies — measured 120 ms at
    # 8.4M samples where this form is ~2 ms).
    body = xp[..., :n_blocks * block].reshape(
        xp.shape[:-1] + (n_blocks, block))              # (..., B, block)
    tail_last = xp[..., n_blocks * block:
                   n_blocks * block + t - 1]            # final (t-1) tail
    tails = jnp.concatenate(
        [body[..., 1:, :t - 1], tail_last[..., None, :]], axis=-2)
    segs = jnp.concatenate([body, tails], axis=-1)      # (..., B, block+t-1)

    from radiocore_tpu.ops import fft as _fft
    pad_f = [(0, 0)] * (segs.ndim - 1) + [(0, nfft - segs.shape[-1])]
    segs = jnp.pad(segs, pad_f)
    if jnp.iscomplexobj(x):
        hs = np.fft.fft(taps_np, nfft).astype(np.complex64)
        y = _fft.ifft(_fft.fft(segs) * hs).astype(x.dtype)
    else:
        hs = h_spec.astype(np.complex64)
        y = _fft.irfft(_fft.rfft(segs) * hs, n=nfft).astype(x.dtype)
    # Valid region of each block: samples t-1 .. t-1+block-1.
    y = y[..., t - 1:t - 1 + block]
    y = y.reshape(x.shape[:-1] + (n_blocks * block,))
    return y[..., :n]


def zero_phase_fir(x: jnp.ndarray, taps,
                   padlen: Optional[int] = None) -> jnp.ndarray:
    """Zero-phase FIR (forward-backward), matching ``scipy.signal.filtfilt``.

    Replicates scipy's default edge handling — odd extension of
    ``3·num_taps`` samples and steady-state initial conditions seeded from
    the first extended sample (for an FIR, that state is exactly a
    constant input history) — so it is numerically interchangeable with
    the reference's pilot-tone bandpass
    (reference: ``radiocore/analog/bandpass.py:72``).
    """
    t = int(np.shape(taps)[0])
    n = x.shape[-1]
    if padlen is None:
        padlen = 3 * t
    if padlen >= n:
        raise ValueError(f"padlen ({padlen}) must be less than signal length ({n})")

    left = 2.0 * x[..., :1] - x[..., 1:padlen + 1][..., ::-1]
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1:-1][..., ::-1]
    ext = jnp.concatenate([left, x, right], axis=-1)

    edge0 = jnp.repeat(ext[..., :1], t - 1, axis=-1)
    fwd = fir_causal(ext, taps, history=edge0)

    rev = fwd[..., ::-1]
    edge1 = jnp.repeat(rev[..., :1], t - 1, axis=-1)
    bwd = fir_causal(rev, taps, history=edge1)[..., ::-1]

    return bwd[..., padlen:padlen + n]

"""WBFM stereo broadcast-FM demodulator — the flagship model.

Pipeline (matching reference ``radiocore/analog/wbfm.py:66-105``):

1. quadrature demod at full rate, spectrally windowed (the reference's
   internal ``FM(input_size, input_size)`` still applies the hamming
   spectral window through its no-op-size resample,
   reference: ``wbfm.py:42-43`` + ``fm.py:66``);
2. 19 kHz pilot extraction: 41-tap zero-phase bandpass
   (reference: ``wbfm.py:45-46``);
3. 38 kHz subcarrier regeneration: analytic-signal squared
   (reference: ``wbfm.py:80-83``, empirical stereo gain 1.0175);
4. stereo matrix L = comp + (L−R), R = comp − (L−R), FFT-decimated to the
   audio rate (decimation doubles as the 15 kHz lowpass,
   reference: ``wbfm.py:86-87``);
5. per-channel streaming de-emphasis (reference: ``wbfm.py:90-91``);
6. stack, remove global DC, clip ±0.999 (reference: ``wbfm.py:94-100``).

Design: the whole pipeline is one pure function of
``(iq_chunk, state)`` with static shapes — one XLA program, freely
vmap-able over a station axis. Output shape is ``(output_size, 2)``
(the reference returns numpy ``dstack`` shape ``(1, output_size, 2)``;
bytes are identical when serialized — conscious cleanup, SURVEY.md §7.4).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from radiocore_tpu.runtime.transfer import to_device_c64, to_host

from radiocore_tpu.ops import design
from radiocore_tpu.ops.resample import resample_fft
from radiocore_tpu.ops.fir import zero_phase_fir
from radiocore_tpu.ops.demod import quadrature_demod
from radiocore_tpu.ops.analytic import analytic_signal, pll_harmonic
from radiocore_tpu.ops.deemphasis import deemphasis_init, deemphasis_apply
from radiocore_tpu.ops.nco_pll import (pll_design, pll_init, nco_pll_track,
                                       pll_subcarrier)

State = Dict[str, jnp.ndarray]

STEREO_GAIN = 1.0175   # empirical L−R gain (reference: wbfm.py:83)
CLIP = 0.999
PILOT_TAPS = 41        # (reference: wbfm.py:45-46)
PILOT_LO = 19e3 - 50
PILOT_HI = 19e3 + 50


def wbfm_init_state(output_size: int, rate: float = 75e-6,
                    batch_shape: Tuple[int, ...] = (),
                    pll: str = "analytic") -> State:
    """Initial state pytree (per station when batched): de-emphasis
    histories, plus the NCO loop state when ``pll='nco'``."""
    _, hist = deemphasis_init(output_size, rate, batch_shape=batch_shape)
    state = {"deemph_l": hist, "deemph_r": hist}
    if pll == "nco":
        state["pll"] = pll_init(batch_shape)
    return state


def make_wbfm_step(input_size: int, output_size: int,
                   deemphasis: float = 75e-6, mode: str = "exact",
                   pll: str = "analytic", pll_loop_bw: float = 50.0
                   ) -> Callable[[jnp.ndarray, State], Tuple[jnp.ndarray, State]]:
    """Build the pure WBFM step function for static chunk sizes.

    Returned step maps ``(iq (..., input_size) c64, state) →
    (audio (..., output_size, 2) f32, state)``; leading batch dims are the
    station axis.

    ``mode='exact'`` reproduces the reference stage-for-stage (golden
    tests assert >40 dB match). ``mode='fast'`` computes the same
    pipeline in the envelope domain: the composite spectrum from the
    demod resample feeds static slices (zero-phase pilot bandpass as
    |B(ω)|² in frequency; comp's analytic part around 38 kHz), the
    L−R channel is ``Im(U·conj(V))`` of the two envelopes — the 38 kHz
    carriers cancel — at a pow2 rate n2 ≪ n, and the stereo matrix is
    decimated by truncated-spectrum linearity. One full-length
    transform per chunk (the composite rfft) instead of four. Differs
    from the reference only in FIR edge handling (circular vs
    odd-extension) and slice truncation at the -80 dB level — measured
    84-96 dB match to exact, far inside the 1 dB SNR acceptance bound
    (BASELINE.md); asserted by test.
    """
    input_size, output_size = int(input_size), int(output_size)
    if pll not in ("analytic", "nco"):
        raise ValueError(f"unknown pll {pll!r}; 'analytic' or 'nco'")
    if pll == "nco" and mode != "exact":
        raise ValueError("pll='nco' requires mode='exact' (fast mode has "
                         "no explicit pilot time series)")
    win = design.resample_window("hamm", input_size)
    bp_taps = design.bandpass_taps(PILOT_TAPS, PILOT_LO, PILOT_HI, input_size)
    de_taps, _ = deemphasis_init(output_size, deemphasis)
    nco_gains = pll_design(input_size, 19e3, pll_loop_bw)

    def step_exact(iq: jnp.ndarray, state: State) -> Tuple[jnp.ndarray, State]:
        comp = quadrature_demod(iq)
        comp = resample_fft(comp, input_size, win)  # spectral hamming lowpass

        pilot = zero_phase_fir(comp, bp_taps)
        extra = {}
        if pll == "nco":
            # True feedback carrier tracking (accuracy mode): the loop
            # bandwidth rejects pilot-band noise the analytic path
            # passes straight into the subcarrier phase
            # (reference semantics anchor: radiocore/analog/pll.py:25-58;
            # the NCO is the promised accuracy upgrade, SURVEY §2.4).
            rms = jnp.sqrt(jnp.mean(pilot * pilot, axis=-1, keepdims=True))
            norm = pilot / jnp.maximum(rms, jnp.finfo(jnp.float32).tiny)
            traj, pll_state = nco_pll_track(norm, nco_gains, state["pll"])
            subcarrier = pll_subcarrier(traj, 2, "imag")
            extra["pll"] = pll_state
        else:
            subcarrier = pll_harmonic(analytic_signal(pilot), 2, "imag")
        lmr = subcarrier * comp * STEREO_GAIN

        left = resample_fft(comp + lmr, output_size, win)
        right = resample_fft(comp - lmr, output_size, win)
        return _finish(left, right, state, extra)

    # ---- fast mode constants (host-side) --------------------------------
    n = input_size
    n_rfft = n // 2 + 1
    # One-sided folded resample window (scipy rfft-branch semantics).
    from radiocore_tpu.ops.resample import _fold_window_onesided
    w1 = _fold_window_onesided(win, n_rfft)
    # Zero-phase pilot bandpass as |B(ω)|² at the one-sided bins.
    b2 = np.abs(np.fft.rfft(bp_taps, n)) ** 2
    # Analytic-signal weights on one-sided bins: 1 at DC/Nyquist, 2 else.
    h_half = np.full(n_rfft, 2.0)
    h_half[0] = 1.0
    if n % 2 == 0:
        h_half[-1] = 1.0
    pilot_weights = (w1 * b2 * h_half).astype(np.float32)

    m = output_size
    m2 = m // 2 + 1
    s_fac = n / m

    # ---- envelope-domain L−R path (fast mode) -----------------------------
    # Two observations collapse the stereo difference channel to
    # narrowband envelope arithmetic:
    #
    # 1. The 41-tap pilot bandpass can't be narrower than its Hamming
    #    mainlobe (half-width ≈ 2·fs/41 Hz), so |B(ω)|² — the whole
    #    analytic-signal integrand — is supported on a slice around the
    #    19 kHz bin (one-second convention: bin == Hz).
    # 2. The decimated stereo legs only keep spectrum below the audio
    #    Nyquist (m2 bins), so of the mixing product subcarrier·comp
    #    only comp's content within 38 kHz ± audio-Nyquist matters:
    #    LP(Im(W)·comp) = Im(U·conj(V)) exactly, where W = U·e^{j2π·38k·t}
    #    is the unit subcarrier and V the analytic envelope of comp
    #    around 38 kHz — and the 38 kHz carriers CANCEL. Both envelopes
    #    live at a small rate n2 (pow2), so the L−R channel never
    #    touches the full rate: per-station full-length transforms drop
    #    to ONE (the composite rfft).
    p0 = int(round(19e3))
    hw = int(2 * n / PILOT_TAPS) + 1500   # pilot mainlobe half-width
    s0, s1 = p0 - hw, p0 + hw             # pilot slice
    hw2 = m2 + 1024                       # audio Nyquist + margin
    s2, e2 = 2 * p0 - hw2, 2 * p0 + hw2   # comp-around-38 kHz slice
    n2 = 1
    # pow2 envelope rate: ≥4·hw (squared pilot alias headroom), ≥2·hw2
    # (lmr content), and small enough to be worth it.
    while n2 < max(4 * hw, 2 * hw2):
        n2 *= 2
    use_env = (0 < s0 and s1 < n_rfft and 0 < s2 and e2 <= n_rfft
               and n2 <= n)
    if use_env:
        pw_slice = pilot_weights[s0:s1]
        wc_slice = w1[s2:e2].astype(np.float32)   # no h: one-sided P as-is
        # Residual envelope rotations — pilot² ref 2·s0 and comp ref s2,
        # both retuned to 38 kHz — combine into one static phasor; the
        # 38 kHz carriers themselves cancel in U·conj(V).
        phasor = np.exp(2j * np.pi * (hw2 - 2 * hw)
                        * np.arange(n2) / n2).astype(np.complex64)

    def _lmr_env(q_spec: jnp.ndarray) -> jnp.ndarray:
        """w1-weighted L−R at the envelope rate n2 (real, (..., n2))."""
        from radiocore_tpu.ops import fft as _fft

        def pad(z):
            return jnp.concatenate(
                [z, jnp.zeros(z.shape[:-1] + (n2 - z.shape[-1],), z.dtype)],
                axis=-1)

        zp = q_spec[..., s0:s1] * jnp.asarray(pw_slice)
        zc = q_spec[..., s2:e2] * jnp.asarray(wc_slice)
        env = _fft.ifft(jnp.stack([pad(zp), pad(zc)], axis=-2))
        a, v = env[..., 0, :], env[..., 1, :]
        u = a * a
        # Epsilon guard: a dead/squelched channel (zero pilot band) gives
        # |u| = 0; exact mode would emit NaN audio there, here the
        # subcarrier just goes to zero (strictly better failure mode).
        u = u / jnp.maximum(jnp.abs(u), jnp.finfo(jnp.float32).tiny)
        return jnp.imag(u * jnp.conj(v) * jnp.asarray(phasor)) * STEREO_GAIN

    def _decimate_trunc(spec_trunc: jnp.ndarray) -> jnp.ndarray:
        """Decimate from already-truncated spectrum (..., m2): window,
        Nyquist fix, irfft — the final resample of the stereo matrix."""
        from radiocore_tpu.ops import fft as _fft
        x = spec_trunc * jnp.asarray(w1[:m2], dtype=jnp.float32)
        if m % 2 == 0 and m != n:
            x = x.at[..., m // 2].multiply(2.0)
        return _fft.irfft(x / s_fac, n=m)

    def step_fast(iq: jnp.ndarray, state: State) -> Tuple[jnp.ndarray, State]:
        from radiocore_tpu.ops import fft as _fft
        quad = quadrature_demod(iq)
        q_spec = _fft.rfft(quad)                       # the ONE big rfft
        return step_fast_spec(q_spec, state)

    def step_fast_spec(q_spec: jnp.ndarray, state: State
                       ) -> Tuple[jnp.ndarray, State]:
        """Fast-mode tail from the composite (quad) rfft spectrum
        (``mode='fast_spec'``: benchmarks/demod_profile.py times it)."""
        from radiocore_tpu.ops import fft as _fft
        if use_env:
            lmr_t = _lmr_env(q_spec)                   # rate-n2 envelopes
            lmr_trunc = _fft.rfft(lmr_t)[..., :m2]     # scales cancel: see
            # LMR_n[k] = (n/n2)·LMR_n2[k] and V_true = V_raw·(n2/n).
            comp_trunc = q_spec[..., :m2] * jnp.asarray(
                w1[:m2], dtype=jnp.float32)
        else:
            # Legacy spectrum-reuse path (tiny chunk sizes where the
            # 38 kHz slice would exceed Nyquist).
            c_spec = q_spec * jnp.asarray(w1, dtype=jnp.float32)
            comp = _fft.irfft(c_spec, n=n)
            z = jnp.concatenate(
                [c_spec * jnp.asarray(pilot_weights),
                 jnp.zeros(c_spec.shape[:-1] + (n - n_rfft,), c_spec.dtype)],
                axis=-1)
            analytic = _fft.ifft(z)
            subcarrier = pll_harmonic(analytic, 2, "imag")
            lmr = subcarrier * comp * STEREO_GAIN
            lmr_trunc = _fft.rfft(lmr)[..., :m2]
            comp_trunc = c_spec[..., :m2]

        # One batched irfft for both stereo legs (stacked on a new axis).
        lr = _decimate_trunc(jnp.stack([comp_trunc + lmr_trunc,
                                        comp_trunc - lmr_trunc], axis=-2))
        return _finish(lr[..., 0, :], lr[..., 1, :], state)

    def _finish(left, right, state, extra=None):
        l, hist_l = deemphasis_apply(left, de_taps, state["deemph_l"])
        r, hist_r = deemphasis_apply(right, de_taps, state["deemph_r"])
        audio = jnp.stack([l, r], axis=-1)
        audio = audio - jnp.mean(audio, axis=(-2, -1), keepdims=True)
        audio = jnp.clip(audio, -CLIP, CLIP)
        new_state = {"deemph_l": hist_l, "deemph_r": hist_r}
        if extra:
            new_state.update(extra)
        return audio.astype(jnp.float32), new_state

    if mode == "exact":
        return step_exact
    if mode == "fast":
        return step_fast
    if mode == "fast_spec":
        return step_fast_spec
    raise ValueError(f"unknown mode {mode!r}")


class WBFM:
    """Stateful WBFM wrapper with the reference's ``run`` API.

    Parity surface: ``run(input_sig, numpy_output=True)`` and
    ``channels == 2`` (reference: ``radiocore/analog/wbfm.py:61-105``).
    """

    def __init__(self, input_size: Union[int, float],
                 output_size: Union[int, float],
                 deemphasis: float = 75e-6, cuda: bool = False,
                 mode: str = "exact", pll: str = "analytic"):
        # ``cuda`` accepted for signature parity; dispatch is XLA's job.
        del cuda
        self._input_size = int(input_size)
        self._output_size = int(output_size)
        self._step = jax.jit(
            make_wbfm_step(self._input_size, self._output_size, deemphasis,
                           mode=mode, pll=pll))
        self._state = wbfm_init_state(self._output_size, deemphasis, pll=pll)

    @property
    def channels(self) -> int:
        """Audio channel count (2: stereo)."""
        return 2

    def run(self, input_sig, numpy_output: bool = True):
        """Demodulate one chunk to stereo audio, carrying state across
                calls (reference WBFM.run parity)."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        iq = to_device_c64(input_sig)
        audio, self._state = self._step(iq, self._state)
        return to_host(audio) if numpy_output else audio

"""NumPy/SciPy oracle implementations of the reference DSP math.

Written clean-room from the recipes in SURVEY.md §2.1 (the reference is
GPL — no code copied): these re-state the published math (quadrature
demod, FFT resample, filtfilt bandpass, analytic-signal PLL, streaming
de-emphasis) using public scipy APIs in float64, and serve as the
numerical ground truth for the f32 device path (SURVEY.md §4:
"CPU-path-as-reference-oracle").
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sig


def fm_demod(iq: np.ndarray) -> np.ndarray:
    """angle → unwrap → diff → pad((1,0)) → /π (reference fm.py:60-65)."""
    ph = np.unwrap(np.angle(iq))
    return np.pad(np.diff(ph), (1, 0)) / np.pi


def decimate(x: np.ndarray, output_size: int) -> np.ndarray:
    """FFT resample with fftshift'd hamming window (reference decimate.py:32-48)."""
    win = np.fft.fftshift(sig.get_window("hamm", len(x)))
    return sig.resample(x, int(output_size), window=win)


def deemphasis_taps(input_size: int, rate: float) -> np.ndarray:
    """IIR→51-tap FIR via dlti/dimpulse (reference deemphasis.py:36-43)."""
    x = np.exp(-1 / (int(input_size) * rate))
    system = sig.dlti([1 - x], [1, -x])
    _, h = sig.dimpulse(system, n=51)
    return np.squeeze(h)


def deemphasis_stream(x: np.ndarray, taps: np.ndarray, zi: np.ndarray):
    """Stateful lfilter step (reference deemphasis.py:64)."""
    return sig.lfilter(taps, 1.0, x, zi=zi)


def bandpass_taps(num_taps: int, lo_hz: float, hi_hz: float,
                  input_size: int) -> np.ndarray:
    nyq = 0.5 * input_size
    return sig.firwin(num_taps, [lo_hz / nyq, hi_hz / nyq],
                      pass_zero=False, window="hamm")


def wbfm(iq: np.ndarray, input_size: int, output_size: int,
         rate: float = 75e-6, state=None):
    """Full stereo pipeline oracle (reference wbfm.py:66-105).

    Returns ``(audio (output_size, 2), state)`` with the de-emphasis state
    threaded like the reference's two stateful Deemphasis instances.
    """
    de_taps = deemphasis_taps(output_size, rate)
    if state is None:
        zi = sig.lfilter_zi(de_taps, 1.0)
        state = (zi.copy(), zi.copy())
    zi_l, zi_r = state

    comp = decimate(fm_demod(iq), input_size)  # FM(in, in): windowed no-op size
    bp = bandpass_taps(41, 19e3 - 50, 19e3 + 50, input_size)
    pilot = sig.filtfilt(bp, [1.0], comp)
    analytic = sig.hilbert(pilot)
    a2 = analytic ** 2
    subcarrier = np.imag(a2) / np.abs(a2)
    lmr = subcarrier * comp * 1.0175

    left = decimate(comp + lmr, output_size)
    right = decimate(comp - lmr, output_size)
    left, zi_l = deemphasis_stream(left, de_taps, zi_l)
    right, zi_r = deemphasis_stream(right, de_taps, zi_r)

    audio = np.stack([left, right], axis=-1)
    audio -= np.mean(audio)
    audio = np.clip(audio, -0.999, 0.999)
    return audio, (zi_l, zi_r)


def mfm(iq: np.ndarray, input_size: int, output_size: int,
        rate: float = 75e-6, state=None):
    """Mono pipeline oracle (reference mfm.py:50-66)."""
    de_taps = deemphasis_taps(output_size, rate)
    if state is None:
        state = sig.lfilter_zi(de_taps, 1.0)
    audio = decimate(fm_demod(iq), output_size)
    audio, state = deemphasis_stream(audio, de_taps, state)
    audio -= np.mean(audio)
    audio = np.clip(audio, -0.999, 0.999)
    return audio, state


def make_fm_iq(message: np.ndarray, deviation_gain: float = 0.9) -> np.ndarray:
    """Frequency-modulate a real message (|message|≤1) onto complex baseband.

    The quadrature demod above inverts this exactly (up to the first
    sample): phase increments of ``π·gain·message``.
    """
    phase = np.pi * deviation_gain * np.cumsum(message)
    return np.exp(1j * phase)


def make_stereo_multiplex(n: int, fs: float, f_left: float, f_right: float,
                          pilot_amp: float = 0.1,
                          audio_amp: float = 0.3,
                          compensate_window: bool = True) -> np.ndarray:
    """Broadcast-FM stereo multiplex: (L+R)/2 + pilot + (L−R)·38 kHz DSB.

    Phase/amplitude convention chosen to be the one the reference
    demodulator inverts exactly: its analytic-signal squaring regenerates
    ``−sin(2θ)`` from a ``sin(θ)`` pilot, and its near-unit stereo gain
    (1.0175) implies a full-amplitude ``(L−R)`` DSB term
    (reference: wbfm.py:80-87). ``compensate_window`` pre-boosts the DSB
    term by the inverse of the hamming spectral window's value at 38 kHz
    (the demod chain attenuates it before the stereo matrix,
    reference: fm.py:66 + decimate.py:32-33), yielding near-perfect
    separation after demodulation.
    """
    t = np.arange(n) / fs
    left = audio_amp * np.sin(2 * np.pi * f_left * t)
    right = audio_amp * np.sin(2 * np.pi * f_right * t)
    pilot = pilot_amp * np.sin(2 * np.pi * 19e3 * t)
    sub = -np.sin(2 * np.pi * 38e3 * t)
    sub_gain = 1.0
    if compensate_window:
        sub_gain = 1.0 / (0.54 + 0.46 * np.cos(2 * np.pi * 38e3 / fs))
    return (left + right) / 2 + pilot + sub * (left - right) * sub_gain


def extract_channel(spectrum: np.ndarray, shift: int,
                    bandwidth: int) -> np.ndarray:
    """One channel out of a full-band spectrum, in float64: roll by
    ``shift`` bins, apply the fftshifted Hann window, and resample to
    ``bandwidth`` samples in the frequency domain (the Tuner's
    semantics, reference tuner.py:137-143)."""
    win = np.fft.fftshift(sig.get_window("hann", len(spectrum)))
    return sig.resample(np.roll(spectrum, shift) * win, int(bandwidth),
                        domain="freq")


def snr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """SNR of ``estimate`` against ``reference`` in dB."""
    err = estimate - reference
    return 10 * np.log10(np.sum(reference ** 2) / max(np.sum(err ** 2), 1e-30))


def tone_snr_db(x: np.ndarray, fs: float, f_tone: float,
                guard_bins: int = 3) -> float:
    """Power of the tone bin (± guard) vs everything else, in dB."""
    X = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    bin_f = int(round(f_tone * len(x) / fs))
    lo, hi = max(bin_f - guard_bins, 0), bin_f + guard_bins + 1
    sig_p = X[lo:hi].sum()
    noise_p = X.sum() - sig_p
    return 10 * np.log10(sig_p / max(noise_p, 1e-30))

"""Channelizer: one full-band FFT → per-station spectrum extraction.

API parity with reference ``radiocore/tools/tuner.py:38-174``
(``add_channel`` / ``request_bandwidth`` / ``channels`` / ``load`` /
``run`` / ``reset`` and the band recalculation rules, including padding
the band to a multiple of the mean channel bandwidth,
reference: tuner.py:163-174). Assumes the one-second-chunk convention:
Hz == array index == FFT bin (reference: tuner.py:43-44).

Batched inversion (SURVEY.md §7.1): where the reference rolls and
resamples the spectrum **sequentially per channel**
(reference: ``examples/multi_fm_server.py:100-106``), ``run_all`` extracts
every channel at once — a single precomputed gather of all channels'
spectrum bins (windowed, Nyquist-bin corrected) followed by one batched
IFFT of shape ``(n_channels, bandwidth)``. Per-channel ``run(i)`` remains
for drop-in parity and for heterogeneous channel bandwidths.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from radiocore_tpu.ops import design
from radiocore_tpu.ops import fft as _fft
from radiocore_tpu.ops.resample import resample_spectrum
from radiocore_tpu.runtime.transfer import to_device_c64


@dataclasses.dataclass
class Channel:
    """Frequency boundaries and demodulator binding of one station.

    ``address_bytes`` is the 4-byte little-endian center frequency used as
    the ZMQ PUB topic (reference: tuner.py:33-35).
    """

    index: int
    bandwidth: float
    demodulator: object
    lower_frequency: float
    center_frequency: float
    higher_frequency: float

    @property
    def address_bytes(self) -> bytes:
        return int(self.center_frequency).to_bytes(4, byteorder="little")


# ONE jit wrapper for the band FFT: a fresh ``jax.jit(_fft.fft)`` per
# 1-second chunk would defeat the dispatch fast path in the serving loop
# (the compiled program is cached, but the wrapper's signature lookup
# isn't).
_jitted_fft = jax.jit(_fft.fft)


@functools.lru_cache(maxsize=32)
def _make_extract_all(n: int, shifts: tuple, bandwidth: int) -> Callable:
    """Jitted all-channels extractor for a static band plan.

    Delegates to :func:`radiocore_tpu.ops.channelize.make_extractor`:
    every channel's kept bins form one contiguous (wrapping) run of the
    unrolled spectrum, so extraction is static slices + one batched IFFT
    — semantics identical to scipy's ``resample(..., domain='freq')``
    fold of the rolled, hann-windowed spectrum.
    """
    from radiocore_tpu.ops.channelize import make_extractor
    return jax.jit(make_extractor(n, shifts, int(bandwidth)))


class Tuner:
    def __init__(self, cuda: bool = False):
        del cuda
        self._channels: List[Channel] = []
        self._input_frequency: float = 0.0
        self._input_bandwidth: float = 0.0
        self._spectrum: Optional[jnp.ndarray] = None
        self._win_cache = {}

    # ---- band plan -------------------------------------------------------

    @property
    def input_frequency(self) -> float:
        """Center frequency the SDR should be tuned to."""
        return self._input_frequency

    @property
    def input_bandwidth(self) -> float:
        """Sample rate the SDR should run at (== band width, Hz)."""
        return self._input_bandwidth

    def channels(self) -> List[Channel]:
        """The configured Channel list (reference parity)."""
        return self._channels

    def request_bandwidth(self, bandwidth: float) -> None:
        """Override the computed bandwidth upward only (reference: tuner.py:77-94)."""
        if bandwidth < self._input_bandwidth:
            raise ValueError(
                f"requested bandwidth ({bandwidth}) is too low, "
                f"minimum is {self._input_bandwidth}")
        self._input_bandwidth = bandwidth

    def add_channel(self, frequency: float, bandwidth: float,
                    demodulator) -> None:
        """Register a station (frequency, bandwidth); recomputes the band
                plan exactly like the reference (mean-bandwidth padding)."""
        self._channels.append(Channel(
            index=len(self._channels),
            bandwidth=bandwidth,
            demodulator=demodulator,
            lower_frequency=frequency - bandwidth / 2,
            center_frequency=frequency,
            higher_frequency=frequency + bandwidth / 2,
        ))
        self._recalculate()

    def reset(self) -> None:
        """Clear all channels and the loaded band."""
        self._channels = []
        self._spectrum = None
        self._input_frequency = 0.0
        self._input_bandwidth = 0.0

    def _recalculate(self) -> None:
        """Band center/width from channel extremes, padded so the width is
        divisible by the (integer-floored) mean channel bandwidth
        (reference: tuner.py:163-174)."""
        lo = min(ch.lower_frequency for ch in self._channels)
        hi = max(ch.higher_frequency for ch in self._channels)
        self._input_frequency = (lo + hi) / 2
        self._input_bandwidth = hi - lo
        mean_bw = sum(ch.bandwidth for ch in self._channels) // len(self._channels)
        self._input_bandwidth += (-self._input_bandwidth) % mean_bw

    # ---- processing ------------------------------------------------------

    def _shift(self, channel: Channel) -> int:
        """Spectrum roll (bins == Hz under the one-second convention)."""
        return int(self._input_frequency - channel.center_frequency)

    def load(self, input_signal) -> None:
        """FFT the full-band 1-second chunk (reference: tuner.py:126-138)."""
        sig = to_device_c64(input_signal)
        self._spectrum = _jitted_fft(sig)

    def run(self, channel_index: int) -> jnp.ndarray:
        """Extract one channel's baseband IQ (parity path).

        Roll the spectrum by the frequency offset and resample to
        ``int(bandwidth)`` samples in the frequency domain with an
        fftshift'd hann window (reference: tuner.py:140-161).
        """
        if self._spectrum is None:
            raise ValueError("load() must be called before run()")
        ch = self._channels[int(channel_index)]
        n = self._spectrum.shape[-1]
        if n not in self._win_cache:
            self._win_cache[n] = jnp.asarray(
                np.fft.fftshift(design.window("hann", n)), dtype=jnp.float32)
        win = self._win_cache[n]
        rolled = jnp.roll(self._spectrum, self._shift(ch))
        return resample_spectrum(rolled * win, int(ch.bandwidth))

    def run_all(self) -> jnp.ndarray:
        """Extract ALL channels at once → ``(n_channels, bandwidth)`` c64.

        Requires homogeneous channel bandwidths (the common band-plan
        case); use ``run(i)`` otherwise.
        """
        if self._spectrum is None:
            raise ValueError("load() must be called before run_all()")
        bws = {int(ch.bandwidth) for ch in self._channels}
        if len(bws) != 1:
            raise ValueError("run_all requires equal channel bandwidths; "
                             "use run(i) for heterogeneous plans")
        n = int(self._spectrum.shape[-1])
        shifts = tuple(self._shift(ch) for ch in self._channels)
        extract = _make_extract_all(n, shifts, bws.pop())
        return extract(self._spectrum)

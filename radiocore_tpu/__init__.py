"""radiocore_tpu — a software-defined-radio DSP framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
``luigifcruz/radio-core``: broadcast-FM receive pipelines — channelizer,
FIR filters, FFT resampling, pilot PLL, and FM/MFM/WBFM stereo
demodulation — that runs on an NVIDIA GPU through XLA and cuFFT:

* all compute-path math is pure, jitted ``jax.numpy`` with static shapes,
* multi-station work is **batched** (vmap / shard_map over a station axis)
  instead of the reference's sequential per-channel loop
  (reference: ``examples/multi_fm_server.py:100-106``),
* streaming state (de-emphasis tails, FIR halos) is threaded explicitly
  through pure step functions instead of hidden attribute mutation,
* scaling is via ``jax.sharding.Mesh`` + ``shard_map`` with XLA
  collectives (``radiocore_tpu.parallel``), not host threads.

Public surface mirrors the reference package flat re-export style
(reference: ``radiocore/__init__.py:3-4``).
"""

from radiocore_tpu.runtime.platform import (device_platform, HasCuda,
                                            platform_summary)
from radiocore_tpu.models.fm import FM
from radiocore_tpu.models.mfm import MFM
from radiocore_tpu.models.wbfm import WBFM
from radiocore_tpu.models.bandpass import Bandpass
from radiocore_tpu.models.decimate import Decimate
from radiocore_tpu.models.deemphasis import Deemphasis
from radiocore_tpu.models.pll import PLL
from radiocore_tpu.tools.buffer import Buffer
from radiocore_tpu.tools.ringbuffer import RingBuffer
from radiocore_tpu.tools.carrousel import Carrousel
from radiocore_tpu.tools.chopper import Chopper
from radiocore_tpu.tools.tuner import Tuner, Channel

__version__ = "1.0.0"

__all__ = [
    "FM", "MFM", "WBFM", "Bandpass", "Decimate", "Deemphasis", "PLL",
    "Buffer", "RingBuffer", "Carrousel", "Chopper", "Tuner", "Channel",
    "device_platform", "HasCuda", "platform_summary", "__version__",
]

"""Streaming/memory tools: buffers, rings, chunkers, and the channelizer.

Layer L1 + the L3 channelizer (SURVEY.md §7.1). Host-side pieces
(RingBuffer ingest, Carrousel recycling) keep the reference's semantics
(reference: ``radiocore/tools/__init__.py:3-7``); the Tuner is re-designed
Batched: one full-band FFT, then ALL channels extracted at once via a
precomputed spectrum gather + batched IFFT.
"""

from radiocore_tpu.tools.buffer import Buffer
from radiocore_tpu.tools.ringbuffer import RingBuffer
from radiocore_tpu.tools.carrousel import Carrousel
from radiocore_tpu.tools.chopper import Chopper
from radiocore_tpu.tools.tuner import Tuner, Channel

__all__ = ["Buffer", "RingBuffer", "Carrousel", "Chopper", "Tuner", "Channel"]

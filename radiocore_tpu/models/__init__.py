"""Demodulator model family: FM, MFM, WBFM + the L2 filter classes.

Each demodulator exists in two forms:

* a **pure functional step** ``(chunk, state) → (audio, state)`` built by
  ``make_*_step`` — jit/vmap/shard_map-able, the jitted compute path;
* a thin **stateful class** with the reference's ``run(sig,
  numpy_output)`` API for drop-in parity
  (reference: ``radiocore/analog/__init__.py:3-9``).
"""

from radiocore_tpu.models.fm import FM, make_fm_step
from radiocore_tpu.models.mfm import MFM, make_mfm_step
from radiocore_tpu.models.wbfm import WBFM, make_wbfm_step, wbfm_init_state
from radiocore_tpu.models.bandpass import Bandpass
from radiocore_tpu.models.decimate import Decimate
from radiocore_tpu.models.deemphasis import Deemphasis
from radiocore_tpu.models.pll import PLL

__all__ = [
    "FM", "MFM", "WBFM", "Bandpass", "Decimate", "Deemphasis", "PLL",
    "make_fm_step", "make_mfm_step", "make_wbfm_step", "wbfm_init_state",
]

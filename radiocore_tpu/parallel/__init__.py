"""Parallelism layer: device meshes, halo exchange, sharded pipelines.

The reference has no distributed layer at all — its concurrency is three
Python threads and ZeroMQ (SURVEY.md §2.5). This package is the new
scaling design:

* **station axis** — independent FM stations shard like a batch/expert
  axis (embarrassingly parallel after the channelizer);
* **time axis** — the 1-second sample axis shards like sequence/context
  parallelism; FIR filters exchange ``num_taps−1``-sample halos between
  neighbor devices (``lax.ppermute``);
* the channelizer's full-band FFT is left to XLA's SPMD partitioner via
  sharding annotations (scaling-book recipe: annotate, let XLA insert
  collectives).
"""

from radiocore_tpu.parallel.mesh import make_radio_mesh, station_sharding
from radiocore_tpu.parallel.halo import (halo_exchange, fir_causal_sharded,
                                         zero_phase_fir_sharded)
from radiocore_tpu.parallel.pipeline import make_multi_station_step
from radiocore_tpu.parallel.fft_sharded import (fft_sharded_auto,
                                                fft_sharded_fourstep)

__all__ = [
    "make_radio_mesh", "station_sharding",
    "halo_exchange", "fir_causal_sharded", "zero_phase_fir_sharded",
    "make_multi_station_step",
    "fft_sharded_auto", "fft_sharded_fourstep",
]

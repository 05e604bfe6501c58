"""Fused multi-station pipeline: channelize + batched demod in one program.

The reference processes stations sequentially — full-band FFT, then a
per-channel Python loop of roll/resample/demod
(reference: ``examples/multi_fm_server.py:100-106``). Here the whole
second of work is ONE jitted function:

    band IQ (n_band,) ──FFT──► spectrum ──gather──► (n_stations, station_chunk)
        ──vmap(wbfm_step)──► audio (n_stations, audio_chunk, 2)

and scaling is sharding annotations on that function: the station axis
shards like a batch axis (zero steady-state collectives), the band FFT is
partitioned by XLA's SPMD pass when its input is time-sharded.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radiocore_tpu.models.wbfm import make_wbfm_step, wbfm_init_state
from radiocore_tpu.ops import fft as _fft
from radiocore_tpu.ops.channelize import make_extractor
from radiocore_tpu.parallel.mesh import STATIONS, TIME


def _make_distributed_fused(mesh: Mesh, n_band: int,
                            offsets_hz: Sequence[int], station_chunk: int):
    """Distributed band FFT + channel extraction as one shard_map.

    Returns a jitted ``band (n,) → stations (C, m)`` function sharded in
    contiguous blocks over ALL mesh devices, or None when the plan
    doesn't qualify. The per-shard body (six-step FFT + roll + windowed
    extraction) lives in :mod:`radiocore_tpu.parallel.channelize_sharded`
    — shared with the wideband config-4 benchmark.
    """
    from radiocore_tpu.parallel.channelize_sharded import make_extract_body

    d = int(mesh.devices.size)
    axis = "fftax"
    body = make_extract_body(n_band, tuple(int(-o) for o in offsets_hz),
                             station_chunk, d, axis)
    if body is None:
        return None
    # Flat 1-axis view of the same devices in row-major mesh order: the
    # resulting block sharding is identical (same HloSharding) to
    # ``P((STATIONS, TIME))`` on the caller's 2-D mesh, so downstream
    # jits with 2-D-mesh shardings accept the outputs without resharding.
    flat_mesh = Mesh(mesh.devices.reshape(-1), (axis,))
    return jax.jit(jax.shard_map(body, mesh=flat_mesh,
                                 in_specs=P(axis), out_specs=P(axis, None)))


def make_multi_station_step(
        n_band: int,
        offsets_hz: Sequence[int],
        station_chunk: int,
        audio_chunk: int,
        deemphasis: float = 75e-6,
        mesh: Optional[Mesh] = None,
        mode: str = "exact",
) -> Tuple[Callable, dict]:
    """Build ``step(band_iq, state) -> (audio, state)`` plus initial state.

    * ``n_band``: full-band chunk length (== band sample rate, one-second
      convention).
    * ``offsets_hz``: per-station center-frequency offsets from the band
      center, in Hz (== bins).
    * ``station_chunk``: per-station IQ chunk (== station bandwidth).
    * ``audio_chunk``: audio samples out per station per chunk.

    When ``mesh`` is given the returned step is jitted with shardings:
    audio/state sharded over the ``stations`` axis, band input sharded
    over ``time``. XLA's SPMD partitioner inserts the collectives (the
    band FFT and the station gather are the only cross-shard points).
    """
    n_stations = len(offsets_hz)
    # Roll = band_center − station_center = −offset (tuner convention).
    extract = make_extractor(int(n_band),
                             tuple(int(-o) for o in offsets_hz),
                             int(station_chunk))
    wbfm = make_wbfm_step(station_chunk, audio_chunk, deemphasis, mode=mode)
    wbfm_batched = jax.vmap(wbfm)

    def band_fft(band_iq: jnp.ndarray) -> jnp.ndarray:
        if mesh is not None:
            # Gather the time-sharded band before the FFT with an explicit
            # canonical-layout constraint (the CPU FFT runtime rejects the
            # partitioner's implicit-gather layout).
            band_iq = jax.lax.with_sharding_constraint(
                band_iq, NamedSharding(mesh, P()))
        return _fft.fft(band_iq)

    def wbfm_stage(stations_iq: jnp.ndarray, state: dict):
        return wbfm_batched(stations_iq.astype(jnp.complex64), state)

    state0 = wbfm_init_state(audio_chunk, deemphasis,
                             batch_shape=(n_stations,))

    if mesh is not None:
        dist = _make_distributed_fused(
            mesh, n_band, offsets_hz, station_chunk)
        if dist is not None:
            # Fully distributed front-end: six-step band FFT + local
            # channel extraction in ONE shard_map over all devices — no
            # device ever holds the full band spectrum (per-device peak
            # is ~1/D of the band), and the demod shards stations over
            # every device too.
            all_ax = NamedSharding(mesh, P((STATIONS, TIME), None))
            all_ax3 = NamedSharding(mesh, P((STATIONS, TIME), None, None))
            state_sh = {"deemph_l": all_ax, "deemph_r": all_ax}
            wbfm_j = jax.jit(wbfm_stage,
                             out_shardings=(all_ax3, state_sh))
            state0 = jax.device_put(state0, state_sh)

            def step(band_iq: jnp.ndarray, state: dict):
                return wbfm_j(dist(band_iq), state)

            return step, state0

        # Fallback (non-uniform channel plan or indivisible sizes):
        # gather the time-sharded band to replicated before the FFT.
        st2 = NamedSharding(mesh, P(STATIONS, None))
        st3 = NamedSharding(mesh, P(STATIONS, None, None))
        tm = NamedSharding(mesh, P(TIME))
        state_sh = {"deemph_l": st2, "deemph_r": st2}
        band_fft = jax.jit(band_fft, in_shardings=tm)
        extract_j = jax.jit(extract, out_shardings=st2)
        wbfm_j = jax.jit(wbfm_stage, out_shardings=(st3, state_sh))
        state0 = jax.device_put(state0, state_sh)

        def step(band_iq: jnp.ndarray, state: dict):
            return wbfm_j(extract_j(band_fft(band_iq)), state)

        return step, state0

    # Single device: ONE program when no FFT size in it is decomposed
    # (saves the inter-stage round-trips of the spectrum and station
    # arrays through device memory). With the 'fourstep' FFT policy
    # (ops/fft.py set_policy) a non-pow2 size is decomposed, and the
    # stages get their own jits: a jit boundary pins canonical layouts,
    # which the decomposition's transposes would otherwise propagate
    # into the extraction slices. The default policy is native for every
    # size, so on the GPU and the CPU the fused program is always taken.
    def _fusable(s: int) -> bool:
        return (s & (s - 1)) == 0 or _fft._plan(s) is None

    if all(_fusable(s) for s in {int(n_band), int(station_chunk),
                                 int(audio_chunk)}):
        @jax.jit
        def step(band_iq: jnp.ndarray, state: dict):
            return wbfm_stage(extract(band_fft(band_iq)), state)

        return step, state0

    band_fft = jax.jit(band_fft)
    extract_j = jax.jit(extract)
    wbfm_j = jax.jit(wbfm_stage)

    def step(band_iq: jnp.ndarray, state: dict):
        return wbfm_j(extract_j(band_fft(band_iq)), state)

    return step, state0

"""Scaling-efficiency harness: IQ Msamples/s/chip across mesh sizes.

BASELINE.md target: ≥80% multi-host scaling efficiency measured at
1 chip → 1 host → N hosts on a many-station multi-FM workload. This
harness runs the fused channelize+demod pipeline on growing station-axis
meshes and reports samples/s/chip relative to the 1-chip number.

Without several cards, exercise it with virtual CPU devices:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --stations-per-chip 2
Multi-host: run one process per host with jax.distributed initialized
(radiocore_tpu.runtime.platform.initialize_multihost).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def collective_report(mesh, n_stations: int, station_chunk: int,
                      audio_chunk: int):
    """Static per-device collective traffic of the fused step's compiled
    front-end (bytes/step), plus the projected worst-case efficiency.

    This is the platform-independent half of the scaling story: the
    collective volume is a property of the compiled HLO, measurable on
    ONE device (or CPU), and with the card's compute time it bounds the
    multi-card efficiency (parallel/comm_analysis.py).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from radiocore_tpu.parallel.channelize_sharded import make_extract_body
    from radiocore_tpu.parallel.comm_analysis import collective_bytes

    n_band = n_stations * station_chunk
    d = int(mesh.devices.size)
    if d <= 1:
        return {"total": 0}
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]
    body = make_extract_body(n_band, tuple(int(-o) for o in offsets),
                             station_chunk, d, "fftax")
    if body is None:
        return None
    flat = Mesh(mesh.devices.reshape(-1), ("fftax",))
    fn = jax.jit(jax.shard_map(body, mesh=flat, in_specs=P("fftax"),
                               out_specs=P("fftax", None)))
    txt = fn.lower(jax.ShapeDtypeStruct((n_band,), jnp.complex64)
                   ).compile().as_text()
    return collective_bytes(txt)


def measure(mesh, n_stations: int, station_chunk: int, audio_chunk: int,
            iters: int) -> float:
    """Seconds per fused step on ``mesh`` for ``n_stations`` stations."""
    import jax
    import jax.numpy as jnp
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]
    step, state = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk, mesh=mesh)

    @jax.jit
    def make_band(key):
        planes = 0.1 * jax.random.normal(key, (2, n_band), jnp.float32)
        return jax.lax.complex(planes[0], planes[1])

    # Timing: (a) per-call scalar jitter, so no two calls share inputs;
    # (b) a scalar
    # derived from the expensive audio output chains into the next
    # call's jitter so no call's work can be elided. The jitter is
    # applied in its OWN tiny jit so the pipeline's deliberate per-stage
    # jit boundaries are preserved (an outer jit would inline them into
    # one program with different layout behavior).
    jitter_fn = jax.jit(lambda b, j: b * (1.0 + j))
    chk_fn = jax.jit(lambda a: jnp.mean(jnp.abs(a)) + a.ravel()[0] * 1e-3)

    band = make_band(jax.random.key(0))
    audio, state = step(jitter_fn(band, jnp.float32(0)), state)  # compile
    chk = chk_fn(audio)
    jax.block_until_ready((audio, chk))

    float(chk)  # hard drain (float() barrier, see bench.py)
    t0 = time.perf_counter()
    for i in range(iters):
        # chk*1e-3 actually perturbs the value (1e-30 would underflow
        # against the 1e-7 step in f32 and repeat bit-identical args).
        b2 = jitter_fn(band, chk * 1e-3 + jnp.float32((i + 1) * 1e-7))
        audio, state = step(b2, state)
        chk = chk_fn(audio)
    float(chk)
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stations-per-chip", type=int, default=4)
    parser.add_argument("--station-rate", type=float, default=250e3)
    parser.add_argument("--audio-rate", type=float, default=48e3)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--time-axis", action="store_true",
                        help="shard over the time mesh axis instead of "
                             "stations (the distributed six-step band "
                             "FFT shards over all devices either way; "
                             "this exercises the time-major layout)")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend in-process")
    args = parser.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from radiocore_tpu.parallel.mesh import make_radio_mesh

    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, n_dev) if s <= n_dev]

    def peak_mem_mb():
        try:
            stats = jax.local_devices()[0].memory_stats()
            return round(stats["peak_bytes_in_use"] / 1e6, 1)
        except Exception:
            return None  # CPU backend has no memory stats

    platform = jax.devices()[0].platform
    # Wall-clock "efficiency" from virtual devices multiplexed onto a
    # small physical core count measures host contention, not scaling —
    # label those rows so they can't be misread.
    import os
    n_cores = os.cpu_count() or 1
    virtual = platform == "cpu" and n_dev > n_cores

    # Projection inputs: per-station compute time from bench.py on one
    # NVIDIA H100 80GB HBM3 at 700 W (2.33 ms for 64 stations), and
    # NVLink's 450 GB/s each way per card.
    t_station = 2.33e-3 / 64

    station_chunk = int(args.station_rate)
    audio_chunk = int(args.audio_rate)
    rows = []
    base_rate = None
    for n_chips in dict.fromkeys(sizes):
        if args.time_axis:
            mesh = make_radio_mesh(stations=1, time=n_chips,
                                   devices=jax.devices()[:n_chips])
        else:
            mesh = make_radio_mesh(stations=n_chips, time=1,
                                   devices=jax.devices()[:n_chips])
        n_st = args.stations_per_chip * n_chips
        dt = measure(mesh, n_st, station_chunk, audio_chunk, args.iters)
        msps_per_chip = n_st * station_chunk / dt / n_chips / 1e6
        if base_rate is None:
            base_rate = msps_per_chip
        row = {
            "chips": n_chips,
            "mesh": dict(mesh.shape),
            "stations": n_st,
            "sec_per_chunk": round(dt, 4),
            "iq_msps_per_chip": round(msps_per_chip, 2),
            "scaling_efficiency": round(msps_per_chip / base_rate, 3),
            "peak_device_mem_mb": peak_mem_mb(),
            "platform": platform,
        }
        if virtual:
            row["virtual_devices"] = True
            row["note"] = (f"{n_dev} virtual devices on {n_cores} cores: "
                           "wall-clock columns measure host contention, "
                           "not scaling; see projected_efficiency")
        # Platform-independent half: static collective bytes/device/step
        # from the compiled HLO + worst-case (fully exposed) efficiency
        # projection against real-chip compute time.
        coll = collective_report(mesh, n_st, station_chunk, audio_chunk,)
        if coll is not None:
            from radiocore_tpu.parallel.comm_analysis import (
                projected_efficiency)
            row["collective_bytes_per_device"] = coll.get("total", 0)
            row["collective_breakdown"] = {
                k: v for k, v in coll.items() if k != "total"}
            t_comp = t_station * args.stations_per_chip
            row["projected_efficiency_h100_nvlink"] = projected_efficiency(
                t_comp, coll.get("total", 0))
        rows.append(row)
        print(json.dumps(rows[-1]))


if __name__ == "__main__":
    main()

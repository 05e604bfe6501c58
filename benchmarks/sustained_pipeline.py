"""Sustained 60-chunk run of the fused 64-station pipeline (device-
resident IQ): the at-scale streaming-health complement to the
single-station ingest demo (benchmarks/stream_run.py).

Each wall-clock-paced tick feeds ONE SECOND of band IQ (synthesized on
device — only scalars cross host↔device, so this times the device path
alone) through the fused channelize+demod step,
carrying the streaming demod state across all chunks. Health = every
chunk processed inside its 1 s budget (realtime factor per chunk > 1)
with the state chain intact (chained audio checksum evolves, no NaNs).

    python benchmarks/sustained_pipeline.py [--chunks 60] [--stations 64]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--chunks", type=int, default=60)
    parser.add_argument("--stations", type=int, default=64)
    parser.add_argument("--station-chunk", type=int, default=262_144)
    parser.add_argument("--audio-chunk", type=int, default=49_152)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import jax
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    import numpy as np
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    C, m, au = args.stations, args.station_chunk, args.audio_chunk
    n_band = C * m
    half = n_band // 2 - m // 2
    offsets = [int(-half + i * m) for i in range(C)]
    step, state = make_multi_station_step(n_band, offsets, m, au,
                                          mode="fast")

    @jax.jit
    def make_band(key, c):
        p = 0.1 * jax.random.normal(key, (2, n_band), jnp.float32)
        return jax.lax.complex(p[0], p[1]) * (1.0 + c * 1e-3)

    @jax.jit
    def chained(band, st):
        audio, st2 = step(band, st)
        chk = jnp.mean(jnp.abs(audio)) + audio[0, 0, 0] * 1e-3
        return st2, chk

    backend = str(jax.devices()[0])
    log(f"backend: {backend}")
    t0 = time.perf_counter()
    st, chk = chained(make_band(jax.random.key(0), jnp.float32(0)), state)
    chk_v = float(chk)
    log(f"compile+first: {time.perf_counter() - t0:.1f} s chk={chk_v:.4e}")

    walls = []
    chks = []
    t_start = time.perf_counter()
    for i in range(args.chunks):
        # Pace to the 1-second-per-chunk contract.
        lag = i - (time.perf_counter() - t_start)
        if lag > 0:
            time.sleep(lag)
        t0 = time.perf_counter()
        band = make_band(jax.random.key(1 + i), chk)
        st, chk = chained(band, st)
        chk_v = float(chk)   # hard per-chunk barrier
        walls.append(time.perf_counter() - t0)
        chks.append(chk_v)
        if i % 10 == 0:
            log(f"chunk {i}: {walls[-1]*1e3:.1f} ms chk={chk_v:.4e}")

    rtf = [1.0 / w for w in walls]
    finite = all(np.isfinite(c) for c in chks)
    healthy = bool(min(rtf) > 1.0 and finite)
    result = {
        "metric": "sustained_pipeline_realtime_factor_min",
        "value": round(min(rtf), 1),
        "unit": "x_realtime",
        "backend": backend,
        "stations": C,
        "chunks": args.chunks,
        "chunk_wall_ms": {
            "min": round(min(walls) * 1e3, 1),
            "median": round(float(np.median(walls)) * 1e3, 1),
            "max": round(max(walls) * 1e3, 1),
        },
        "healthy": healthy,
        "state_chain_finite": finite,
        "note": "device-resident IQ; per-chunk hard scalar barrier; "
                "walls include per-call dispatch",
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

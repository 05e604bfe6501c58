"""Collective-traffic grid: bytes/device vs station count AND shard
count, with projected multi-card efficiency.

The BYTES each device moves per step is a static property of the
compiled sharded HLO (parallel/comm_analysis.py). This harness compiles
the distributed front-end (six-step band FFT + local extraction in one
shard_map — the only cross-device stage; the demod is embarrassingly
station-parallel) over a grid of (stations, devices) at the REAL
station chunk (262144 S/s) and records:

  * collective bytes per device per step (by collective kind),
  * projected efficiency = t_compute / (t_compute + bytes/LINK_BW).

Model assumptions:
  1. t_compute is the measured one-card fused-step time divided across
     D cards perfectly (station parallelism is lockstep-free in steady
     state; the only serialization is the front-end).
  2. Collective time = bytes / NVLink's 450 GB/s each way per card
     (parallel/comm_analysis.py) with NO overlap of compute and
     communication — a worst-case bound.
  3. Bytes are per-step HLO totals; the pipeline has no collectives
     inside loops (checked by construction).
  4. Hops between hosts are NOT modeled.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling_grid.py --out scaling.json

Prints one JSON line per grid point + the combined artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stations", type=int, nargs="+",
                        default=[32, 64, 128])
    parser.add_argument("--devices", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--station-chunk", type=int, default=262_144)
    parser.add_argument("--step-ms", type=float, default=2.33,
                        help="one-card 64-station fused-step ms for the "
                             "efficiency projection (default: bench.py "
                             "on one NVIDIA H100 80GB HBM3 at 700 W)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from radiocore_tpu.parallel.channelize_sharded import make_extract_body
    from radiocore_tpu.parallel.comm_analysis import (collective_bytes,
                                                      projected_efficiency)

    step_ms = args.step_ms
    base_stations = 64   # the step_ms measurement's station count
    m = args.station_chunk
    rows = []
    for c in args.stations:
        n_band = c * m
        half = n_band // 2 - m // 2
        offsets = [int(-half + i * m) for i in range(c)]
        for d in args.devices:
            if c % d:
                continue
            body = make_extract_body(n_band,
                                     tuple(int(-o) for o in offsets),
                                     m, d, "fftax")
            if body is None:
                rows.append({"stations": c, "devices": d, "plan": None})
                continue
            mesh = Mesh(jax.devices()[:d], ("fftax",))
            fn = jax.jit(jax.shard_map(body, mesh=mesh,
                                       in_specs=P("fftax"),
                                       out_specs=P("fftax", None)))
            txt = fn.lower(jax.ShapeDtypeStruct((n_band,), jnp.complex64)
                           ).compile().as_text()
            rep = collective_bytes(txt)
            total = rep.get("total", 0)
            # Scale the measured one-card compute time to this station
            # count, then split across D cards (assumption 1).
            t_comp = step_ms * 1e-3 * (c / base_stations) / d
            row = {"stations": c, "devices": d,
                   "collective_bytes_per_device": total,
                   "collective_breakdown": {k: v for k, v in rep.items()
                                            if k != "total"},
                   "t_compute_ms": t_comp * 1e3,
                   "projected_efficiency_nvlink_noverlap":
                       projected_efficiency(t_comp, total)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    art = {"what": "collective bytes/device vs (stations, devices) grid, "
                   "distributed six-step band FFT + extraction",
           "station_chunk": m,
           "step_ms": step_ms, "step_stations": base_stations,
           "assumptions": [
               "t_compute scales linearly in stations and splits "
               "perfectly across devices",
               "collective time = bytes / 450 GB/s (NVLink each way), "
               "ZERO compute-communication overlap (worst case)",
               "per-step HLO byte totals; no collectives inside loops",
               "hops between hosts not modeled",
           ],
           "rows": rows}
    print(json.dumps({"grid_points": len(rows)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

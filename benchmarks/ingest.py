"""Sustained host→device IQ ingest benchmark.

Measures CF32 ingest at the config-4 class rate (61.44 MS/s target =
492 MB/s H2D) through :mod:`radiocore_tpu.runtime.ingest`, A/B:

* depth=1 — synchronous: put, compute, repeat;
* depth=2 — double-buffered: chunk N+1's H2D DMA issued before chunk N
  is consumed (overlaps transfer with compute).

Each chunk is DISTINCT host data and the
consumer compute (FFT + checksum) chains an output-derived scalar into a
final ``float()`` barrier, so no transfer or compute can be elided.

Prints one JSON line per mode plus a summary. The reference's analog is
cuSignal pinned/managed memory (``radiocore/tools/buffer.py:42-44``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--chunk", type=int, default=1 << 22,
                        help="samples per chunk (complex64)")
    parser.add_argument("--chunks", type=int, default=12)
    parser.add_argument("--target-msps", type=float, default=61.44)
    args = parser.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp
    from radiocore_tpu.runtime.ingest import IngestPipe

    dev = jax.devices()[0]
    print(json.dumps({"backend": str(dev)}), flush=True)

    n = args.chunk
    rng = np.random.default_rng(0)
    # Distinct chunks; generated once so the timed loop measures
    # H2D + device compute, not host RNG.
    host_chunks = [
        (rng.standard_normal(2 * n, dtype=np.float32)
         .view(np.complex64) * 0.1).copy()
        for _ in range(args.chunks)
    ]
    bytes_per_chunk = n * 8

    @jax.jit
    def consume(x, c):
        y = jnp.fft.fft(x * (1.0 + c * 1e-3))
        return jnp.mean(jnp.abs(y[::4096]))

    results = {}
    for depth in (1, 2):
        pipe = IngestPipe(depth=depth)
        # Warm: compile consume + exercise the transfer path once.
        c = jnp.float32(0)
        for x in pipe.stream(host_chunks[:2]):
            c = consume(x, c)
        float(c)

        t0 = time.perf_counter()
        c = jnp.float32(0)
        for x in pipe.stream(host_chunks):
            c = consume(x, c)
        chk = float(c)  # hard barrier: full chain must complete
        dt = time.perf_counter() - t0

        msps = args.chunks * n / dt / 1e6
        results[depth] = msps
        print(json.dumps({
            "mode": f"depth={depth}" + (" (sync)" if depth == 1
                                        else " (double-buffered)"),
            "msamples_per_s": round(msps, 1),
            "h2d_gb_per_s": round(args.chunks * bytes_per_chunk / dt / 1e9,
                                  3),
            "sec_total": round(dt, 3),
            "chk": chk,
        }), flush=True)

    ok = results[2] >= args.target_msps
    print(json.dumps({
        "metric": "sustained_ingest_msps",
        "value": round(results[2], 1),
        "overlap_gain": round(results[2] / results[1], 2),
        "target_msps": args.target_msps,
        "meets_target": ok,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Component benchmarks mirroring the reference harness configs.

Reference (``tests/benchmark.py``): WBFM/MFM/FM at 256 kS/s → 32 kS/s,
Decimate at 10 MS/s → 250 kS/s and 2.5 MS/s → 250 kS/s, Tuner
``load + run(0)`` on a 10 MS/s band with 3×250 kHz channels — 50
timed iterations each, seconds-per-run printed. Runs on whatever JAX
platform is active (the GPU when there is one; set
``JAX_PLATFORMS=cpu`` for the host baseline) and additionally
reports the batched ``run_all`` and fused-pipeline numbers the reference
has no analog for.

    python benchmarks/benchmark.py [--iters 50] [--json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _time(fn, iters: int, warmup: int = 2) -> float:
    # fn() re-runs the same (program, args) every iteration, like the
    # reference harness. For the pipeline's throughput use bench.py /
    # benchmarks/wideband.py, whose loops vary inputs and chain state.
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _device_iq(n: int, seed: int = 0):
    """Synthesize complex IQ on device (no host transfer — see
    runtime/transfer.py for why)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def make(key):
        planes = 0.1 * jax.random.normal(key, (2, n), jnp.float32)
        return jax.lax.complex(planes[0], planes[1])

    out = make(jax.random.key(seed))
    jax.block_until_ready(out)
    return out


def bench_demods(results, iters):
    from radiocore_tpu import FM, MFM, WBFM
    iq = _device_iq(256_000)
    for name, cls in [("wbfm", WBFM), ("mfm", MFM), ("fm", FM)]:
        demod = cls(256e3, 32e3)
        results[f"{name}_256k_to_32k_s"] = _time(
            lambda: demod.run(iq, numpy_output=False), iters)


def bench_decimate(results, iters):
    from radiocore_tpu import Decimate
    for in_rate in (10e6, 2.5e6):
        n = int(in_rate)
        iq = _device_iq(n, seed=1)
        dec = Decimate(in_rate, 250e3)
        results[f"decimate_{int(in_rate/1e6)}M_to_250k_s"] = _time(
            lambda: dec.run(iq), iters)


def bench_tuner(results, iters):
    from radiocore_tpu import Tuner
    tuner = Tuner()
    for i in range(3):
        tuner.add_channel(96.9e6 + i * 2e6, 250e3, None)
    tuner.request_bandwidth(10e6)
    band = _device_iq(int(tuner.input_bandwidth), seed=2)

    def load_run0():
        tuner.load(band)
        return tuner.run(0)

    def load_run_all():
        tuner.load(band)
        return tuner.run_all()

    results["tuner_10M_load_run0_s"] = _time(load_run0, iters)
    results["tuner_10M_load_run_all_s"] = _time(load_run_all, iters)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--only", choices=["demods", "decimate", "tuner"])
    args = parser.parse_args(argv)

    import jax
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    results = {"platform": jax.devices()[0].device_kind}
    if args.only in (None, "demods"):
        bench_demods(results, args.iters)
    if args.only in (None, "decimate"):
        bench_decimate(results, args.iters)
    if args.only in (None, "tuner"):
        bench_tuner(results, args.iters)

    if args.json:
        print(json.dumps(results))
    else:
        for k, v in results.items():
            print(f"{k}: {v if isinstance(v, str) else f'{v:.6f}'}")


if __name__ == "__main__":
    main()

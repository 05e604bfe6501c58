"""Probe: native FFT (cuFFT) vs the four-step decomposition per size.

Times ``ops.fft.fft`` under each planner policy ('native' and
'fourstep', ``ops.fft.set_policy``) with fresh inputs and an
output-derived chained scalar, and prints one JSON line per
(size, policy) with the effective bandwidth of one read + one write of
the c64 array. A time below that pass at the card's published HBM
bandwidth (``runtime.platform.PEAKS``) is marked suspect.

    python benchmarks/fft_probe.py --sizes 24 25 26 --raw-sizes 25165824
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[22, 24, 25],
                        help="log2 of FFT sizes to probe")
    parser.add_argument("--raw-sizes", type=int, nargs="*", default=[],
                        help="absolute FFT sizes (for non-pow2 probes, "
                             "e.g. the 96-station 24M band)")
    parser.add_argument("--impls", default="native,fourstep",
                        help="comma list of native,fourstep")
    parser.add_argument("--iters", type=int, default=6)
    args = parser.parse_args(argv)

    import jax
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    from radiocore_tpu.ops import fft as _fft

    from radiocore_tpu.runtime.platform import device_peaks

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"fft_probe: needs a GPU, JAX found {dev.platform!r}")
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind}),
          flush=True)
    peak = device_peaks(dev)["hbm_bytes_per_s"]

    sizes = [1 << lg for lg in args.sizes] + list(args.raw_sizes)
    impls = args.impls.split(",")
    for n in sizes:

        @jax.jit
        def make(key, _n=n):
            planes = jax.random.normal(key, (2, _n), jnp.float32)
            return jax.lax.complex(planes[0], planes[1])

        xs = [make(jax.random.key(i)) for i in range(args.iters + 1)]
        jax.block_until_ready(xs)

        for policy in impls:
            _fft.set_policy(policy)
            try:
                @jax.jit
                def f(x, c):
                    y = _fft.fft(x * (1.0 + c * 1e-3))
                    return jnp.mean(jnp.abs(y[::65536])) + \
                        jnp.real(y[0]) * 1e-6

                c = f(xs[-1], jnp.float32(0))
                float(c)  # compile + drain
                best = None
                for _ in range(2):
                    float(c)
                    t0 = time.perf_counter()
                    for i in range(args.iters):
                        c = f(xs[i], c)
                    float(c)
                    dt = (time.perf_counter() - t0) / args.iters
                    best = dt if best is None else min(best, dt)
                row = {"n": n, "impl": policy,
                       "ms": round(best * 1e3, 3),
                       "eff_gb_per_s": round(2 * n * 8 / best / 1e9, 1)}
                # floor: one read+write pass of the c64 array
                row["suspect"] = best < 2 * n * 8 / peak
                print(json.dumps(row), flush=True)
            finally:
                _fft.set_policy("native")
    return 0


if __name__ == "__main__":
    sys.exit(main())

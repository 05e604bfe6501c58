"""Plain-XLA layer figures on the GPU, each against its roofline.

Times, at the shapes the fused 64-station pipeline runs, what XLA and
cuFFT make of each layer with no hand kernel:

  copy_2e24            x·c over a 2^24 c64 band (one read + one write:
                       what a plain pass reaches on this card)
  fft_{native,fourstep}_N
                       band FFT, c64, N = 2^24, 2^25, 2^26 and 3·2^23;
                       native = cuFFT, fourstep = ops.fft.fft_decomposed
  rfft_64x2e18         station-batch rfft, f32 (64, 2^18)
  extract_64x2e18      ops.channelize extraction of 64 stations from a
                       2^24 spectrum (reorder + window + batched IFFT)
  fir_{conv,fft}_band  129-tap FIR on (2, 2^24) planar f32
  fir_{conv,fft}_deemph
                       51-tap streaming FIR on (64, 49 152) f32, the
                       per-station de-emphasis shape

Device time per call is the sum of the GPU kernel durations in a
profiler trace of ``--iters`` calls; the wall time around the same calls
(ending in ``block_until_ready``) is printed beside it. The roofline
floor is the larger of bytes ÷ peak HBM bandwidth and FLOPs ÷ peak f32
rate (``runtime.platform.PEAKS``); ``roofline_share`` = floor ÷ device
time. Bytes count one read of every input and one write of every
output. Also compiles native FFTs at the reference's radio sizes and
checks each against NumPy.

    python benchmarks/fft_micro.py [--iters 10] [--only a,b] [--out F]

Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def kernel_times(trace_dir: str) -> dict:
    """``{kernel name: (total ns, count)}`` over the GPU stream lines of
    the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out: dict = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                tot, cnt = out.get(ev.name, (0.0, 0))
                out[ev.name] = (tot + ev.duration_ns, cnt + 1)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--only", default=None,
                        help="comma-separated subset of case names")
    parser.add_argument("--out", default=None,
                        help="also append the JSON lines to this file")
    args = parser.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp
    from scipy import signal as sig

    if jax.devices()[0].platform != "gpu":
        sys.exit("fft_micro: needs a GPU")
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from radiocore_tpu.ops import channelize
    from radiocore_tpu.ops import fft as _fft
    from radiocore_tpu.ops.fir import fir_causal
    from radiocore_tpu.runtime.platform import device_peaks

    dev = jax.devices()[0]
    peaks = device_peaks(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"device_kind": dev.device_kind, "platform": dev.platform,
          "nvidia_smi": smi, "peaks": peaks})

    def c64(shape, seed):
        k = jax.random.key(seed)
        p = jax.random.normal(k, (2,) + shape, jnp.float32)
        return jax.lax.complex(p[0], p[1])

    def f32(shape, seed):
        return jax.random.normal(jax.random.key(seed), shape, jnp.float32)

    C, M, AU = 64, 262_144, 49_152
    NB = C * M
    half = NB // 2 - M // 2
    shifts = tuple(int(half - i * M) for i in range(C))
    band_taps = sig.firwin(129, 0.45)
    de_taps = sig.firwin(51, 0.1)

    # name: (fn, make inputs, bytes, flops)
    cases = {"copy_2e24": (lambda x: x * jnp.complex64(1.0001),
                           lambda s: c64((NB,), s), 2 * NB * 8, 0)}
    for n, tag in ((1 << 24, "2e24"), (1 << 25, "2e25"), (1 << 26, "2e26"),
                   (3 << 23, "3x2e23")):
        cases[f"fft_native_{tag}"] = (jnp.fft.fft,
                                      lambda s, _n=n: c64((_n,), s),
                                      2 * n * 8, 5 * n * np.log2(n))
        cases[f"fft_fourstep_{tag}"] = (_fft.fft_decomposed,
                                        lambda s, _n=n: c64((_n,), s),
                                        2 * n * 8, 5 * n * np.log2(n))
    cases["rfft_64x2e18"] = (lambda x: jnp.fft.rfft(x, axis=-1),
                             lambda s: f32((C, M), s),
                             C * M * 4 + C * (M // 2 + 1) * 8,
                             2.5 * C * M * np.log2(M))
    cases["extract_64x2e18"] = (channelize.make_extractor(NB, shifts, M),
                                lambda s: c64((NB,), s), 2 * NB * 8, 0)
    for impl in ("conv", "fft"):
        cases[f"fir_{impl}_band"] = (
            lambda x, _i=impl: fir_causal(x, band_taps, impl=_i),
            lambda s: f32((2, NB), s), 2 * 2 * NB * 4, 2 * 129 * 2 * NB)
        cases[f"fir_{impl}_deemph"] = (
            lambda x, _i=impl: fir_causal(x, de_taps, impl=_i,
                                          history=x[:, :50]),
            lambda s: f32((C, AU), s), 2 * C * AU * 4, 2 * 51 * C * AU)
    if args.only:
        keep = set(args.only.split(","))
        cases = {k: v for k, v in cases.items() if k in keep}

    for name, (fn, make, nbytes, flops) in cases.items():
        xs = [make(i) for i in range(2)]
        jax.block_until_ready(xs)
        f = jax.jit(fn)
        t0 = time.perf_counter()
        jax.block_until_ready(f(xs[0]))
        compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for i in range(args.iters):
                out = f(xs[i % 2])
            jax.block_until_ready(out)
            walls.append((time.perf_counter() - t0) / args.iters)
        with tempfile.TemporaryDirectory(dir=REPO,
                                         prefix=".trace_") as tdir:
            with jax.profiler.trace(tdir):
                for i in range(args.iters):
                    out = f(xs[i % 2])
                jax.block_until_ready(out)
            kernels = kernel_times(tdir)
        device_s = sum(t for t, _ in kernels.values()) / 1e9 / args.iters
        floor_bytes = nbytes / peaks["hbm_bytes_per_s"]
        floor_flops = flops / peaks["f32_flops"]
        floor = max(floor_bytes, floor_flops)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        emit({"case": name, "compile_s": compile_s,
              "wall_ms": statistics.median(walls) * 1e3,
              "device_ms": device_s * 1e3,
              "kernels_per_call": sum(c for _, c in kernels.values())
              / args.iters,
              "bytes": nbytes, "floor_ms": floor * 1e3,
              "bound": "flops" if floor_flops > floor_bytes else "bytes",
              "roofline_share": floor / device_s if device_s else None,
              "top_kernels": [[k[:80], t / 1e6 / args.iters, c / args.iters]
                              for k, (t, c) in top]})
        del xs, out

    # Native FFT at the reference's radio sizes: compiles, and is right.
    rng = np.random.default_rng(0)
    for n in (240_000, 250_000, 2_400_000, 4_000_000, 10_000_000):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        t0 = time.perf_counter()
        got = np.asarray(jax.jit(jnp.fft.fft)(x))
        dt = time.perf_counter() - t0
        want = np.fft.fft(x.astype(np.complex128))
        emit({"case": f"native_fft_compiles_{n}", "compile_and_run_s": dt,
              "rel_err": float(np.max(np.abs(got - want))
                               / np.max(np.abs(want)))})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

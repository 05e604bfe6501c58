"""Per-transform profile of the fast-WBFM demod stage on the GPU.

The demod is the fused pipeline's largest stage (bench.py's stage
profile). This harness times each of its transforms alone, against the
bytes it must move at the card's published HBM bandwidth
(``runtime.platform.PEAKS``):

Fast-mode per step at (C=64, m=262144 → audio 49152), all batched over
stations (models/wbfm.py):
  quad      elementwise quadrature demod            (C, m) c64 → f32
  rfft_big  THE one full-length transform           (C, m) f32 → (C, m2c)
  env_ifft  envelope ifft                           (C, 2, n2) c64, n2=65536
  rfft_n2   lmr forward rfft                        (C, n2) f32
  irfft_au  stacked stereo irfft to audio           (C, 2, 24577) → 49152
  deemph    2× streaming 51-tap FIR                 (C, 49152) f32
  tail      everything after rfft_big (fast_spec)
  demod     the whole vmapped step (what bench.py's stage profile times)

Protocol: per-case jits, fresh inputs, a chained scalar derived from the
expensive output, min of epochs. Prints one JSON line per case and a
summary line. Refuses to run on anything but a GPU.

    python benchmarks/demod_profile.py [--stations 64] [--cases a,b]
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
    parser.add_argument("--stations", type=int, default=64)
    parser.add_argument("--station-chunk", type=int, default=262_144)
    parser.add_argument("--audio-chunk", type=int, default=49_152)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--cases", default=None,
                        help="comma-separated subset of case names")
    args = parser.parse_args(argv)

    import numpy as np
    import jax
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp

    from radiocore_tpu.models.wbfm import make_wbfm_step, wbfm_init_state
    from radiocore_tpu.ops import fft as _fft
    from radiocore_tpu.ops.demod import quadrature_demod
    from radiocore_tpu.ops.deemphasis import deemphasis_init
    from radiocore_tpu.ops.fir import fir_stream
    from radiocore_tpu.runtime.platform import device_peaks

    C, m, au = args.stations, args.station_chunk, args.audio_chunk
    m2c = m // 2 + 1      # rfft_big bins
    m2 = au // 2 + 1      # audio-side bins
    n2 = 65_536           # fast-mode envelope rate at m=262144

    v = jax.jit(lambda v: v + 1)(jnp.ones(8))
    jax.block_until_ready(v)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"demod_profile: needs a GPU, JAX found {dev.platform!r}")
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "C": C, "m": m}), flush=True)
    peak = device_peaks(dev)["hbm_bytes_per_s"]

    def fetch(c):
        return float(c)

    iters, epochs = args.iters, args.epochs

    def timed(name, fn, make_input, floor_bytes=None):
        """Honest per-call timing: fn(x, c) -> (out, chk)."""
        jf = jax.jit(fn)
        keys = [jax.random.key(1000 + i) for i in range(iters + 1)]
        xs = [make_input(k) for k in keys]
        jax.block_until_ready(xs)
        t0 = time.perf_counter()
        out, chk = jf(xs[-1], jnp.float32(0))
        fetch(chk)
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(epochs):
            fetch(chk)
            t0 = time.perf_counter()
            for i in range(iters):
                out, chk = jf(xs[i], chk)
            fetch(chk)
            best = min(best, (time.perf_counter() - t0) / iters)
        rec = {"case": name, "ms": round(best * 1e3, 3),
               "compile_s": round(compile_s, 1)}
        if floor_bytes:
            rec["floor_ms"] = round(floor_bytes / peak * 1e3, 3)
            rec["x_floor"] = round(best * peak / floor_bytes, 1)
        print(json.dumps(rec), flush=True)
        return best

    # ---- device-synthesized inputs ------------------------------------
    def mk_iq(key):
        p = 0.1 * jax.random.normal(key, (2, C, m), jnp.float32)
        return jax.lax.complex(p[0], p[1])

    def mk_f32(shape):
        def mk(key):
            return 0.1 * jax.random.normal(key, shape, jnp.float32)
        return mk

    def mk_c64(shape):
        def mk(key):
            p = 0.1 * jax.random.normal(key, (2,) + shape, jnp.float32)
            return jax.lax.complex(p[0], p[1])
        return mk

    cases = {}

    def case(name):
        def deco(fn):
            cases[name] = fn
            return fn
        return deco

    # ---- whole stage ---------------------------------------------------
    wbfm = jax.vmap(make_wbfm_step(m, au, mode="fast"))
    st0 = wbfm_init_state(au, batch_shape=(C,))

    @case("demod_full")
    def _():
        def fn(iq, c):
            a, _st = wbfm(iq * (1.0 + c * 1e-3), st0)
            return a, jnp.mean(jnp.abs(a)) + a[0, 0, 0] * 1e-3
        return timed("demod_full", fn, mk_iq,
                     floor_bytes=C * m * 8 + C * au * 2 * 4)

    # ---- tail from the composite spectrum ------------------------------
    tail_fn = make_wbfm_step(m, au, mode="fast_spec")
    tail = jax.vmap(tail_fn)

    @case("tail_from_spec")
    def _():
        def fn(qs, c):
            a, _st = tail(qs * (1.0 + c * 1e-3), st0)
            return a, jnp.mean(jnp.abs(a)) + a[0, 0, 0] * 1e-3
        return timed("tail_from_spec", fn, mk_c64((C, m2c)),
                     floor_bytes=C * m2c * 8 + C * au * 2 * 4)

    # ---- sub-transforms ------------------------------------------------
    @case("quad")
    def _():
        def fn(iq, c):
            q = quadrature_demod(iq * (1.0 + c * 1e-3))
            return q, jnp.mean(jnp.abs(q)) + q[0, 0] * 1e-3
        return timed("quad", fn, mk_iq, floor_bytes=C * m * (8 + 4))

    @case("rfft_big_native")
    def _():
        def fn(x, c):
            s = jnp.fft.rfft(x * (1.0 + c * 1e-3), axis=-1)
            return s, jnp.mean(jnp.abs(s[:, ::1024])) + jnp.real(s[0, 0]) * 1e-3
        return timed("rfft_big_native", fn, mk_f32((C, m)),
                     floor_bytes=C * m * 4 + C * m2c * 8)

    @case("env_ifft_native")
    def _():
        def fn(z, c):
            e = jnp.fft.ifft(z * (1.0 + c * 1e-3), axis=-1)
            return e, jnp.mean(jnp.abs(e[:, :, ::512])) + jnp.real(e[0, 0, 0]) * 1e-3
        return timed("env_ifft_native", fn, mk_c64((C, 2, n2)),
                     floor_bytes=C * 2 * n2 * 16)

    @case("rfft_n2_native")
    def _():
        def fn(x, c):
            s = jnp.fft.rfft(x * (1.0 + c * 1e-3), axis=-1)
            return s, jnp.mean(jnp.abs(s[:, ::512])) + jnp.real(s[0, 0]) * 1e-3
        return timed("rfft_n2_native", fn, mk_f32((C, n2)),
                     floor_bytes=C * n2 * (4 + 4))

    @case("irfft_audio_native")
    def _():
        def fn(z, c):
            x = jnp.fft.irfft(z * (1.0 + c * 1e-3), n=au, axis=-1)
            return x, jnp.mean(jnp.abs(x)) + x[0, 0, 0] * 1e-3
        return timed("irfft_audio_native", fn, mk_c64((C, 2, m2)),
                     floor_bytes=C * 2 * (m2 * 8 + au * 4))

    @case("deemph")
    def _():
        de_taps, hist0 = deemphasis_init(au, batch_shape=(C,))

        def fn(x, c):
            y, _h = fir_stream(x * (1.0 + c * 1e-3), de_taps, hist0)
            return y, jnp.mean(jnp.abs(y)) + y[0, 0] * 1e-3
        return timed("deemph", fn, mk_f32((C, au)),
                     floor_bytes=C * au * 8)

    names = list(cases)
    if args.cases:
        keep = set(args.cases.split(","))
        names = [n for n in names if n in keep]

    results = {name: cases[name]() * 1e3 for name in names}
    print(json.dumps({"summary_ms": results, "stations": C, "m": m}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

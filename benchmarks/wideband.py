"""Wideband channelizer benchmark — BASELINE.md config 4.

61.44 MS/s complex band → 64 channels via an overlap-save FIR pass at
the full band rate plus a channelizer: ``--channelizer fft`` (default;
band FFT → static slices → batched IFFT, the bench.py pipeline's form)
or ``--channelizer pfb``
(critically-sampled polyphase filterbank, the streaming form).
Reports Msamples/s on the active platform (optionally sharded over the
``time`` axis of a mesh with ``--time-shards``; FIR halos ride
ppermute — parallel/halo.py).

    python benchmarks/wideband.py [--seconds 0.5] [--time-shards N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def plan_n(band_rate: float, seconds: float, channels: int,
           channelizer: str) -> int:
    """Chunk length for the config: pow2-snapped for the fft form."""
    n = int(band_rate * seconds)
    if channelizer == "fft":
        # Snap the chunk to a power of two (bench.py does the same); a
        # pow2 n also satisfies the sharded path's n % D² == 0
        # requirement for pow2 D.
        p = 1
        while p * 2 <= n:
            p *= 2
        n = p
    return n - n % channels


def wrap_run_k(step):
    """k chained steps in ONE jitted lax.fori_loop (device-loop
    protocol). Each iteration's input is perturbed by the PREVIOUS
    iteration's full-channel reduction — a chained data dependency no
    call can skip — and the streaming history threads through the loop
    carry."""
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames="k")
    def run_k(b, h, c, k):
        def body(i, carry):
            h, c = carry
            ch, h = step(b * (1.0 + c * 1e-3 + i * 1e-4), h)
            c = jnp.mean(jnp.abs(ch.ravel()[::4096])) \
                + jnp.real(ch.ravel()[0]) * 1e-3
            return (h, c)
        h, c = jax.lax.fori_loop(0, k, body, (h, c))
        return h, c

    return run_k


def build_single(channelizer: str, n: int, m: int,
                 taps_per_branch: int = 8, fir_taps: int = 129):
    """(run_k, initial history) for the single-device config-4 step."""
    import jax
    import jax.numpy as jnp
    from scipy import signal as sig
    from radiocore_tpu.ops.pfb import pfb_taps, pfb_init, pfb_channelize
    from radiocore_tpu.ops.fir import fir_causal

    taps = pfb_taps(m, taps_per_branch)
    fir = sig.firwin(fir_taps, 0.45).astype(np.float32)
    hist = pfb_init(m, taps_per_branch)

    def band_fir(band):
        # Band-rate FIR on planar f32 through fir_causal's default impl.
        planes = jnp.stack([jnp.real(band), jnp.imag(band)])
        f = fir_causal(planes, fir)
        return jax.lax.complex(f[0], f[1])

    if channelizer == "pfb":
        def step(band, h):
            return pfb_channelize(band_fir(band), taps, m, history=h)
    else:
        # FFT+slice channelizer (bench.py's form): band FFT → static
        # per-channel slices → batched IFFT. Channel grid = PFB grid.
        from radiocore_tpu.ops import fft as _fft
        from radiocore_tpu.ops.channelize import make_extractor
        chunk = n // m
        grid = [((k * chunk + n // 2) % n) - n // 2 for k in range(m)]
        extract = make_extractor(n, tuple(-g for g in grid), chunk)

        def step(band, h):
            ch = extract(_fft.fft(band_fir(band)))  # (m, chunk)
            return jnp.swapaxes(ch, -1, -2), h      # (chunk, m) like PFB

    return wrap_run_k(step), hist


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--band-rate", type=float, default=61.44e6)
    parser.add_argument("--channels", type=int, default=64)
    parser.add_argument("--taps-per-branch", type=int, default=8)
    parser.add_argument("--fir-taps", type=int, default=129)
    parser.add_argument("--seconds", type=float, default=0.25)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--time-shards", type=int, default=0,
                        help=">0: shard the band over a time mesh axis")
    parser.add_argument("--channelizer", default="fft",
                        choices=("fft", "pfb"))
    args = parser.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("wideband: needs a GPU")
    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    from radiocore_tpu.runtime.platform import device_peaks
    enable_persistent_cache()
    import jax.numpy as jnp
    from scipy import signal as sig
    from radiocore_tpu.ops.pfb import pfb_taps, pfb_init, pfb_channelize
    from radiocore_tpu.ops.fir import fir_overlap_save

    m = args.channels
    n = plan_n(args.band_rate, args.seconds, m, args.channelizer)
    taps = pfb_taps(m, args.taps_per_branch)
    fir = sig.firwin(args.fir_taps, 0.45)

    @jax.jit
    def make_band(key):
        planes = 0.1 * jax.random.normal(key, (2, n), jnp.float32)
        return jax.lax.complex(planes[0], planes[1])

    hist = pfb_init(m, args.taps_per_branch)
    run_k = None

    if args.time_shards > 0 and args.channelizer == "fft":
        # Fully distributed config-4 front-end: halo-exchange overlap-
        # save FIR + six-step band FFT + local windowed extraction, all
        # in ONE shard_map — no device materializes the full band or its
        # spectrum (per-device peak ~1/D of the band). The body is the
        # same one the fused pipeline uses (parallel/channelize_sharded).
        from jax.sharding import PartitionSpec as P
        from radiocore_tpu.parallel.mesh import make_radio_mesh, TIME
        from radiocore_tpu.parallel.halo import fir_overlap_save_halo
        from radiocore_tpu.parallel.channelize_sharded import (
            make_extract_body)
        mesh = make_radio_mesh(stations=1, time=args.time_shards,
                               devices=jax.devices()[:args.time_shards])
        chunk = n // m
        grid = [((k * chunk + n // 2) % n) - n // 2 for k in range(m)]
        body = make_extract_body(n, tuple(-g for g in grid), chunk,
                                 args.time_shards, TIME)
        if body is None:
            raise SystemExit(f"no distributed plan for n={n}, "
                             f"C={m}, D={args.time_shards}")

        def local(band, h):
            band, _ = fir_overlap_save_halo(band, fir, TIME)
            return body(band), h          # (C/D, chunk) per device

        step = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(TIME), P()),
            out_specs=(P(TIME, None), P())))
    elif args.time_shards > 0:
        # Sequence-parallel PFB form: per-shard FFTs + halo ppermute
        # only — no full-band gather (parallel/halo.py).
        from jax.sharding import PartitionSpec as P
        from radiocore_tpu.parallel.mesh import make_radio_mesh, TIME
        from radiocore_tpu.parallel.halo import (fir_overlap_save_halo,
                                                 pfb_channelize_halo)
        mesh = make_radio_mesh(stations=1, time=args.time_shards,
                               devices=jax.devices()[:args.time_shards])

        def local(band, h):
            band, _ = fir_overlap_save_halo(band, fir, TIME)
            return pfb_channelize_halo(band, taps, m, TIME,
                                       stream_history=h)

        step = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(TIME), P()),
            out_specs=(P(TIME, None), P())))
    else:
        run_k, hist = build_single(args.channelizer, n, m,
                                   args.taps_per_branch, args.fir_taps)
    if run_k is None:
        run_k = wrap_run_k(step)

    # Timing: a fresh random band per call; a scalar derived from the
    # channel matrix, folded at a non-underflowing scale (1e-3) into the
    # next call's input; float() barriers; the HBM roofline guard.
    iters = args.iters
    bands = [make_band(jax.random.key(i)) for i in range(iters + 1)]
    jax.block_until_ready(bands)

    def fetch(c):
        return float(c)

    # Device-loop protocol: k chained steps inside ONE jitted
    # lax.fori_loop; marginal per-step time from the k=2 and k=10 walls
    # (the per-call dispatch cost cancels in t10 − t2).
    def time_k(k):
        h, chk = run_k(bands[-1], hist, jnp.float32(0), k)
        fetch(chk)  # compile + hard drain
        best = float("inf")
        for _ in range(2):
            fetch(chk)
            t0 = time.perf_counter()
            for i in range(iters):
                h, chk = run_k(bands[i % len(bands)], h, chk, k)
            fetch(chk)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    t2, t10 = time_k(2), time_k(10)
    dt = (t10 - t2) / 8
    epoch_means = [dt]
    suspect = False
    if dt <= 0:
        # Timing noise can make the k=10 wall no larger than the k=2
        # wall (each is best-of-2 over few calls); a non-positive
        # marginal slope means the measurement failed — report the raw
        # walls, null the derived throughput fields, and mark suspect
        # rather than emitting negative/infinite Msps.
        print(json.dumps({
            "metric": "wideband_fir_pfb_msamples_per_s",
            "value": None, "unit": "Msps", "suspect": True,
            "channels": m, "channelizer": args.channelizer,
            "time_shards": args.time_shards,
            "wall_ms_k2": round(t2 * 1e3, 2),
            "wall_ms_k10": round(t10 * 1e3, 2),
            "error": "non-positive marginal slope (t10 <= t2)",
        }))
        return

    # HBM speed-of-light fraction (BASELINE.md: "FIR + FFT kernel
    # throughput ~HBM-bandwidth"). Minimum HBM traffic for the fused
    # step, assuming perfect on-chip reuse of taps/twiddles:
    #   overlap-save FIR: read band + write band           (2 c64 / sample)
    #   PFB polyphase conv + M-FFT: read band + write chans (2 c64 / sample)
    # c64 = 8 bytes. XLA's actual traffic is higher (FFT stages
    # materialize intermediates), so this is a conservative lower bound —
    # the fraction understates true HBM utilization.
    peak = device_peaks()["hbm_bytes_per_s"]
    if args.time_shards > 1:
        peak *= args.time_shards  # aggregate over participating cards
    min_bytes = 4 * n * 8
    # Roofline guard (bench.py): a step faster than the minimum HBM
    # traffic at peak bandwidth is physically impossible — refuse it.
    floor = min_bytes / peak
    valid = [d for d in epoch_means if d >= floor]
    if valid:
        dt = min(valid)
    else:
        dt = max(epoch_means)
        suspect = True
    msps = n / dt / 1e6
    result = {
        "metric": "wideband_fir_pfb_msamples_per_s",
        "value": round(msps, 1),
        "unit": "Msps",
        "band_rate_msps": args.band_rate / 1e6,
        "realtime_factor": round(msps * 1e6 / args.band_rate, 2),
        "channels": m,
        "channelizer": args.channelizer,
        "time_shards": args.time_shards,
        "min_hbm_gbytes_per_s": round(min_bytes / dt / 1e9, 1),
        "wall_ms_k2": round(t2 * 1e3, 2),
        "wall_ms_k10": round(t10 * 1e3, 2),
        "protocol": "device-loop marginal (t10-t2)/8: k chained steps "
                    "in one fori_loop, per-iteration input perturbed by "
                    "the previous iteration's full-channel reduction",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "hbm_speed_of_light_fraction": min_bytes / dt / peak,
    }
    if suspect:
        result["suspect"] = True
    print(json.dumps(result))


if __name__ == "__main__":
    main()

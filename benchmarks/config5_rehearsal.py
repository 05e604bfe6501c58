"""Config-5 rehearsal: ≥100 WBFM stereo stations on a virtual multi-chip
world (BASELINE.md north star: ≥100 real-time channels).

Real multi-chip hardware is not available in this environment, so this
rehearses the config-5 SHAPE end-to-end on CPU:

1. single process, 8 virtual devices: fused channelize+demod pipeline at
   ``--stations`` (default 128) WBFM stations, distributed six-step band
   FFT + station-sharded demod, audio parity vs the unsharded oracle,
   per-chip samples/s;
2. ``--multihost``: 2 separate Python processes x 4 virtual devices
   joined via ``jax.distributed.initialize`` — every collective crosses
   the process boundary (the DCN analog), same station count, checksum
   parity between processes.

Per-chip samples/s on virtual CPU devices is a REHEARSAL number (it
validates the program + collectives, not device speed); the hardware
throughput story lives in bench.py / benchmarks/wideband.py. On GPUs,
each process of a multi-process world must see only its own card
(``CUDA_VISIBLE_DEVICES``).

Prints one JSON line per phase; ``--out`` additionally writes the
combined artifact. Reference analog: the reference serves 3 stations
from one sequential loop (``examples/multi_fm_server.py:100-106``) —
this is the scaled, sharded replacement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone_snr_db(audio, fs: int, tone_hz: float) -> float:
    import numpy as np
    x = np.asarray(audio, np.float64)
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    bin_hz = fs / len(x)
    k = int(round(tone_hz / bin_hz))
    sig = spec[max(k - 2, 0):k + 3].sum()
    noise = spec.sum() - sig
    return 10 * np.log10(sig / max(noise, 1e-30))


def single_process_rehearsal(n_stations: int, station_chunk: int,
                             audio_chunk: int, iters: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from radiocore_tpu.apps.iq import SyntheticFmSource
    from radiocore_tpu.parallel.mesh import make_radio_mesh
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]

    # Real FM content (constant-envelope stations), not noise: noise
    # demod is ill-conditioned — angle() of near-zero IQ samples flips
    # by π under the distributed FFT's ~1e-7 rounding differences, so
    # max-abs audio parity between two CORRECT implementations fails.
    # With FM stations the envelope is bounded away from zero and
    # parity is meaningful (and tone SNR validates end-to-end demod).
    # Tones kept inside the audio passband (audio nyquist = audio_chunk/2).
    tones = [(300.0 + (i % 40) * 90.0, 800.0 + (i % 40) * 90.0)
             for i in range(n_stations)]
    src = SyntheticFmSource(n_band, offsets, station_chunk, tones=tones)
    band = jnp.asarray(src.read_chunk(1.0))

    # Unsharded oracle (single device).
    step1, state1 = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk)
    want, _ = step1(band, state1)
    want = np.asarray(want)

    # Sharded: all 8 virtual devices, distributed front-end.
    mesh = make_radio_mesh()
    n_dev = int(mesh.devices.size)
    t0 = time.perf_counter()
    step, state = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk, mesh=mesh)
    audio, state = step(band, state)
    jax.block_until_ready(audio)
    compile_s = time.perf_counter() - t0

    got = np.asarray(audio)
    err = float(np.max(np.abs(got - want)))
    parity_ok = err < 1e-3  # ±1-clipped audio; distributed-FFT f32 rounding

    # Spot-check demod quality: the expected stereo tones must dominate
    # the audio spectrum on stations across the band (first/middle/last).
    snrs = {}
    for i in (0, n_stations // 2, n_stations - 1):
        fl, fr = src.tones[i]
        snrs[i] = (round(_tone_snr_db(got[i, 500:-500, 0],
                                      audio_chunk, fl), 1),
                   round(_tone_snr_db(got[i, 500:-500, 1],
                                      audio_chunk, fr), 1))
    snr_ok = all(s[0] > 6 and s[1] > 6 for s in snrs.values())
    parity_ok = parity_ok and snr_ok

    # Timed steps (chained on an audio-derived scalar, which keeps the
    # steps strictly serial).
    jitter = jax.jit(lambda b, c: b * (1.0 + c * 1e-3))
    chk_fn = jax.jit(lambda a: jnp.mean(jnp.abs(a)))
    chk = chk_fn(audio)
    float(chk)
    t0 = time.perf_counter()
    for _ in range(iters):
        audio, state = step(jitter(band, chk), state)
        chk = chk_fn(audio)
    float(chk)
    dt = (time.perf_counter() - t0) / iters

    row = {
        "phase": "single_process_virtual8",
        "stations": n_stations,
        "station_rate": station_chunk,
        "devices": n_dev,
        "mesh": dict(mesh.shape),
        "audio_max_abs_diff_vs_unsharded": err,
        "tone_snr_db": {str(k): v for k, v in snrs.items()},
        "parity_ok": parity_ok,
        "sec_per_chunk": round(dt, 3),
        # CPU-VIRTUAL wall clock: 8 virtual devices share this host's few
        # cores, so these two fields measure host contention, NOT chip
        # throughput (see bench.py / wideband.py for card numbers; the
        # correctness columns above are this phase's product).
        "cpu_virtual_iq_msps_per_device_NOT_A_DEVICE_RATE": round(
            n_band / dt / n_dev / 1e6, 3),
        "cpu_virtual_realtime_channels_NOT_A_DEVICE_RATE": round(n_stations / dt, 2),
        "compile_plus_first_step_s": round(compile_s, 1),
    }
    print(json.dumps(row), flush=True)
    return row


def multihost_rehearsal(n_stations: int, station_chunk: int,
                        audio_chunk: int, iters: int) -> dict:
    """2 processes x 4 virtual devices, stations spread over all 8."""
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()

    nprocs, local = 2, 4
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={local}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(nprocs), coord,
             str(local), str(n_stations), str(station_chunk),
             str(audio_chunk), str(iters)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=1800)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID we spawned
    wall = time.perf_counter() - t0

    vals = []
    for rc, out, err in outs:
        if rc != 0:
            raise RuntimeError(f"worker rc={rc}\n{err[-3000:]}")
        m = re.search(r"CHECKSUM (\S+) HALO (\S+) SPS (\S+) CHIPS (\d+)"
                      r"(?: COLLBYTES (\d+))?", out)
        if m is None:
            raise RuntimeError(f"no checksum line in {out!r}")
        vals.append((float(m.group(1)), float(m.group(3)),
                     int(m.group(4)),
                     int(m.group(5)) if m.group(5) else None))

    agree = abs(vals[0][0] - vals[1][0]) <= 1e-6 * abs(vals[0][0])
    chips = vals[0][2]
    row = {
        "phase": "multihost_2proc_x4dev",
        "stations": n_stations,
        "station_rate": station_chunk,
        "processes": nprocs,
        "devices": chips,
        "checksum_parity_ok": agree,
        "checksums": [v[0] for v in vals],
        # CPU-VIRTUAL wall clock (see single-process phase note).
        "cpu_virtual_iq_msps_per_device_NOT_A_DEVICE_RATE": round(
            vals[0][1] / chips / 1e6, 3),
        "cpu_virtual_realtime_channels_NOT_A_DEVICE_RATE": round(
            vals[0][1] / station_chunk, 2),
        "collective_bytes_per_process": [v[3] for v in vals],
        "wall_s": round(wall, 1),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stations", type=int, default=128)
    parser.add_argument("--station-rate", type=float, default=50e3)
    parser.add_argument("--audio-rate", type=float, default=10e3)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    # Virtual 8-device CPU world; must be set before first device use.
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")

    rows = [single_process_rehearsal(
        args.stations, int(args.station_rate), int(args.audio_rate),
        args.iters)]
    if args.multihost:
        rows.append(multihost_rehearsal(
            args.stations, int(args.station_rate), int(args.audio_rate),
            args.iters))

    ok = all(r.get("parity_ok", r.get("checksum_parity_ok")) for r in rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"config5_rehearsal": rows, "ok": ok}, f, indent=1)
    print(json.dumps({"config5_rehearsal": "PASS" if ok else "FAIL"}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of radiocore on NVIDIA GPUs: the main paths at user sizes.

    python chip_smoke.py               # one card: the four phases below
    python chip_smoke.py --four-cards  # four cards: sharded vs one card

One card runs, through the entry points a user calls, with IQ fed from
the host:

* ``receive_fm``: ``apps/receive_fm.run`` at the reference rates
  (2.4 MS/s in, 240 kS/s demod, 48 kHz stereo out, exact WBFM);
* ``multi_fm_server_fused``: ``apps/multi_fm_server.serve_fused`` with
  64 WBFM stations of 262 144 S/s (a 2^24-sample, 16.8 MS/s band);
  two stations are checked against the float64 SciPy oracle;
* ``multi_fm_server_mixed``: ``serve`` with the CLI's default wbfm, mfm
  and fm stations in a 10 MS/s band;
* ``fir_precision``: the 129-tap band FIR on 2^24 planar samples against
  ``scipy.signal.lfilter`` in float64 (a TF32 contraction would miss the
  1e-5 bound by two orders).

``--four-cards`` runs only the sharded paths against the one-card path
on the same input: the distributed fused step on 4×1 and 2×2 meshes,
and the halo-exchange zero-phase FIR.

Each phase prints one JSON line with its check values, compile time and
steady step time. The last line is ``{"ok": true, "device": {...}}``,
printed only when every check passed. The script exits non-zero, and
prints no such line, unless JAX's first device is a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


class _ListSink:
    """Audio sink that keeps every chunk it is given."""

    def __init__(self):
        self.chunks = []

    def write(self, audio):
        self.chunks.append(np.array(audio, dtype=np.float32))


def _recording_timer():
    """A StageTimer that also keeps each stage's duration in order."""
    from radiocore_tpu.runtime.profiling import StageTimer

    class RecordingTimer(StageTimer):
        def __init__(self):
            super().__init__()
            self.events = []

        @contextlib.contextmanager
        def stage(self, name, sync_value=None):
            t0 = time.perf_counter()
            with super().stage(name, sync_value):
                yield
            self.events.append((name, time.perf_counter() - t0))

        def chunk_seconds(self, first, host_stages=("source", "ring_get")):
            """Per-chunk time of the device-facing stages: everything
            from one ``first`` stage to the next, host IQ sources left
            out (the synthetic source is not part of the served path)."""
            chunks = []
            for name, dt in self.events:
                if name in host_stages:
                    continue
                if name == first:
                    chunks.append(0.0)
                if chunks:
                    chunks[-1] += dt
            return chunks

    return RecordingTimer()


def _timing(chunk_s):
    """Compile (first chunk) and steady (median of the rest) seconds."""
    return {"compile_and_first_chunk_s": chunk_s[0],
            "steady_step_s": statistics.median(chunk_s[1:]),
            "chunk_s": chunk_s}


def _steady_s(run, reps=5):
    """Median seconds of ``run()`` to ready output, after one warm call."""
    import jax

    jax.block_until_ready(run())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _oracles():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracles
    return oracles


def phase_receive_fm(input_rate=2_400_000, demod_rate=240_000,
                     audio_rate=48_000, seconds=3, tones=(440.0, 1000.0)):
    """Single-station receiver, exact WBFM, fed through the app's own
    RingBuffer and IngestPipe. Bounds: tone SNR > 20 dB each side,
    stereo separation > 10 dB."""
    from radiocore_tpu.apps import receive_fm as rx
    from radiocore_tpu.apps.iq import SyntheticFmSource

    oracles = _oracles()
    cfg = rx.Config(input_rate=input_rate, demod_rate=demod_rate,
                    audio_rate=audio_rate)
    source = SyntheticFmSource(input_rate, [0], demod_rate,
                               tones=[tones])
    sink, timer = _ListSink(), _recording_timer()
    rx.run(cfg, source, sink, seconds, timer=timer, wbfm_mode="exact",
           ring_seconds=seconds + 1)
    audio = np.stack(sink.chunks)
    left, right = audio[-1, :, 0], audio[-1, :, 1]
    snr_l = oracles.tone_snr_db(left, audio_rate, tones[0])
    snr_r = oracles.tone_snr_db(right, audio_rate, tones[1])
    leak = oracles.tone_snr_db(right, audio_rate, tones[0])
    checks = {
        "chunks": len(sink.chunks) == seconds,
        "shape": audio.shape[1:] == (audio_rate, 2),
        "finite": bool(np.isfinite(audio).all()),
        "left_snr_db": snr_l > 20.0,
        "right_snr_db": snr_r > 20.0,
        "separation_db": snr_r - leak > 10.0,
    }
    return {"phase": "receive_fm", "left_snr_db": snr_l,
            "right_snr_db": snr_r, "separation_db": snr_r - leak,
            **_timing(timer.chunk_seconds("decimate")), "checks": checks}


class _RecordingSource:
    """Wraps a band source; keeps the float64 oracle extraction of a few
    stations from every chunk it hands out."""

    def __init__(self, source, shifts, bandwidth, oracles):
        self._source = source
        self._shifts = shifts
        self._m = bandwidth
        self._oracles = oracles
        self.station_iq = {k: [] for k in shifts}

    def read_chunk(self, seconds=1.0):
        band = self._source.read_chunk(seconds)
        spectrum = np.fft.fft(band.astype(np.complex128))
        for k, shift in self._shifts.items():
            self.station_iq[k].append(self._oracles.extract_channel(
                spectrum, shift, self._m))
        return band


def phase_multi_fm_server_fused(n_stations=64, station_rate=262_144,
                                audio_rate=49_152, seconds=3,
                                oracle_stations=(0, 32), trim=1000):
    """Fused all-WBFM server (fast mode). Bounds: worst-station tone
    SNR > 15 dB; match against the float64 oracle > 30 dB, the bound
    fast mode states."""
    from radiocore_tpu.apps import multi_fm_server as srv
    from radiocore_tpu.apps.iq import SyntheticFmSource

    oracles = _oracles()
    specs = [srv.StationSpec(96.9e6 + i * station_rate, "wbfm",
                             station_rate) for i in range(n_stations)]
    center = (specs[0].frequency + specs[-1].frequency) / 2
    offsets = [int(s.frequency - center) for s in specs]
    n_band = n_stations * station_rate
    synth = SyntheticFmSource(n_band, offsets, station_rate)
    source = _RecordingSource(synth, {k: -offsets[k] for k in
                                      oracle_stations},
                              station_rate, oracles)
    sinks = [_ListSink() for _ in specs]
    timer = _recording_timer()
    srv.serve_fused(specs, n_band, audio_rate, source, seconds,
                    sinks=sinks, mode="fast", timer=timer)

    audio = np.stack([np.stack(s.chunks) for s in sinks])  # (S, T, A, 2)
    last = audio[:, -1]
    tone_snr = [min(oracles.tone_snr_db(last[i, :, 0], audio_rate, fl),
                    oracles.tone_snr_db(last[i, :, 1], audio_rate, fr))
                for i, (fl, fr) in enumerate(synth.tones)]
    match = []
    for k in oracle_stations:
        state = None
        for t, iq in enumerate(source.station_iq[k]):
            want, state = oracles.wbfm(iq, station_rate, audio_rate,
                                       state=state)
            for ch in range(2):
                match.append(oracles.snr_db(want[trim:-trim, ch],
                                            audio[k, t, trim:-trim, ch]))
    checks = {
        "chunks": audio.shape[1] == seconds,
        "shape": audio.shape[2:] == (audio_rate, 2),
        "finite": bool(np.isfinite(audio).all()),
        "worst_station_tone_snr_db": min(tone_snr) > 15.0,
        "oracle_match_snr_db": min(match) > 30.0,
    }
    return {"phase": "multi_fm_server_fused", "stations": n_stations,
            "band_samples": n_band,
            "worst_station_tone_snr_db": min(tone_snr),
            "oracle_stations": list(oracle_stations),
            "oracle_match_snr_db": min(match),
            **_timing(timer.chunk_seconds("fused_step")), "checks": checks}


def phase_multi_fm_server_mixed(band_rate=10e6, bandwidth=240e3,
                                audio_rate=48e3, seconds=2):
    """The server's default CLI shape: wbfm, mfm and fm stations 400 kHz
    apart through the Tuner loop. Bounds: every station finite and not
    silent; the WBFM station's left tone SNR > 6 dB."""
    from radiocore_tpu.apps import multi_fm_server as srv
    from radiocore_tpu.apps.iq import SyntheticFmSource

    oracles = _oracles()
    modes = ("wbfm", "mfm", "fm")
    specs = [srv.StationSpec(96.9e6 + i * 400e3, mode, bandwidth)
             for i, mode in enumerate(modes)]
    tuner = srv.build_tuner(specs, audio_rate, band_rate)
    offsets = [int(s.frequency - tuner.input_frequency) for s in specs]
    source = SyntheticFmSource(int(tuner.input_bandwidth), offsets,
                               int(bandwidth))
    sinks = [_ListSink() for _ in specs]
    timer = _recording_timer()
    srv.serve(tuner, source, seconds, sinks=sinks, timer=timer)

    rms = [float(np.sqrt(np.mean(np.square(s.chunks[-1])))) for s in sinks]
    wbfm_left = oracles.tone_snr_db(sinks[0].chunks[-1][:, 0], audio_rate,
                                    source.tones[0][0])
    checks = {
        "chunks": all(len(s.chunks) == seconds for s in sinks),
        "finite": all(np.isfinite(c).all() for s in sinks
                      for c in s.chunks),
        "not_silent": min(rms) > 1e-3,
        "wbfm_left_snr_db": wbfm_left > 6.0,
    }
    return {"phase": "multi_fm_server_mixed", "modes": list(modes),
            "band_samples": int(tuner.input_bandwidth),
            "station_rms": rms, "wbfm_left_snr_db": wbfm_left,
            **_timing(timer.chunk_seconds("tuner_load")), "checks": checks}


def phase_fir_precision(n=1 << 24, num_taps=129, reps=5, seed=0):
    """Band FIR (``ops.fir.fir_causal``, planar f32) against float64
    ``lfilter``, through each lowering. Bound: max error over max
    output < 1e-5."""
    import jax
    import jax.numpy as jnp
    from scipy import signal as sig
    from radiocore_tpu.ops.fir import fir_causal

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n)).astype(np.float32)
    taps = sig.firwin(num_taps, 0.45)
    want = sig.lfilter(taps, 1.0, x.astype(np.float64), axis=-1)
    x_dev = jnp.asarray(x)
    out = {"phase": "fir_precision", "samples": n, "taps": num_taps,
           "checks": {}}
    for impl in ("auto", "conv", "fft"):
        fn = jax.jit(lambda v, _impl=impl: fir_causal(v, taps, impl=_impl))
        t0 = time.perf_counter()
        got = np.asarray(fn(x_dev))
        compile_s = time.perf_counter() - t0
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        out[f"{impl}_rel_err"] = rel
        out[f"{impl}_compile_and_first_s"] = compile_s
        out[f"{impl}_steady_s"] = _steady_s(lambda: fn(x_dev), reps)
        out["checks"][f"{impl}_rel_err"] = rel < 1e-5
    return out


def phase_four_cards(n_stations=64, station_rate=262_144,
                     audio_rate=49_152, fir_n=1 << 24, num_taps=129,
                     meshes=((4, 1), (2, 2)), devices=None):
    """Sharded paths against the one-card path on the same input.

    Tolerances, both set by summation order: the six-step sharded band
    FFT adds in another order than the one-card cuFFT transform, so the
    spectra differ by f32 rounding (~1e-6 relative); the demod's phase
    differencing lifts that to ~1e-5 on the ±1 audio, and 1e-3 leaves
    two orders of headroom. The halo FIR computes the same sums as the
    one-card FIR but with blocks cut at other places: 1e-5 of the output
    peak, the FIR bound of the one-card phase.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scipy import signal as sig
    from radiocore_tpu.apps.iq import SyntheticFmSource
    from radiocore_tpu.ops.fir import zero_phase_fir
    from radiocore_tpu.parallel.halo import zero_phase_fir_sharded
    from radiocore_tpu.parallel.mesh import STATIONS, TIME, make_radio_mesh
    from radiocore_tpu.parallel.pipeline import (_make_distributed_fused,
                                                 make_multi_station_step)

    devices = list(devices if devices is not None else jax.devices()[:4])
    n_band = n_stations * station_rate
    half = n_band // 2 - station_rate // 2
    offsets = [-half + i * station_rate for i in range(n_stations)]
    band = SyntheticFmSource(n_band, offsets, station_rate).read_chunk()

    step, state = make_multi_station_step(n_band, offsets, station_rate,
                                          audio_rate, mode="fast")
    band_one = jnp.asarray(band)
    want = np.asarray(step(band_one, state)[0])
    out = {"phase": "four_cards", "devices": len(devices),
           "stations": n_stations, "band_samples": n_band, "checks": {},
           "one_card_steady_step_s": _steady_s(
               lambda: step(band_one, state)[0])}
    for s, t in meshes:
        mesh = make_radio_mesh(stations=s, time=t, devices=devices)
        name = f"mesh_{s}x{t}"
        engaged = _make_distributed_fused(mesh, n_band, offsets,
                                          station_rate) is not None
        step_sh, state_sh = make_multi_station_step(
            n_band, offsets, station_rate, audio_rate, mesh=mesh,
            mode="fast")
        # The band arrives already split over the cards, as the
        # distributed front-end reads it.
        band_sh = jax.device_put(
            band, NamedSharding(mesh, P((STATIONS, TIME))))
        t0 = time.perf_counter()
        got = np.asarray(step_sh(band_sh, state_sh)[0])
        out[f"{name}_compile_and_first_s"] = time.perf_counter() - t0
        out[f"{name}_steady_step_s"] = _steady_s(
            lambda: step_sh(band_sh, state_sh)[0])
        diff = float(np.max(np.abs(got - want)))
        out[f"{name}_max_abs_diff"] = diff
        out["checks"][f"{name}_distributed_path"] = engaged
        out["checks"][f"{name}_max_abs_diff"] = diff < 1e-3

    rng = np.random.default_rng(1)
    x = rng.standard_normal(fir_n).astype(np.float32)
    taps = sig.firwin(num_taps, 0.2)
    fir_want = np.asarray(jax.jit(lambda v: zero_phase_fir(v, taps))(x))
    mesh = make_radio_mesh(stations=1, time=len(devices), devices=devices)
    fir_got = np.asarray(jax.jit(
        lambda v: zero_phase_fir_sharded(v, taps, mesh))(jnp.asarray(x)))
    edge = 3 * num_taps
    rel = float(np.max(np.abs(fir_got[edge:-edge] - fir_want[edge:-edge]))
                / np.max(np.abs(fir_want)))
    out["halo_fir_rel_err"] = rel
    out["checks"]["halo_fir_rel_err"] = rel < 1e-5
    return out


def _json(obj) -> str:
    """One JSON line; NumPy scalars print as their Python values."""
    return json.dumps(obj, default=lambda v: v.item())


def _gpu_devices(count):
    """JAX's devices, or exit non-zero unless they are ``count`` GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found platform "
                 f"{devices[0].platform!r}, not a GPU")
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found "
                 f"{len(devices)}")
    return devices[:count]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths on four cards")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1
    devices = _gpu_devices(count)

    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    phases = ([lambda: phase_four_cards(devices=devices)] if args.four_cards
              else [phase_receive_fm, phase_multi_fm_server_fused,
                    phase_multi_fm_server_mixed, phase_fir_precision])
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        result = phase()
        result["phase_s"] = time.perf_counter() - t0
        result["ok"] = bool(all(result["checks"].values()))
        ok &= result["ok"]
        print(_json(result), flush=True)
    if not ok:
        print("chip_smoke: a check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

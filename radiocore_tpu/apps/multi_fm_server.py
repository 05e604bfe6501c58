"""Multi-station FM server (reference: ``examples/multi_fm_server.py``).

Channelizes a wide band into stations, demodulates all of them, and
publishes each station's audio on ZeroMQ PUB with the 4-byte
little-endian center-frequency topic
(reference: multi_fm_server.py:105-120, tuner.py:33-35).

Batched inversion: the reference loops channels sequentially
(reference: multi_fm_server.py:100-106); here the Tuner extracts ALL
channels in one batched gather+IFFT (``Tuner.run_all``) and per-channel
demod runs on the already-resident station IQ.

Run headless (no SDR, ZMQ optional):
    python -m radiocore_tpu.apps.multi_fm_server --seconds 2 --no-zmq
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radiocore_tpu.models.fm import FM
from radiocore_tpu.models.mfm import MFM
from radiocore_tpu.models.wbfm import WBFM
from radiocore_tpu.runtime.metrics import Metrics
from radiocore_tpu.runtime.profiling import StageTimer
from radiocore_tpu.tools.tuner import Tuner
from radiocore_tpu.apps.iq import SyntheticFmSource, IQFileSource, WavSink

DEMODS = {"fm": FM, "mfm": MFM, "wbfm": WBFM}


@dataclasses.dataclass
class StationSpec:
    frequency: float
    mode: str = "wbfm"
    bandwidth: float = 240e3


def build_tuner(stations: Sequence[StationSpec], audio_rate: float,
                request_bandwidth: Optional[float] = None) -> Tuner:
    """Register stations with demodulators, reference-style
    (reference: multi_fm_server.py:125-136)."""
    tuner = Tuner()
    for spec in stations:
        demod = DEMODS[spec.mode](spec.bandwidth, audio_rate)
        tuner.add_channel(spec.frequency, spec.bandwidth, demod)
    if request_bandwidth:
        tuner.request_bandwidth(request_bandwidth)
    return tuner


def serve(tuner: Tuner, source, seconds: float,
          publisher=None, sinks: Optional[List] = None,
          metrics: Optional[Metrics] = None,
          timer: Optional[StageTimer] = None) -> None:
    """Main DSP loop: load 1 s, extract all channels, demod, publish."""
    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    homogeneous = len({int(c.bandwidth) for c in tuner.channels()}) == 1
    for _ in range(int(round(seconds))):
        with timer.stage("source"):
            chunk = source.read_chunk(1.0)
        t0 = time.monotonic()
        with timer.stage("tuner_load"):
            tuner.load(chunk)
        if homogeneous:
            with timer.stage("extract_all"):
                stations_iq = tuner.run_all()
        for i, channel in enumerate(tuner.channels()):
            with timer.stage("extract"):
                iq = stations_iq[i] if homogeneous else tuner.run(i)
            with timer.stage("demod"):
                audio = channel.demodulator.run(iq)
            with timer.stage("publish"):
                if publisher is not None:
                    publisher.send_multipart(
                        [channel.address_bytes,
                         np.ascontiguousarray(audio, np.float32).tobytes()])
                if sinks:
                    sinks[i].write(audio)
        metrics.incr("chunks")
        metrics.gauge("chunk_seconds", time.monotonic() - t0)


def serve_fused(specs: Sequence[StationSpec], band_rate: float,
                audio_rate: float, source, seconds: float,
                publisher=None, sinks: Optional[List] = None,
                metrics: Optional[Metrics] = None,
                mode: str = "fast",
                timer: Optional[StageTimer] = None) -> None:
    """All-WBFM serving through the single fused jitted step.

    One XLA program per second: band FFT → all-station extraction →
    batched WBFM (parallel/pipeline.py). Requires homogeneous WBFM
    stations (the scaling workload of BASELINE.md configs 3–5).
    """
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    n_band = int(band_rate)
    center = (min(s.frequency for s in specs) +
              max(s.frequency for s in specs)) / 2
    offsets = [int(s.frequency - center) for s in specs]
    bw = int(specs[0].bandwidth)
    step, state = make_multi_station_step(
        n_band, offsets, bw, int(audio_rate), mode=mode)
    topics = [int(s.frequency).to_bytes(4, "little") for s in specs]

    from radiocore_tpu.runtime.ingest import IngestPipe
    pipe = IngestPipe(depth=2)  # overlap chunk N+1's H2D with N's demod

    def host_chunks():
        for _ in range(int(round(seconds))):
            with timer.stage("source"):
                yield source.read_chunk(1.0)

    for band in pipe.stream(host_chunks()):
        t0 = time.monotonic()
        with timer.stage("fused_step"):
            audio_all, state = step(band, state)
        with timer.stage("fetch", sync_value=audio_all):
            audio_np = np.asarray(audio_all)
        with timer.stage("publish"):
            for i, topic in enumerate(topics):
                if publisher is not None:
                    publisher.send_multipart(
                        [topic, np.ascontiguousarray(
                            audio_np[i], np.float32).tobytes()])
                if sinks:
                    sinks[i].write(audio_np[i])
        metrics.incr("chunks")
        metrics.gauge("chunk_seconds", time.monotonic() - t0)


def main(argv=None) -> None:
    """CLI entry: serve N stations as ZMQ PUB topics (see --help)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stations", type=int, default=3)
    parser.add_argument("--band-rate", type=float, default=10e6,
                        help="requested SDR bandwidth "
                             "(reference: multi_fm_server.py:136)")
    parser.add_argument("--bandwidth", type=float, default=240e3)
    parser.add_argument("--audio-rate", type=float, default=48e3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--bind", default="tcp://*:5555")
    parser.add_argument("--no-zmq", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="all-WBFM single-jitted-step pipeline "
                             "(batched channelize+demod)")
    parser.add_argument("--wav-prefix", default=None,
                        help="also write each station to PREFIX_<i>.wav")
    args = parser.parse_args(argv)

    base = 96.9e6
    modes = ["wbfm"] * 3 if args.fused else ["wbfm", "mfm", "fm"]
    specs = [StationSpec(base + i * 400e3,
                         modes[i % 3], args.bandwidth)
             for i in range(args.stations)]
    tuner = build_tuner(specs, args.audio_rate, args.band_rate)

    n_band = int(tuner.input_bandwidth)
    offsets = [int(s.frequency - tuner.input_frequency) for s in specs]
    source = SyntheticFmSource(n_band, offsets, int(args.bandwidth))

    publisher = None
    if not args.no_zmq:
        import zmq
        ctx = zmq.Context()
        publisher = ctx.socket(zmq.PUB)
        publisher.bind(args.bind)

    sinks = None
    if args.wav_prefix:
        sinks = [WavSink(f"{args.wav_prefix}_{i}.wav", int(args.audio_rate))
                 for i in range(len(specs))]

    metrics = Metrics()
    timer = StageTimer()
    try:
        if args.fused:
            serve_fused(specs, tuner.input_bandwidth, args.audio_rate,
                        source, args.seconds, publisher, sinks, metrics,
                        timer=timer)
        else:
            serve(tuner, source, args.seconds, publisher, sinks, metrics,
                  timer=timer)
    finally:
        if sinks:
            for s in sinks:
                s.close()
        if publisher is not None:
            publisher.close()
    snap = metrics.snapshot()
    print(f"served {int(snap['chunks'])} chunks x {len(specs)} stations, "
          f"last chunk {snap['chunk_seconds']:.3f}s")
    stages = ", ".join(f"{k} {v['mean_ms']:.1f} ms"
                       for k, v in sorted(timer.report().items()))
    if stages:
        print(f"stage profile: {stages}")


if __name__ == "__main__":
    main()

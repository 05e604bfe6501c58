"""Runtime layer: metrics, profiling timers, config, platform probe."""

import time

import numpy as np

from radiocore_tpu.runtime.metrics import Metrics
from radiocore_tpu.runtime.profiling import StageTimer
from radiocore_tpu.runtime.config import (PipelineConfig, StationConfig,
                                          MeshConfig)
from radiocore_tpu.runtime.platform import (HasCuda, device_platform,
                                            platform_summary)
from radiocore_tpu.runtime.transfer import to_device_c64, to_host


def test_metrics_counters_and_gauges():
    m = Metrics()
    m.incr("chunks")
    m.incr("chunks", 2)
    m.gauge("occupancy", 0.5)
    snap = m.snapshot()
    assert snap["chunks"] == 3
    assert snap["occupancy"] == 0.5
    assert snap["uptime_s"] >= 0
    assert m.realtime_factor(100.0) > 0


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2
    assert rep["a"]["total_s"] >= 0.01
    assert "a:" in repr(t)


def test_pipeline_config_chunks():
    cfg = PipelineConfig(input_rate=10e6, demod_rate=250e3, audio_rate=48e3,
                         stations=(StationConfig(96.9e6),),
                         mesh=MeshConfig(stations=4, time=2))
    assert cfg.chunk_size == 10_000_000
    assert cfg.demod_chunk == 250_000
    assert cfg.audio_chunk == 48_000
    assert cfg.mesh.n_devices == 8
    hash(cfg)  # frozen → usable as a jit static argument


def test_platform_probe_cpu():
    assert device_platform() == "cpu"  # conftest forces the CPU platform
    assert HasCuda() is False
    summary = platform_summary()
    assert summary["platform"] == "cpu"
    assert summary["n_devices"] == 8
    assert summary["has_cuda"] is False


def test_transfer_roundtrip():
    x = (np.arange(10) + 1j * np.arange(10)).astype(np.complex64)
    dev = to_device_c64(x)
    np.testing.assert_array_equal(to_host(dev), x)
    r = to_device_c64(np.arange(4, dtype=np.float32))
    assert r.dtype == np.complex64

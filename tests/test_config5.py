"""Config-5 rehearsal tests: ≥100 WBFM stations (BASELINE.md north star).

The ≥100-station config-5 shape runs on the 8-virtual-device CPU mesh
(single process) and across a REAL 2-process ``jax.distributed`` world —
the same checks ``benchmarks/config5_rehearsal.py`` records. It stays on
the CPU: on GPUs, each process must see only its own card
(``CUDA_VISIBLE_DEVICES``).

Reference analog: the reference serves 3 stations from a sequential
per-channel loop (``examples/multi_fm_server.py:100-106``); nothing in
it scales past one device.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")

N_STATIONS = 128
STATION_CHUNK = 50_000
AUDIO_CHUNK = 10_000


def test_128_station_sharded_parity_and_quality():
    """Fused pipeline at 128 stations on the 8-device mesh: sharded ==
    unsharded on real FM content, and the demodulated tones are clean.

    FM content (constant envelope) rather than noise: angle() of
    near-zero noise IQ is ill-conditioned — the distributed FFT's ~1e-7
    rounding flips such samples by π, so noise max-abs parity fails even
    between two CORRECT implementations at this band size.
    """
    from radiocore_tpu.apps.iq import SyntheticFmSource
    from radiocore_tpu.parallel.mesh import make_radio_mesh
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    n_band = N_STATIONS * STATION_CHUNK
    half = n_band // 2 - STATION_CHUNK // 2
    offsets = [int(-half + i * STATION_CHUNK) for i in range(N_STATIONS)]
    tones = [(300.0 + (i % 40) * 90.0, 800.0 + (i % 40) * 90.0)
             for i in range(N_STATIONS)]
    src = SyntheticFmSource(n_band, offsets, STATION_CHUNK, tones=tones)
    band = jnp.asarray(src.read_chunk(1.0))

    step1, state1 = make_multi_station_step(
        n_band, offsets, STATION_CHUNK, AUDIO_CHUNK)
    want, _ = step1(band, state1)
    want = np.asarray(want)

    mesh = make_radio_mesh()  # all 8 virtual devices on the station axis
    step, state = make_multi_station_step(
        n_band, offsets, STATION_CHUNK, AUDIO_CHUNK, mesh=mesh)
    got, _ = step(band, state)
    got = np.asarray(got)

    assert got.shape == (N_STATIONS, AUDIO_CHUNK, 2)
    np.testing.assert_allclose(got, want, atol=1e-3)

    import oracles
    for i in (0, N_STATIONS // 2, N_STATIONS - 1):
        fl, fr = tones[i]
        assert oracles.tone_snr_db(
            got[i, 500:-500, 0], AUDIO_CHUNK, fl) > 6, f"station {i} L"
        assert oracles.tone_snr_db(
            got[i, 500:-500, 1], AUDIO_CHUNK, fr) > 6, f"station {i} R"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_128_station_multihost_parity():
    """128 stations across a real 2-process distributed world: both
    processes complete, agree bitwise on the audio checksum, and report
    per-chip throughput (the config-5 scaling observable)."""
    nprocs, local = 2, 4
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local}")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nprocs), coord,
             str(local), str(N_STATIONS), str(STATION_CHUNK),
             str(AUDIO_CHUNK), "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID we spawned

    vals = []
    for rc, out, err in outs:
        assert rc == 0, f"worker rc={rc}\n{err[-3000:]}"
        m = re.search(r"CHECKSUM (\S+) HALO \S+ SPS (\S+) CHIPS (\d+)", out)
        assert m is not None, out
        vals.append((float(m.group(1)), float(m.group(2)),
                     int(m.group(3))))

    assert vals[0][2] == nprocs * local
    assert vals[0][0] == pytest.approx(vals[1][0], rel=1e-7)
    assert vals[0][1] > 0  # samples/s recorded

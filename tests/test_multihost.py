"""Real multi-process distributed runtime test (BASELINE.md config 5).

Spawns 2 separate Python processes, each with 4 virtual CPU devices,
joined via ``jax.distributed.initialize`` into one 8-device world. The
fused channelize+WBFM pipeline and the ppermute halo-exchange FIR run
over a global mesh whose ``time`` axis straddles the process boundary,
so every collective (band-FFT all-gather, halo ppermute, checksum psum)
actually crosses the distributed runtime — the analog of a multi-host
deployment (SURVEY.md §2.5; the reference's only inter-process
transport is ZeroMQ, ``examples/multi_fm_server.py:116-120``). It stays
on the CPU: on GPUs, each process must see only its own card
(``CUDA_VISIBLE_DEVICES``).

Verifies both processes agree AND match the single-process oracle.
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

N_PROCS = 2
LOCAL_DEVICES = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(N_PROCS), coord,
             str(LOCAL_DEVICES)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(N_PROCS)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID we spawned
    return outs


@pytest.fixture(scope="module")
def worker_outputs():
    return _spawn_workers()


def _parse(out: str):
    m = re.search(r"CHECKSUM (\S+) HALO (\S+)", out)
    assert m is not None, f"no checksum line in: {out!r}"
    return float(m.group(1)), float(m.group(2))


def test_both_processes_succeed(worker_outputs):
    for rc, out, err in worker_outputs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"


def test_processes_agree(worker_outputs):
    vals = [_parse(out) for _, out, _ in worker_outputs]
    assert vals[0] == pytest.approx(vals[1], rel=1e-6)


def test_matches_single_process_oracle(worker_outputs):
    """The cross-process run must reproduce the single-process numbers."""
    from radiocore_tpu.parallel.pipeline import make_multi_station_step

    rc, out, err = worker_outputs[0]
    assert rc == 0, err[-3000:]
    dist_checksum, dist_halo = _parse(out)

    # Same config as the worker, no mesh (single process, one device).
    n_stations = (N_PROCS * LOCAL_DEVICES) // N_PROCS  # mesh stations axis
    station_chunk = 50_000
    audio_chunk = 10_000
    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]

    step, state = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk)

    @jax.jit
    def make_band(key):
        planes = 0.1 * jax.random.normal(key, (2, n_band), jnp.float32)
        return jax.lax.complex(planes[0], planes[1])

    band = make_band(jax.random.key(7))
    audio, state = step(band, state)
    audio, state = step(band, state)
    ref_checksum = float(jnp.mean(jnp.abs(audio)))
    assert dist_checksum == pytest.approx(ref_checksum, rel=1e-4)

    # Halo FIR oracle: zero-padded forward-backward filter on the host.
    from scipy import signal as sig
    taps = np.asarray(sig.firwin(33, 0.25), np.float64)
    n = N_PROCS * LOCAL_DEVICES * 4096
    x = np.sin(np.arange(n, dtype=np.float64) * 0.01)
    # Forward causal sweep then anti-causal sweep, zero-padded global
    # edges — mirrors parallel.halo.zero_phase_fir_halo exactly.
    fwd = np.correlate(np.concatenate([np.zeros(len(taps) - 1), x]),
                       taps[::-1], mode="valid")
    bwd = np.correlate(np.concatenate([fwd, np.zeros(len(taps) - 1)]),
                       taps, mode="valid")
    ref_halo = float(np.mean(np.abs(bwd)))
    assert dist_halo == pytest.approx(ref_halo, rel=1e-4)

"""chip_smoke.py: it refuses anything but a GPU, and its phases hold
their bounds on the CPU at small sizes (the card runs them at full
size)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_exits_nonzero_on_cpu(args):
    proc = _run(args, REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_fails_alone_in_an_empty_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _all_ok(result):
    assert result["checks"], result
    failed = [k for k, v in result["checks"].items() if not v]
    assert not failed, (failed, result)
    chunk_s = result.get("chunk_s")
    if chunk_s is not None:
        assert result["steady_step_s"] > 0


def test_phase_receive_fm_small():
    _all_ok(chip_smoke.phase_receive_fm(
        input_rate=400_000, demod_rate=100_000, audio_rate=20_000,
        seconds=2))


def test_phase_multi_fm_server_fused_small():
    r = chip_smoke.phase_multi_fm_server_fused(
        n_stations=2, station_rate=262_144, audio_rate=49_152, seconds=2,
        oracle_stations=(0, 1))
    _all_ok(r)
    assert r["band_samples"] == 2 * 262_144


def test_phase_multi_fm_server_mixed_small():
    r = chip_smoke.phase_multi_fm_server_mixed(
        band_rate=2e6, bandwidth=100e3, audio_rate=20e3, seconds=2)
    _all_ok(r)
    assert r["modes"] == ["wbfm", "mfm", "fm"]


def test_phase_fir_precision_small():
    r = chip_smoke.phase_fir_precision(n=1 << 16, reps=1)
    _all_ok(r)
    assert set(r["checks"]) == {"auto_rel_err", "conv_rel_err",
                                "fft_rel_err"}


def test_phase_four_cards_on_virtual_devices():
    """The sharded comparison on four of conftest's virtual CPU devices,
    at a size where both meshes take the distributed path."""
    import jax
    r = chip_smoke.phase_four_cards(
        n_stations=8, station_rate=65_536, audio_rate=16_384,
        fir_n=1 << 16, devices=jax.devices()[:4])
    _all_ok(r)

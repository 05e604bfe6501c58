"""The capability query, the published peak table, and where the
persistent compile cache goes."""

import os
import types

import jax
import pytest

from radiocore_tpu.runtime import compile_cache, platform


def _fake_devices(monkeypatch, platform_name, kind, version):
    dev = types.SimpleNamespace(
        platform=platform_name, device_kind=kind,
        client=types.SimpleNamespace(platform_version=version))
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
    return dev


def test_platform_is_cpu_under_tests():
    assert platform.device_platform() == "cpu"
    assert platform.HasCuda() is False


def test_has_cuda_on_an_nvidia_gpu(monkeypatch):
    _fake_devices(monkeypatch, "gpu", "NVIDIA H100 80GB HBM3",
                  "PJRT C API\ncuda 12090")
    assert platform.device_platform() == "gpu"
    assert platform.HasCuda() is True


def test_has_cuda_false_on_a_rocm_gpu(monkeypatch):
    _fake_devices(monkeypatch, "gpu", "AMD Instinct MI300X",
                  "PJRT C API\nrocm 60000")
    assert platform.HasCuda() is False


def test_peaks_for_a_known_kind():
    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    peaks = platform.device_peaks(dev)
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["nvlink_bytes_per_s_each_way"] == 450e9


def test_peaks_for_an_unknown_kind_raise():
    with pytest.raises(ValueError, match="no published peaks"):
        platform.device_peaks(types.SimpleNamespace(device_kind="cpu"))
    with pytest.raises(ValueError):
        platform.device_peaks()  # the test platform's own CPU


def _run_cache(monkeypatch, env_dir):
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.__setitem__(name, value))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    return compile_cache.enable_persistent_cache(), seen


def test_compile_cache_in_checkout_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "REPO_CACHE_DIR",
                        str(tmp_path / ".jax_cache"))
    path, seen = _run_cache(monkeypatch, None)
    assert path == str(tmp_path / ".jax_cache")
    assert os.path.isdir(path)
    assert seen["jax_compilation_cache_dir"] == path


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    path, seen = _run_cache(monkeypatch, str(tmp_path / "elsewhere"))
    assert path == str(tmp_path / "elsewhere")
    assert "jax_compilation_cache_dir" not in seen
    assert "jax_persistent_cache_min_compile_time_secs" in seen


def test_default_cache_dir_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

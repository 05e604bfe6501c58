"""ops.fft's transforms at the pipeline's shapes vs the float64 NumPy
oracle: pow2 rows, batched and multi-lead shapes, a·2^k mixed sizes, the
real transforms, and the explicit four-step level ``fft_decomposed``."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiocore_tpu.ops import fft as pfft


def _rand_c64(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("length", [256, 1024, 2048, 4096, 16384, 1 << 18,
                                    1 << 20])
def test_forward_matches_numpy(length):
    x = _rand_c64((length,), seed=length)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel(pfft.fft(jnp.asarray(x)), want) < 2e-6


@pytest.mark.parametrize("batch", [1, 3, 8, 61])
def test_batched_rows(batch):
    x = _rand_c64((batch, 4096), seed=batch)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    got = pfft.fft(jnp.asarray(x))
    assert got.shape == (batch, 4096)
    assert _rel(got, want) < 2e-6


def test_multi_lead_dims():
    x = _rand_c64((2, 3, 2048), seed=5)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(pfft.fft(jnp.asarray(x)), want) < 2e-6


def test_inverse_roundtrip():
    x = _rand_c64((4, 4096), seed=7)
    y = pfft.ifft(pfft.fft(jnp.asarray(x)))
    assert _rel(y, x.astype(np.complex128)) < 2e-6


def test_real_input_promotes_to_complex():
    x = np.random.default_rng(9).standard_normal(2048).astype(np.float32)
    got = pfft.fft(jnp.asarray(x))
    assert got.dtype == jnp.complex64
    assert _rel(got, np.fft.fft(x.astype(np.float64))) < 2e-6


@pytest.mark.parametrize("n", [3 << 12, 5 << 11, 3 << 13])
def test_mixed_sizes_match_numpy(n):
    """a·2^k sizes (the 96-station 24M band is 3·2^23)."""
    x = _rand_c64((n,), seed=n)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel(pfft.fft(jnp.asarray(x)), want) < 2e-6


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_decomposed_large_band(sign):
    n = 1 << 20
    x = _rand_c64((n,), seed=11)
    xd = x.astype(np.complex128)
    want = np.fft.fft(xd) if sign < 0 else np.fft.ifft(xd) * n
    got = pfft.fft_decomposed(jnp.asarray(x), sign=sign)
    assert _rel(got, want) < 5e-6


def test_rfft_matches_numpy():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 8192)).astype(np.float32)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert _rel(pfft.rfft(jnp.asarray(x)), want) < 2e-6


def test_irfft_roundtrip():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y = pfft.irfft(pfft.rfft(jnp.asarray(x)), 4096)
    assert np.max(np.abs(np.asarray(y) - x)) < 2e-5


def test_irfft_matches_numpy():
    rng = np.random.default_rng(23)
    n = 2048
    spec = (rng.standard_normal(n // 2 + 1)
            + 1j * rng.standard_normal(n // 2 + 1)).astype(np.complex64)
    spec[0] = spec[0].real
    spec[-1] = spec[-1].real
    want = np.fft.irfft(spec.astype(np.complex128), n=n)
    got = pfft.irfft(jnp.asarray(spec), n)
    assert np.max(np.abs(np.asarray(got) - want)) < 2e-6


def test_irfft_discards_edge_imag():
    """Nonzero imag in the DC/Nyquist bins is ignored, like np.fft.irfft."""
    rng = np.random.default_rng(31)
    n = 2048
    spec = (rng.standard_normal(n // 2 + 1)
            + 1j * rng.standard_normal(n // 2 + 1)).astype(np.complex64)
    want = np.fft.irfft(spec.astype(np.complex128), n=n)
    got = pfft.irfft(jnp.asarray(spec), n)
    assert np.max(np.abs(np.asarray(got) - want)) < 2e-6


def test_station_batch_rfft_shape():
    """The fast demod's one full-length transform: a station batch of
    real quad signals → n//2+1 bins each."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((4, 1 << 14)).astype(np.float32)
    got = pfft.rfft(jnp.asarray(x))
    assert got.shape == (4, (1 << 13) + 1)
    assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=-1)) < 2e-6


def test_default_policy_is_native():
    """Every size plans native unless the 'fourstep' policy is set."""
    assert pfft._plan(250_000) is None
    assert pfft._plan(3 << 23) is None
    with pytest.raises(ValueError):
        pfft.set_policy("auto")

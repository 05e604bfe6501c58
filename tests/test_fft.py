"""Four-step FFT decomposition vs numpy (the 'fourstep' policy path).

Every size is native by default, so these force ``policy='fourstep'``
to exercise the recursive decomposition at the radio's non-pow2 sizes
(e.g. 250 000 — see ops/fft.py module docstring).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from radiocore_tpu.ops import fft as pfft

RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def fourstep_policy():
    pfft.set_policy("fourstep")
    yield
    pfft.set_policy("native")


@pytest.mark.parametrize("n", [250_000, 48_000, 15_625, 100_000, 62_500])
def test_fft_matches_numpy(n):
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
         ).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(pfft.fft(x))
    tol = 2e-4 * np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=tol)


def test_ifft_roundtrip():
    x = (RNG.standard_normal(250_000) + 1j * RNG.standard_normal(250_000)
         ).astype(np.complex64)
    back = np.asarray(pfft.ifft(pfft.fft(x)))
    np.testing.assert_allclose(back, x, atol=1e-3)


@pytest.mark.parametrize("n", [250_000, 62_500, 15_625])
def test_rfft_matches_numpy(n):
    x = RNG.standard_normal(n).astype(np.float32)
    want = np.fft.rfft(x.astype(np.float64))
    got = np.asarray(pfft.rfft(x))
    tol = 2e-4 * np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("n_in,n_out", [(125_001, 250_000), (12_501, 25_000),
                                        (12_500, 25_000)])
def test_irfft_matches_numpy(n_in, n_out):
    X = (RNG.standard_normal(n_in) + 1j * RNG.standard_normal(n_in)
         ).astype(np.complex64)
    want = np.fft.irfft(X.astype(np.complex128), n=n_out)
    got = np.asarray(pfft.irfft(X, n=n_out))
    np.testing.assert_allclose(got, want, atol=2e-4 * np.max(np.abs(want)))


def test_batched_fft():
    x = (RNG.standard_normal((3, 62_500)) +
         1j * RNG.standard_normal((3, 62_500))).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    got = np.asarray(pfft.fft(x))
    np.testing.assert_allclose(got, want, atol=2e-4 * np.max(np.abs(want)))


def test_prime_size_raises():
    with pytest.raises(ValueError):
        pfft.fft(np.zeros(100_003, np.complex64))  # 100003 is prime


def test_split_balances():
    a, b = pfft._split(250_000)
    assert a * b == 250_000 and max(a, b) <= 1000
    a, b = pfft._split(10_000_000)
    assert a * b == 10_000_000 and max(a, b) <= 4000


def test_fft_decomposed_matches_numpy():
    """Forced one-level four-step (the extraction-stage batched-IFFT
    lowering) must equal the native transform at any composite size."""
    from radiocore_tpu.ops.fft import fft_decomposed, ifft_decomposed

    rng = np.random.default_rng(7)
    for shape in [(4096,), (3, 4096), (2, 3, 1200)]:
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        want_f = np.fft.fft(x, axis=-1)
        got_f = np.asarray(fft_decomposed(jnp.asarray(x)))
        np.testing.assert_allclose(got_f, want_f,
                                   atol=2e-3 * np.max(np.abs(want_f)))
        want_i = np.fft.ifft(x, axis=-1)
        got_i = np.asarray(ifft_decomposed(jnp.asarray(x)))
        np.testing.assert_allclose(got_i, want_i,
                                   atol=2e-3 * np.max(np.abs(want_i)))

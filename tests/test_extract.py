"""ops.channelize's extractor against the float64 extraction oracle
(``oracles.extract_channel``: roll, fftshifted Hann window, frequency-
domain resample), alone and followed by the quadrature demod."""

import numpy as np
import pytest

import jax.numpy as jnp

import oracles
from radiocore_tpu.ops import channelize
from radiocore_tpu.ops.demod import quadrature_demod

SHAPES = [
    (4, 512, 2048),      # n == c·m: the plan covers the band
    (3, 512, 2048),      # c < n/m: plan narrower than the band
    (4, 1024, 8192),     # wider band
]


def _uniform_plan(c, m, n, skew=0):
    """Offsets of the uniform tiling the fused pipeline uses."""
    half = n // 2 - m // 2
    return [int(-half + i * m + skew) for i in range(c)]


def _spectrum(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.3


def _extract(spec, offsets, m):
    shifts = tuple(-o for o in offsets)
    return np.asarray(channelize.make_extractor(spec.shape[-1], shifts, m)(
        jnp.asarray(spec)))


def _oracle(spec, offsets, m):
    s64 = spec.astype(np.complex128)
    return np.stack([oracles.extract_channel(s64, -o, m) for o in offsets])


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("c,m,n", SHAPES)
def test_uniform_matches_oracle(c, m, n):
    offsets = _uniform_plan(c, m, n)
    spec = _spectrum(n)
    got = _extract(spec, offsets, m)
    assert got.shape == (c, m)
    _close(got, _oracle(spec, offsets, m), 1e-5)


def test_unaligned_start_matches_oracle():
    """Stations shifted together by a non-multiple of m: still uniform,
    but the first slice starts off the m grid."""
    c, m, n = 4, 512, 4096
    offsets = _uniform_plan(c, m, n, skew=100)
    spec = _spectrum(n, seed=7)
    _close(_extract(spec, offsets, m), _oracle(spec, offsets, m), 1e-5)


def test_full_wrap_last_station():
    """n == c·m: the last station's Nyquist neighbour wraps to the start
    of the band."""
    c, m, n = 4, 256, 1024
    offsets = _uniform_plan(c, m, n)
    spec = _spectrum(n, seed=11)
    _close(_extract(spec, offsets, m), _oracle(spec, offsets, m), 1e-5)


def test_nonuniform_plan_matches_oracle():
    """A plan that does not tile the band takes the per-slice lowering."""
    m, n = 512, 4096
    offsets = [-1500, -300, 250, 1700]
    spec = _spectrum(n, seed=13)
    _close(_extract(spec, offsets, m), _oracle(spec, offsets, m), 1e-5)


def test_batched_spectra():
    c, m, n = 4, 512, 2048
    offsets = _uniform_plan(c, m, n)
    specs = np.stack([_spectrum(n, seed=s) for s in (1, 2)])
    got = _extract(specs, offsets, m)
    assert got.shape == (2, c, m)
    for b in range(2):
        _close(got[b], _oracle(specs[b], offsets, m), 1e-5)


def _demod_oracle(spec, offsets, m):
    return np.stack([oracles.fm_demod(iq)
                     for iq in _oracle(spec, offsets, m)])


@pytest.mark.parametrize("c,m,n", SHAPES)
def test_extract_then_demod_matches_oracle(c, m, n):
    offsets = _uniform_plan(c, m, n)
    spec = _spectrum(n)
    got = np.asarray(quadrature_demod(jnp.asarray(
        _extract(spec, offsets, m))))
    want = _demod_oracle(spec, offsets, m)
    assert got.shape == (c, m)
    # Phase differences of near-zero-magnitude noise samples are
    # ill-conditioned: compare where the signal is not near zero.
    iq = np.abs(_oracle(spec, offsets, m))
    ok = (iq > 1e-2 * iq.max()) & (np.roll(iq, 1, axis=-1) > 1e-2 * iq.max())
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4)
    assert np.all(got[:, 0] == 0.0)


def test_extract_then_demod_on_fm_signal():
    """A real FM station in the band: extraction plus demod recovers its
    baseband tone, and matches the oracle."""
    c, m, n = 4, 1024, 4096
    t = np.arange(n) / n
    base = np.sin(2 * np.pi * 40.0 * t)
    phase = np.cumsum(base) * (2 * np.pi * 100.0 / n)
    offsets = _uniform_plan(c, m, n)
    carrier = np.exp(1j * (2 * np.pi * offsets[1] * t + phase))
    band = (carrier + 0.001 * np.random.default_rng(5).standard_normal(n)
            ).astype(np.complex64)
    spec = np.fft.fft(band).astype(np.complex64)

    got = np.asarray(quadrature_demod(jnp.asarray(
        _extract(spec, offsets, m))))
    want = _demod_oracle(spec, offsets, m)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    sl = slice(m // 8, -m // 8)
    g = got[1][sl] - got[1][sl].mean()
    b = np.interp(np.arange(m) * (n / m), np.arange(n), base)[sl]
    b = b - b.mean()
    assert np.dot(g, b) / np.sqrt(np.dot(g, g) * np.dot(b, b)) > 0.9

"""Both lowerings of ops.fir.fir_causal — the direct conv and the FFT
overlap-save form (``fir_overlap_save``) — against float64
``scipy.signal.lfilter``, at the (n, taps) pairs the radio uses, with
history, batched, and with taps wider than the signal."""

import numpy as np
import pytest
from scipy import signal as sig

from radiocore_tpu.ops.fir import fir_causal

RNG = np.random.default_rng(21)
IMPLS = ["conv", "fft"]


def _run(impl, x, taps, history=None):
    return np.asarray(fir_causal(x, taps, history=history, impl=impl))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,t", [(1000, 31), (40_000, 51), (70_000, 129),
                                 (5000, 200)])
def test_matches_lfilter(impl, n, t):
    x = RNG.standard_normal(n).astype(np.float32)
    taps = sig.firwin(t, 0.3)
    want = sig.lfilter(taps, 1.0, x.astype(np.float64))
    got = _run(impl, x, taps)
    np.testing.assert_allclose(got, want, atol=2e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("impl", IMPLS)
def test_matches_with_history(impl):
    x = RNG.standard_normal(2000).astype(np.float32)
    taps = sig.firwin(41, 0.25)
    hist = RNG.standard_normal(40).astype(np.float32)
    full = np.concatenate([hist, x]).astype(np.float64)
    want = sig.lfilter(taps, 1.0, full)[40:]
    got = _run(impl, x, taps, history=hist)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_wide_taps_short_signal(impl):
    """More taps than samples: the whole output is transient."""
    n, t = 2048, 2050
    x = RNG.standard_normal(n).astype(np.float32)
    taps = sig.firwin(t, 0.1)
    want = sig.lfilter(taps, 1.0, x.astype(np.float64))
    got = _run(impl, x, taps)
    np.testing.assert_allclose(got, want, atol=2e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("impl", IMPLS)
def test_batched(impl):
    x = RNG.standard_normal((3, 4000)).astype(np.float32)
    taps = sig.firwin(61, [0.2, 0.4], pass_zero=False)
    want = sig.lfilter(taps, 1.0, x.astype(np.float64), axis=-1)
    got = _run(impl, x, taps)
    assert got.shape == (3, 4000)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_auto_is_a_known_lowering():
    x = RNG.standard_normal(5000).astype(np.float32)
    taps = sig.firwin(33, 0.2)
    auto = np.asarray(fir_causal(x, taps))
    conv = np.asarray(fir_causal(x, taps, impl="conv"))
    np.testing.assert_allclose(auto, conv, atol=1e-6)
    with pytest.raises(ValueError):
        fir_causal(x, taps, impl="pallas")

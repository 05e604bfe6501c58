"""Device-resident synthesis + measurement (ops/synth.py).

These run whole checks on the device with only scalars crossing to the
host; here they are validated on CPU against the host float64 oracles.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radiocore_tpu.ops import synth
import oracles

FS, AUDIO = 250_000, 48_000


def test_sin_tone_precision():
    """Split-phase tone matches float64 reference to < 1e-3 over 1 s."""
    n = FS
    for f in (19e3, 38e3, 440.0, 1000.0):
        dev = np.asarray(synth._sin_tone(n, f, FS))
        ref = np.sin(2 * np.pi * f * np.arange(n, dtype=np.float64) / FS)
        assert np.max(np.abs(dev - ref)) < 1e-3, f


def test_sin_tone_chunk_continuation():
    """k0 continuation equals one long generation."""
    n = 8192
    whole = np.asarray(synth._sin_tone(2 * n, 19e3, FS))
    a = np.asarray(synth._sin_tone(n, 19e3, FS, k0=0))
    b = np.asarray(synth._sin_tone(n, 19e3, FS, k0=n))
    assert np.allclose(np.concatenate([a, b]), whole, atol=1e-6)


def test_device_tone_snr_matches_host():
    n = 65536
    x = np.asarray(synth._sin_tone(n, 1000.0, AUDIO))
    x = x + 0.001 * np.random.default_rng(0).standard_normal(n).astype(
        np.float32)
    dev = float(synth.tone_snr_db(jnp.asarray(x), AUDIO, 1000.0,
                                  n_fft=32768, skip=2048))
    host = oracles.tone_snr_db(x[2048:2048 + 32768], AUDIO, 1000.0)
    assert dev == pytest.approx(host, abs=1.0)


def test_device_synth_wbfm_end_to_end():
    """Device IQ → WBFM step → device SNR: the full transfer-free drive."""
    from radiocore_tpu.models.wbfm import make_wbfm_step, wbfm_init_state

    iq = synth.stereo_fm_iq(FS, float(FS), 440.0, 1000.0)
    step = jax.jit(make_wbfm_step(FS, AUDIO))
    state = wbfm_init_state(AUDIO)
    audio, state = step(iq, state)
    assert audio.shape == (AUDIO, 2)

    snr_l = float(synth.tone_snr_db(audio[:, 0], AUDIO, 440.0))
    snr_r = float(synth.tone_snr_db(audio[:, 1], AUDIO, 1000.0))
    # Stereo separation: the left tone must not appear on the right.
    leak_l_in_r = float(synth.tone_snr_db(audio[:, 1], AUDIO, 440.0))
    assert snr_l > 20.0, snr_l
    assert snr_r > 20.0, snr_r
    assert leak_l_in_r < snr_r - 10.0, (leak_l_in_r, snr_r)

"""The fused multi-station step against the same stages run as separate
jits (band FFT → extraction → vmapped WBFM), in fast and exact mode, and
the per-stage split the 'fourstep' FFT policy selects."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radiocore_tpu.models.wbfm import make_wbfm_step, wbfm_init_state
from radiocore_tpu.ops import fft as pfft
from radiocore_tpu.ops.channelize import make_extractor
from radiocore_tpu.parallel.pipeline import make_multi_station_step


def _plan(n_stations, station_chunk):
    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    return n_band, [int(-half + i * station_chunk)
                    for i in range(n_stations)]


def _band(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.1


def _per_stage(n_band, offsets, station_chunk, audio_chunk, mode, band):
    band_fft = jax.jit(pfft.fft)
    extract = jax.jit(make_extractor(n_band, tuple(-o for o in offsets),
                                     station_chunk))
    demod = jax.jit(jax.vmap(make_wbfm_step(station_chunk, audio_chunk,
                                            mode=mode)))
    state = wbfm_init_state(audio_chunk, batch_shape=(len(offsets),))
    audio, _ = demod(extract(band_fft(jnp.asarray(band))), state)
    return np.asarray(audio)


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_fused_step_matches_per_stage(mode):
    # station_chunk is the per-station rate (one-second convention) and
    # must clear the 38 kHz stereo subcarrier.
    n_stations, station_chunk, audio_chunk = 4, 65_536, 16_384
    n_band, offsets = _plan(n_stations, station_chunk)
    band = _band(n_band, 17)
    step, state = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk, mode=mode)
    got, new_state = step(band, state)
    want = _per_stage(n_band, offsets, station_chunk, audio_chunk, mode,
                      band)
    assert got.shape == (n_stations, audio_chunk, 2)
    assert set(new_state) == {"deemph_l", "deemph_r"}
    # Fusion lets XLA reorder f32 sums inside one program; the demod's
    # phase differencing lifts that to ~1e-5 on the ±1 audio.
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


def test_fourstep_policy_splits_into_stage_jits():
    """A decomposed non-pow2 size makes the step run stage by stage; the
    result still matches the native per-stage chain."""
    n_stations, station_chunk, audio_chunk = 4, 50_000, 10_000
    n_band, offsets = _plan(n_stations, station_chunk)
    band = _band(n_band, 23)
    want = _per_stage(n_band, offsets, station_chunk, audio_chunk, "fast",
                      band)
    pfft.set_policy("fourstep")
    try:
        step, state = make_multi_station_step(
            n_band, offsets, station_chunk, audio_chunk, mode="fast")
        assert not hasattr(step, "lower"), "expected per-stage jits"
        got, _ = step(band, state)
    finally:
        pfft.set_policy("native")
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4)

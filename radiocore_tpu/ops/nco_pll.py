"""True feedback NCO phase-locked loop for the 19 kHz stereo pilot.

The reference's "PLL" is an analytic-signal phase multiplier, stateless
per chunk (reference: ``radiocore/analog/pll.py:25-58``) — fast and
parallel, but it tracks whatever is inside the pilot bandpass including
noise phase. This module adds the classic 2nd-order feedback PLL
(phase detector → PI loop filter → NCO) as the accuracy-mode
alternative flagged in SURVEY.md §2.4 item 4: true carrier tracking
with a controlled loop bandwidth, streaming state across chunks.

The recurrence is inherently sequential, expressed as a ``lax.scan``
(vmap-able over stations). It trades throughput for tracking
quality — the analytic-signal path remains the high-throughput default.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


class PLLState(NamedTuple):
    phase: jnp.ndarray      # NCO phase, radians
    freq: jnp.ndarray       # integrator: freq offset, rad/sample


class PLLGains(NamedTuple):
    kp: float
    ki: float
    w0: float               # nominal pilot frequency, rad/sample


def pll_design(fs: float, f0: float = 19e3, loop_bw_hz: float = 50.0,
               damping: float = 0.7071) -> PLLGains:
    """PI gains for a 2nd-order loop (standard normalized design)."""
    bnt = loop_bw_hz / fs
    denom = 1.0 + 2.0 * damping * bnt + bnt * bnt
    kp = 4.0 * damping * bnt / denom
    ki = 4.0 * bnt * bnt / denom
    return PLLGains(kp=float(kp), ki=float(ki),
                    w0=float(2.0 * np.pi * f0 / fs))


def pll_init(batch_shape: Tuple[int, ...] = ()) -> PLLState:
    """Initial loop state (phase, frequency, lock metric) per station."""
    zeros = jnp.zeros(batch_shape, dtype=jnp.float32)
    return PLLState(phase=zeros, freq=zeros)


def nco_pll_track(pilot: jnp.ndarray, gains: PLLGains,
                  state: PLLState) -> Tuple[jnp.ndarray, PLLState]:
    """Track the pilot; returns (phase trajectory, new state).

    ``pilot`` (..., N) float32 — normalize amplitude beforehand (e.g.
    the bandpassed pilot divided by its RMS) so the loop gains hold.
    Phase detector: ``e[n] = pilot[n] · cos(φ[n])`` (for a sin-phased
    pilot, e ≈ A/2·sin(θ−φ) after the loop filters the 2ω term).
    """
    kp, ki, w0 = gains

    def scan_fn(carry, x):
        phase, freq = carry
        err = x * jnp.cos(phase)
        out = phase  # emit the phase the detector saw for THIS sample
        freq = freq + ki * err
        phase = phase + w0 + freq + kp * err
        phase = jnp.where(phase > np.pi, phase - 2 * np.pi, phase)
        return (phase, freq), out

    # scan over the last axis; batch dims ride along elementwise.
    xs = jnp.moveaxis(pilot.astype(jnp.float32), -1, 0)
    (phase, freq), traj = jax.lax.scan(
        scan_fn, (state.phase, state.freq), xs)
    return jnp.moveaxis(traj, 0, -1), PLLState(phase=phase, freq=freq)


def pll_subcarrier(phase_traj: jnp.ndarray, mult: int = 2,
                   part: str = "imag") -> jnp.ndarray:
    """Unit-amplitude harmonic of the tracked phase.

    Matches the semantics of the analytic-signal path's
    :func:`~radiocore_tpu.ops.analytic.pll_harmonic`: for a pilot
    ``sin(θ)``, that path returns ``−sin(m·θ)`` (imag) / ``−cos(m·θ)``…
    — here the tracked θ gives direct access; ``imag`` returns
    ``−sin(m·θ)`` for parity with the analytic convention at m=2.
    """
    m_theta = mult * phase_traj
    if part == "real":
        return -jnp.cos(m_theta)
    return -jnp.sin(m_theta)

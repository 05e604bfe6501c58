"""Distributed channel extraction: six-step band FFT + spectrum roll +
windowed per-channel extraction, as ONE shard_map body.

This is the single home of the distributed front-end (round-2 had two
four-step copies: ``parallel/fft_sharded.py`` and an inline reimpl in
``parallel/pipeline.py`` — unified here). It replaces the reference's
replicated full-band FFT hot loop (``radiocore/tools/tuner.py:137-138``)
with the classic six-step distributed FFT (3 ``all_to_all``s)
followed by a 2-``ppermute`` spectrum roll and local windowed
extraction: no device ever materializes the full band or its spectrum
(per-device peak is ~1/D of the band).

Composability: :func:`make_extract_body` returns the per-shard body so
callers can fuse their own sharded stages around it inside the same
``shard_map`` (the wideband benchmark runs a halo-exchange overlap-save
FIR in front); :func:`make_distributed_extractor` wraps it in a jitted
``shard_map`` for standalone use.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from radiocore_tpu.ops import fft as _fft
from radiocore_tpu.ops.channelize import extraction_plan
from radiocore_tpu.parallel.fft_sharded import (_fourstep_local_blocks,
                                                split_for_shards)


def roll_sharded(block: jnp.ndarray, shift: int, n: int,
                 axis_name: str) -> jnp.ndarray:
    """Global circular roll of a block-sharded flat array, inside
    shard_map: device d's output is ``x[(d·B + shift) % n : … + B]``.

    The shift splits each local block into at most two pieces routed to
    (possibly) two neighbors — two ``ppermute``s, no gather.
    """
    d = jax.lax.axis_size(axis_name)
    b = n // d
    q, r = divmod(int(shift) % n, b)
    if r == 0:
        if q == 0:
            return block
        perm = [(e, (e - q) % d) for e in range(d)]
        return jax.lax.ppermute(block, axis_name, perm)
    perm_hi = [(e, (e - q) % d) for e in range(d)]
    perm_lo = [(e, (e - q - 1) % d) for e in range(d)]
    high = jax.lax.ppermute(block[r:], axis_name, perm_hi)
    low = jax.lax.ppermute(block[:r], axis_name, perm_lo)
    return jnp.concatenate([high, low])


def make_extract_body(n_band: int, shifts: Sequence[int],
                      bandwidth: int, n_devices: int,
                      axis_name: str) -> Optional[Callable]:
    """Per-shard ``band block (n/D,) → channels (C/D, m)`` body, or None.

    Qualifies when the channel plan tiles the band uniformly and
    critically (``n = C·m``, spacing m), ``C % D == 0``, and an
    ``n = n1·n2`` split exists with both factors divisible by D.
    Channel c of the output lives on device ``c // (C/D)`` (block
    sharding over the channel axis). Shift/window/Nyquist-fold semantics
    match :func:`radiocore_tpu.ops.channelize.make_extractor` exactly
    (asserted by tests/test_parallel.py).
    """
    n = int(n_band)
    m = int(bandwidth)
    c = len(shifts)
    d = int(n_devices)
    starts, w_out, w_fix, m2, _run = extraction_plan(n, shifts, m)
    uniform = (c > 1 and all((starts[i] - starts[0]) % n == (i * m) % n
                             for i in range(c)))
    split = split_for_shards(n, d)
    if not (d > 1 and uniform and n == c * m and c % d == 0
            and split is not None):
        return None
    n1, n2 = split
    c_loc = c // d
    a0 = int(starts[0])
    neg = m - m2
    s_fac = n / m

    def body(block: jnp.ndarray) -> jnp.ndarray:
        spec = _fourstep_local_blocks(block, n1, n2, axis_name)  # my k block
        rolled = roll_sharded(spec, a0, n, axis_name)
        # One halo bin: the right neighbor's first rolled bin (wraps).
        halo = jax.lax.ppermute(
            rolled[:1], axis_name,
            [(e, (e - 1) % d) for e in range(d)])
        rows = rolled.reshape(c_loc, m)
        nxt = jnp.concatenate([rows[1:, :1], halo[None, :]], axis=0)
        # Same reorder/window/fix math as ops.channelize.extract_uniform.
        if m % 2 == 0:
            pos = jnp.concatenate([rows[:, m // 2:], nxt], axis=-1)
            y = jnp.concatenate([pos, rows[:, 1:m // 2]], axis=-1) * w_out
            y = y.at[:, m2 - 1].add(rows[:, 0] * w_fix)
        else:
            pos = jnp.concatenate([rows[:, neg:], nxt], axis=-1)[:, :m2]
            y = jnp.concatenate([pos, rows[:, :neg]], axis=-1) * w_out
        y = jax.lax.optimization_barrier(y)
        return _fft.ifft(y / s_fac)                        # (c_loc, m)

    return body

"""Halo exchange for time-sharded FIR filtering.

The sequence-parallel analog from SURVEY.md §2.5: the 1-second sample
axis is sharded across devices; a causal FIR needs the last ``num_taps−1``
samples of the left neighbor's block, a zero-phase FIR needs halos on
both sides. Exchanges are ``lax.ppermute`` inside ``shard_map``, which
XLA hands to the devices' interconnect (NVLink between GPUs).

These functions are written to run INSIDE ``shard_map`` (they use an
``axis_name``); :func:`fir_causal_sharded` / :func:`zero_phase_fir_sharded`
wrap them for whole-array callers.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radiocore_tpu.ops.fir import (fir_causal, fir_overlap_save,
                                   zero_phase_fir, _corr_valid)
from radiocore_tpu.ops.pfb import pfb_channelize


def _shift_right(block_tail: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Send each shard's tail to its right neighbor; shard 0 receives zeros."""
    n = lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return lax.ppermute(block_tail, axis_name, perm)


def _shift_left(block_head: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Send each shard's head to its left neighbor; last shard receives zeros."""
    n = lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(block_head, axis_name, perm)


def halo_exchange(x: jnp.ndarray, n_left: int, n_right: int,
                  axis_name: str) -> jnp.ndarray:
    """Pad a time-sharded block with neighbor samples along the last axis.

    Returns ``(..., n_left + block + n_right)``; edge shards are padded
    with zeros where no neighbor exists (callers overlay stream state or
    edge extension for the global boundary).
    """
    parts = []
    if n_left > 0:
        parts.append(_shift_right(x[..., -n_left:], axis_name))
    parts.append(x)
    if n_right > 0:
        parts.append(_shift_left(x[..., :n_right], axis_name))
    return jnp.concatenate(parts, axis=-1)


def fir_causal_halo(x: jnp.ndarray, taps: np.ndarray,
                    axis_name: str) -> jnp.ndarray:
    """Causal FIR on a time-sharded block (runs inside shard_map).

    Bit-identical to the unsharded :func:`~radiocore_tpu.ops.fir.fir_causal`
    with zero initial history: every shard filters its block using the
    left neighbor's tail as history; shard 0 uses zeros.
    """
    t = len(taps)
    ext = halo_exchange(x, t - 1, 0, axis_name)
    kernel = jnp.asarray(np.asarray(taps)[::-1], dtype=x.dtype)
    return _corr_valid(ext, kernel)


def zero_phase_fir_halo(x: jnp.ndarray, taps: np.ndarray,
                        axis_name: str) -> jnp.ndarray:
    """Zero-phase FIR on a time-sharded block (runs inside shard_map).

    Interior is the exact forward-backward filter: two sweeps with halos
    on alternating sides. Global-edge transients (first/last
    ``3·num_taps`` samples of the whole signal) follow zero-padding
    rather than scipy's odd extension — a boundary-only difference.
    """
    t = len(taps)
    kernel = jnp.asarray(np.asarray(taps), dtype=x.dtype)
    # Forward pass (causal): left halo.
    ext = halo_exchange(x, t - 1, 0, axis_name)
    fwd = _corr_valid(ext, kernel[::-1])
    # Backward pass (anti-causal): right halo, correlate un-flipped.
    ext2 = halo_exchange(fwd, 0, t - 1, axis_name)
    return _corr_valid(ext2, kernel)


def _history_or_left_halo(x: jnp.ndarray, t_hist: int,
                          stream_history: Optional[jnp.ndarray],
                          axis_name: str) -> jnp.ndarray:
    """Left-neighbor tail for every shard; shard 0 gets the stream state."""
    left = _shift_right(x[..., -t_hist:], axis_name)
    if stream_history is None:
        return left
    idx = lax.axis_index(axis_name)
    return jnp.where(idx == 0, stream_history.astype(x.dtype), left)


def _last_shard_tail(x: jnp.ndarray, t_hist: int,
                     axis_name: str) -> jnp.ndarray:
    """The global tail (= last shard's tail), replicated to every shard."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    tail = jnp.where(idx == n - 1, x[..., -t_hist:], 0)
    return lax.psum(tail, axis_name)


def fir_overlap_save_halo(x: jnp.ndarray, taps: np.ndarray, axis_name: str,
                          stream_history: Optional[jnp.ndarray] = None,
                          block: int = 1 << 15):
    """Streaming overlap-save FIR on a time-sharded block (in shard_map).

    Each shard filters its local block with per-shard FFTs (no gather —
    the sequence-parallel form of BASELINE.md config 4's wideband FIR);
    the only collectives are the tap-length halo ppermute and a tiny
    psum for the carried stream state. Returns ``(y, new_history)``
    matching :func:`~radiocore_tpu.ops.fir.fir_overlap_save` exactly.
    """
    t = len(np.asarray(taps))
    hist = _history_or_left_halo(x, t - 1, stream_history, axis_name)
    y = fir_overlap_save(x, taps, history=hist, block=block)
    return y, _last_shard_tail(x, t - 1, axis_name)


def pfb_channelize_halo(x: jnp.ndarray, taps: np.ndarray, n_channels: int,
                        axis_name: str,
                        stream_history: Optional[jnp.ndarray] = None):
    """Streaming PFB channelizer on a time-sharded band (in shard_map).

    The PFB's streaming state is the trailing ``(P−1)·M`` input samples
    (ops/pfb.py), so sequence parallelism is a pure halo problem: each
    shard channelizes its local block with the left neighbor's tail as
    history. Frames never straddle shards when the local block length
    divides by ``n_channels``. Output frame axis stays time-sharded.
    """
    m = int(n_channels)
    p = len(np.asarray(taps)) // m
    t_hist = (p - 1) * m
    if x.shape[-1] % m:
        raise ValueError("local block must divide by n_channels")
    hist = _history_or_left_halo(x, t_hist, stream_history, axis_name)
    channels, _ = pfb_channelize(x, taps, m, history=hist)
    return channels, _last_shard_tail(x, t_hist, axis_name)


def fir_causal_sharded(x: jnp.ndarray, taps: np.ndarray, mesh: Mesh,
                       axis_name: str = "time") -> jnp.ndarray:
    """Whole-array wrapper: shard ``x``'s last axis over ``axis_name``."""
    ndim = x.ndim
    spec = P(*([None] * (ndim - 1) + [axis_name]))
    fn = jax.shard_map(
        functools.partial(fir_causal_halo, taps=taps, axis_name=axis_name),
        mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(x)


def zero_phase_fir_sharded(x: jnp.ndarray, taps: np.ndarray, mesh: Mesh,
                           axis_name: str = "time") -> jnp.ndarray:
    """Whole-array wrapper for the zero-phase sharded filter."""
    ndim = x.ndim
    spec = P(*([None] * (ndim - 1) + [axis_name]))
    fn = jax.shard_map(
        functools.partial(zero_phase_fir_halo, taps=taps,
                          axis_name=axis_name),
        mesh=mesh, in_specs=spec, out_specs=spec)
    return fn(x)

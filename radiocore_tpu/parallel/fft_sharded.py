"""Distributed four-step FFT over a time-sharded band.

The wideband channelizer's front FFT (10–61 MS/s, SURVEY.md §2.5) is the
one global op in the pipeline. Two lowerings are provided:

1. :func:`fft_sharded_auto` — jit with sharding annotations; XLA's SPMD
   partitioner chooses the collectives (the scaling-book default).
2. :func:`fft_sharded_fourstep` — the explicit transpose algorithm on a
   ``shard_map``: with the band reshaped to (N1, N2) and N1 sharded,
   the length-N2 row FFTs are purely local, the twiddle multiply is
   local, and the length-N1 column FFT needs the axis transposed — one
   ``all_to_all`` each way. This is the classic distributed FFT.

Both return the standard DFT (matching ``numpy.fft.fft``) laid out
``k = k1 + N1·k2``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radiocore_tpu.ops import fft as _fft
from radiocore_tpu.parallel.mesh import TIME


def fft_sharded_auto(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Band FFT with the input sharded over the ``time`` mesh axis; XLA
    inserts the collectives."""
    sharding = NamedSharding(mesh, P(TIME))
    fn = jax.jit(_fft.fft, in_shardings=sharding,
                 out_shardings=NamedSharding(mesh, P(None)))
    return fn(x)


def _fourstep_local(x_block: jnp.ndarray, n1: int, n2: int,
                    axis_name: str) -> jnp.ndarray:
    """Per-shard body: x_block is (n1/shards, n2) rows (i-major) of the band.

    With ``n = i·N2 + j`` and ``k = k1 + N1·k2``:
    ``X[k1 + N1·k2] = Σ_j W_N^{j·k1} W_{N2}^{j·k2} (Σ_i x[i·N2+j] W_{N1}^{i·k1})``
    → column FFT over i, twiddle, row FFT over j.
    """
    shards = lax.axis_size(axis_name)
    rows = n1 // shards
    cols = n2 // shards
    me = lax.axis_index(axis_name)

    # Transpose so the i axis is fully local: (rows, n2) → (n1, cols).
    # all_to_all sends piece q of our split axis to device q and stacks
    # received pieces: entry [q, r, c] = device q's rows, our column slab.
    z = lax.all_to_all(x_block.reshape(rows, shards, cols),
                       axis_name, split_axis=1, concat_axis=0,
                       tiled=False)            # (shards, rows, cols)
    z = z.reshape(n1, cols)                    # i = q·rows + r, local j slab

    # Column FFT over i → k1, for our n2/shards columns.
    y = _fft.fft(jnp.moveaxis(z, 0, -1))       # (cols, n1): Y[j_local, k1]

    # Twiddle W_N^{j·k1} with global j = me·cols + c.
    k1 = jnp.asarray(np.arange(n1, dtype=np.float64))
    j_local = (me * cols + jnp.arange(cols)).astype(jnp.float64)
    tw = jnp.exp(-2j * np.pi / (n1 * n2)
                 * j_local[:, None] * k1[None, :]).astype(y.dtype)
    y = y * tw

    # Transpose back so j is fully local per k1 block: (cols, n1) →
    # (rows, n2) with k1 = me·rows + r, j = q·cols + c.
    y = lax.all_to_all(y.reshape(cols, shards, rows),
                       axis_name, split_axis=1, concat_axis=0,
                       tiled=False)            # (shards, cols, rows)
    y = jnp.moveaxis(y.reshape(n2, rows), 0, -1)   # (rows, n2)

    # Row FFT over j → k2.
    return _fft.fft(y)                         # Z[k1_local, k2]


def _fourstep_local_blocks(x_block: jnp.ndarray, n1: int, n2: int,
                           axis_name: str) -> jnp.ndarray:
    """Per-shard body: contiguous SAMPLE block → contiguous SPECTRUM block.

    Extends :func:`_fourstep_local` with the classic six-step FFT's final
    transpose (one more ``all_to_all``), so the output is the standard-
    order DFT in contiguous per-device blocks: device ``d`` returns
    ``X[d·n/D : (d+1)·n/D]`` flat. This is the layout the fused
    pipeline's channel extraction consumes WITHOUT ever materializing
    the full band spectrum on any device (SURVEY.md §2.5 sharded band
    FFT; reference hot loop: ``radiocore/tools/tuner.py:137-138``).
    """
    z = _fourstep_local(x_block.reshape(-1, n2), n1, n2, axis_name)
    shards = lax.axis_size(axis_name)
    rows = n1 // shards          # my k1 rows in z
    cols2 = n2 // shards         # my k2 columns after the transpose
    # all_to_all: send k2 chunk q to device q; receive every device's
    # k1 rows for MY k2 chunk → [p, r, c] = Z[p·rows + r, me·cols2 + c].
    z3 = lax.all_to_all(z.reshape(rows, shards, cols2), axis_name,
                        split_axis=1, concat_axis=0, tiled=False)
    zt = z3.reshape(n1, cols2)                 # [k1, c]
    # Flat local offset = c·n1 + k1 ↔ global k = k1 + n1·(me·cols2 + c).
    return jnp.moveaxis(zt, 0, -1).reshape(-1)


def split_for_shards(n: int, shards: int):
    """Pick ``n = n1·n2`` with both factors divisible by ``shards``,
    as balanced as the factorization allows; None when impossible."""
    if shards <= 0 or n % (shards * shards):
        return None
    rest = n // (shards * shards)
    a = int(np.sqrt(rest))
    while a >= 1:
        if rest % a == 0:
            return shards * a, shards * (rest // a)
        a -= 1
    return None


def fft_sharded_blocks(x: jnp.ndarray, mesh: Mesh,
                       axis_name: str = TIME) -> jnp.ndarray:
    """Distributed standard-order FFT: input AND output sharded over
    ``axis_name`` in contiguous blocks (flat, natural bin order)."""
    n = x.shape[-1]
    shards = mesh.shape[axis_name]
    split = split_for_shards(n, shards)
    if split is None:
        raise ValueError(
            f"no n1·n2 = {n} split with both factors divisible by {shards}")
    n1, n2 = split
    body = functools.partial(_fourstep_local_blocks, n1=n1, n2=n2,
                             axis_name=axis_name)
    fn = jax.shard_map(body, mesh=mesh, in_specs=P(axis_name),
                       out_specs=P(axis_name))
    return fn(x)


def fft_sharded_fourstep(x: jnp.ndarray, mesh: Mesh, n1: int,
                         axis_name: str = TIME) -> jnp.ndarray:
    """Explicit distributed FFT; returns X in (k1, k2) matrix layout,
    flattenable to standard order via ``result.T.reshape(-1)``
    (``k = k1 + n1·k2``)."""
    n = x.shape[-1]
    if n % n1:
        raise ValueError(f"n1 ({n1}) must divide n ({n})")
    n2 = n // n1
    shards = mesh.shape[axis_name]
    if n1 % shards or n2 % shards:
        raise ValueError("n1 and n2 must divide by the shard count")

    body = functools.partial(_fourstep_local, n1=n1, n2=n2,
                             axis_name=axis_name)
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=P(axis_name, None),
                       out_specs=P(axis_name, None))
    return fn(x.reshape(n1, n2))

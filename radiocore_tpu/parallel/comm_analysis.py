"""Collective-traffic analysis of compiled sharded programs.

Scaling efficiency across cards is compute_time / (compute_time +
exposed collective time). The bytes each device moves through
collectives per step is a static property of the compiled HLO; this
module extracts it, so the ≥80% multi-device target (BASELINE.md)
becomes falsifiable at the algorithm level:

    projected_efficiency = t_compute / (t_compute + bytes/LINK_BW)

with ``t_compute`` taken from the single-card benchmark and ``LINK_BW``
the per-card interconnect bandwidth: NVLink on the H100, 450 GB/s each
way per card (900 GB/s total; NVIDIA H100 data sheet).

Parsing: XLA HLO text names collectives ``all-to-all``, ``all-gather``,
``all-reduce``, ``reduce-scatter``, ``collective-permute``. The RESULT
shape of each op is what lands on each device per execution; summed over
ops (× any loop trip counts is out of scope — the radio pipeline has no
collectives inside loops) it bounds per-device traffic per step.
"""

from __future__ import annotations

import re
from typing import Dict

from radiocore_tpu.runtime.platform import PEAKS

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# e.g.  %all-to-all.17 = c64[8,4096]{1,0} all-to-all(...)
#       ROOT %tuple ... collective-permute(...)
_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([0-9,]*)\][^=]*?"
    r"\b(all-to-all|all-gather|all-reduce|reduce-scatter|"
    r"collective-permute)\b")


def _shape_bytes(dtype: str, dims: str) -> int:
    size = _DTYPE_BYTES.get(dtype)
    if size is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * size


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device bytes RECEIVED by each collective kind in one execution.

    Input is ``compiled.as_text()`` of a jit/shard_map program. Returns
    ``{kind: bytes, ..., "total": bytes}`` (zero-entry kinds omitted).
    """
    out: Dict[str, int] = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        out[kind] = out.get(kind, 0) + _shape_bytes(dtype, dims)
    out["total"] = sum(out.values())
    return out


NVLINK_BYTES_PER_S = PEAKS["NVIDIA H100 80GB HBM3"][
    "nvlink_bytes_per_s_each_way"]


def projected_efficiency(t_compute_s: float, coll_bytes: int,
                         link_bytes_per_s: float = NVLINK_BYTES_PER_S
                         ) -> float:
    """Scaling efficiency if collectives are fully exposed (worst case:
    no compute/communication overlap)."""
    t_coll = coll_bytes / link_bytes_per_s
    return t_compute_s / (t_compute_s + t_coll)

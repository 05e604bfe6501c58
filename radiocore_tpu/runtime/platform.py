"""Platform query, published device peaks, and distributed runtime setup.

Counterpart of the reference's CUDA capability probe
(reference: ``radiocore/__init__.py:6-26`` ``HasCuda``).
"""

from __future__ import annotations

from typing import Optional

import jax


def device_platform() -> str:
    """Platform of JAX's default device: ``'gpu'``, ``'cpu'``, ...

    The one capability query of the package. Every op is plain JAX, so
    nothing in the compute path branches on it.
    """
    return jax.devices()[0].platform


def HasCuda() -> bool:  # noqa: N802 - parity with the reference's name
    """True exactly when JAX runs on an NVIDIA GPU through CUDA, as the
    reference's ``HasCuda()`` answers (reference:
    ``radiocore/__init__.py:6-26``)."""
    if device_platform() != "gpu":
        return False
    version = getattr(jax.devices()[0].client, "platform_version", "")
    return "cuda" in str(version).lower()


# Published peak rates by exact ``device_kind``. Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM5 80 GB part, dense rates without
# sparsity, at the 700 W power limit. A card set below that limit cannot
# hold these rates; report its ``power.limit`` beside any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "nvlink_bytes_per_s_each_way": 450e9,
    },
}


def device_peaks(device=None) -> dict:
    """Published peaks of ``device`` (default: JAX's first device).

    Raises ``ValueError`` for a kind missing from :data:`PEAKS`: a
    roofline share against a guessed peak is not a measurement.
    """
    device = device if device is not None else jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            f"radiocore_tpu.runtime.platform.PEAKS with its source")
    return PEAKS[kind]


def platform_summary() -> dict:
    """Return a structured summary of the visible JAX platform/devices."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "n_devices": len(devs),
        "n_local_devices": jax.local_device_count(),
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "has_cuda": HasCuda(),
    }


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize the JAX multi-process runtime.

    The reference has no multi-process runtime at all — its only
    inter-process transport is ZeroMQ PUB/SUB
    (reference: ``examples/multi_fm_server.py:116-120``). Here
    ``jax.distributed.initialize`` joins the processes so collectives run
    inside jit. Nothing discovers a cluster on its own: pass the
    coordinator address, process count and this process's id. On GPUs,
    each process must see only its own card (``CUDA_VISIBLE_DEVICES``).

    No-op when JAX is already initialized or when running single-process
    with no coordinator configured.
    """
    # NOTE: must not touch the backend (jax.devices/process_count) before
    # jax.distributed.initialize — backend init would pin a single-process
    # world. is_initialized() is a pure runtime-state check.
    if jax.distributed.is_initialized():
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if kwargs:
        jax.distributed.initialize(**kwargs)

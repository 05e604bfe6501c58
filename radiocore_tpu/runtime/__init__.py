"""Runtime layer: platform query, configuration, metrics.

Replacement for the reference's backend-injection layer
(reference: ``radiocore/_internal/injector.py:6-29``). Instead of swapping
numpy/cupy module objects at runtime, every op here is written once in
``jax.numpy`` and dispatched by XLA to whatever platform is active; the
only runtime decision left is mesh/topology setup.
"""

from radiocore_tpu.runtime.platform import (device_platform, HasCuda,
                                            platform_summary,
                                            initialize_multihost)
from radiocore_tpu.runtime.config import PipelineConfig, StationConfig, MeshConfig
from radiocore_tpu.runtime.metrics import Metrics
from radiocore_tpu.runtime.checkpoint import save_state, load_state
from radiocore_tpu.runtime.transfer import to_device_c64, to_host

__all__ = [
    "device_platform", "HasCuda", "platform_summary", "initialize_multihost",
    "PipelineConfig", "StationConfig", "MeshConfig", "Metrics",
    "save_state", "load_state", "to_device_c64", "to_host",
]

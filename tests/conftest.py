"""Test harness: force CPU platform with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh
(``xla_force_host_platform_device_count``), per SURVEY.md §4. The
platform is set through jax.config as well as ``JAX_PLATFORMS``, so a
machine with a GPU still runs the suite on the CPU (backends initialize
lazily — this runs before the first device query).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

"""Test configuration: force the CPU backend with a virtual 8-device mesh.

The multi-device sharding paths are validated the standard JAX way — N
virtual CPU devices via ``--xla_force_host_platform_device_count`` — so no
GPU is needed.  ``jax.config.update`` pins the platform even where
``JAX_PLATFORMS`` is unset; the on-device checks are ``chip_smoke.py``.
"""

import os

_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

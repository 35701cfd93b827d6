"""Per-env row lookup into the host-precomputed heading tables.

The direction and ray-fan LUTs (``EnvConfig.directions_wu`` /
``ray_fan_lut``) are indexed by each env's integer heading.  The lookup is a
plain gather: it copies table entries bit for bit on every backend, which the
fixed-seed parity with the scalar oracles depends on.  (A one-hot matrix
product would be exact only at full float32 precision; GPU matmuls may run in
TF32 by default and round every entry to a 10-bit mantissa.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def take_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """``table[idx]``: table [N, ...], idx int[...] ->
    [idx.shape + table.shape[1:]].  Headings are always in [0, N)."""
    return jnp.take(table, idx, axis=0, mode="clip")

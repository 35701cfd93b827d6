"""On-device flood fill (reachability) via iterated dilation.

No reference equivalent (the reference's only map is an empty walled room
where everything is trivially reachable).  Randomized maps need a
reachability mask so goals are always attainable; a host-side BFS would break
the jit boundary, so this is a fixed-iteration 4-neighbor dilation —
``H*W/2`` iterations upper-bound any shortest path on an HxW grid (actually
H*W suffices for any path; H*W/2+1 for 4-connectivity diameter), each
iteration a couple of shifts and ANDs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dilate4(mask: jax.Array) -> jax.Array:
    """4-neighbor binary dilation of bool[H, W] (edge-padded with False)."""
    up = jnp.pad(mask[1:, :], ((0, 1), (0, 0)))
    down = jnp.pad(mask[:-1, :], ((1, 0), (0, 0)))
    left = jnp.pad(mask[:, 1:], ((0, 0), (0, 1)))
    right = jnp.pad(mask[:, :-1], ((0, 0), (1, 0)))
    return mask | up | down | left | right


def flood_fill(
    passable: jax.Array, seed_tu: jax.Array, num_iters: int | None = None
) -> jax.Array:
    """Reachable set of ``passable`` (bool[H, W]) from tile ``seed_tu``
    (i32[2]) under 4-connectivity.  Fixed trip count for jit."""
    h, w = passable.shape
    if num_iters is None:
        num_iters = h * w // 2 + 2
    ii = jnp.arange(h)[:, None]
    jj = jnp.arange(w)[None, :]
    seed = (ii == seed_tu[0]) & (jj == seed_tu[1])
    reach = seed & passable

    def body(m, _):
        return dilate4(m) & passable, None

    reach, _ = jax.lax.scan(body, reach, None, length=num_iters)
    return reach

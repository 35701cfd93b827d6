"""On-device random sampling.

The reference rejection-samples empty tiles with a host loop of up to
``1024*H*W`` tries (/root/reference/src/utils.jl:23-58).  Rejection sampling a
uniform proposal until empty is *exactly* the uniform distribution over empty
tiles, so the batched equivalent is a single masked categorical draw — no
loop, no possibility of exhaustion, identical distribution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_empty_tile(key: jax.Array, occupied_map: jax.Array) -> jax.Array:
    """Uniform draw over unoccupied tiles of bool[H, W]; returns i32[2].

    Equivalent in distribution to ``sample_empty_position``
    (/root/reference/src/utils.jl:23-58) over the full grid.  If every tile is
    occupied the draw returns tile 0 (the reference warns and returns an
    occupied tile on exhaustion, utils.jl:34-36).

    Implementation: cumsum inversion — count the empty tiles, draw ONE
    uniform, select the k-th empty tile by argmax over the running count.
    A masked-gumbel categorical would burn H*W random uniforms per env per
    auto-reset; this draws one.  Auto-reset runs this every step for every
    env, so the random-bit budget matters.  (Selection bias from the
    float32 ``u*n`` inversion is < n/2^24 — far below anything observable.)
    The NumPy oracle mirrors this arithmetic exactly.
    """
    h, w = occupied_map.shape
    nt = h * w
    empty = (~occupied_map.reshape(-1)).astype(jnp.float32)
    c = _prefix_count(empty)
    n = c[-1]
    u = jax.random.uniform(key, (), dtype=jnp.float32)
    k = jnp.clip(jnp.floor(u * n), 0.0, jnp.maximum(n - 1.0, 0.0))
    idx = jnp.argmax(c > k).astype(jnp.int32)
    return jnp.stack([idx // w, idx % w]).astype(jnp.int32)


def sample_empty_tile_pair(
    key_a: jax.Array, key_b: jax.Array, occupied_map: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Two sequential uniform draws — an empty tile, then an empty tile
    excluding the first — sharing ONE prefix count.

    Bit-identical to ``a = sample_empty_tile(key_a, occ);
    b = sample_empty_tile(key_b, occ | onehot(a))``: the second draw's rank
    is bumped past the first tile's empty-rank (which is exactly ``k_a``, no
    gather needed) on the same inclusive prefix, the order-statistics
    identity used throughout the closed-form family resets.  Families whose
    reset draws goal-then-spawn over the same generated map (Maze) halve
    their per-reset prefix/mask work this way — and dense auto-reset runs
    the reset every step for every env.
    """
    h, w = occupied_map.shape
    empty = (~occupied_map.reshape(-1)).astype(jnp.float32)
    c = _prefix_count(empty)
    n = c[-1]
    u1 = jax.random.uniform(key_a, (), dtype=jnp.float32)
    k1 = jnp.clip(jnp.floor(u1 * n), 0.0, jnp.maximum(n - 1.0, 0.0))
    idx1 = jnp.argmax(c > k1).astype(jnp.int32)
    n2 = n - 1.0
    u2 = jax.random.uniform(key_b, (), dtype=jnp.float32)
    k2 = jnp.clip(jnp.floor(u2 * n2), 0.0, jnp.maximum(n2 - 1.0, 0.0))
    k2 = k2 + (k1 <= k2)  # bump past the first tile's empty-rank
    idx2 = jnp.argmax(c > k2).astype(jnp.int32)
    a = jnp.stack([idx1 // w, idx1 % w]).astype(jnp.int32)
    b = jnp.stack([idx2 // w, idx2 % w]).astype(jnp.int32)
    return a, b


_PREFIX_BLOCK = 256


def _prefix_count(empty: jax.Array) -> jax.Array:
    """Inclusive prefix sum of a 0/1 float32 vector, as blocked matvecs.

    A single [n, n] ones-triangle matvec embeds an O(n^2)-memory constant
    that dies quietly beyond small maps (a 64x64 map would mean a 67 MB
    triangle inside every reset).  This is the O(n)-memory version: block
    the vector into [nb, bs], do the
    within-block inclusive prefix against a [bs, bs] triangle, then add the
    exclusive prefix of the block totals (a second small triangular matvec).
    All intermediate values are integer-valued counts <= n, exact in float32
    (n < 2^24), so the result — and every draw derived from it — is
    bit-identical to both the single-triangle and cumsum formulations.

    The products stay exact where a float32 matmul runs in TF32 (as GPU
    tensor cores may by default): every operand is 0, 1 or a block total
    <= bs = 256, all exact in TF32's 11-bit significand, and the sums
    accumulate in float32.  Replacing this with ``jnp.cumsum`` is ROADMAP D2.
    """
    import numpy as np

    nt = empty.shape[0]
    if nt <= _PREFIX_BLOCK:
        triu = jnp.asarray(np.triu(np.ones((nt, nt), np.float32)))
        return jnp.dot(empty, triu, preferred_element_type=jnp.float32)
    bs = _PREFIX_BLOCK
    nb = -(-nt // bs)
    pad = nb * bs - nt
    ep = jnp.concatenate([empty, jnp.zeros((pad,), empty.dtype)]) if pad else empty
    blocks = ep.reshape(nb, bs)
    triu = jnp.asarray(np.triu(np.ones((bs, bs), np.float32)))
    within = jnp.dot(blocks, triu, preferred_element_type=jnp.float32)  # [nb, bs]
    totals = within[:, -1]                                              # [nb]
    striu = jnp.asarray(np.triu(np.ones((nb, nb), np.float32), k=1))
    offsets = jnp.dot(totals, striu, preferred_element_type=jnp.float32)
    return (within + offsets[:, None]).reshape(nb * bs)[:nt]


def sample_empty_interior_tile(
    key: jax.Array, h: int, w: int, exclude_ranks: jax.Array
) -> jax.Array:
    """Closed-form uniform draw over the interior tiles of a border-walls-only
    map, minus K excluded tiles — bit-identical to
    ``sample_empty_tile(key, border_walls | excluded)`` (same uniform draw,
    same empty count n, same rank->tile row-major order) at O(K) cost
    instead of the general sampler's O(H*W) mask/prefix work.  Families
    whose maps are exactly border ring + K point objects (SingleRoom is the
    K=1 special case inlined in models/single_room.py) reset through this,
    which matters because dense auto-reset recomputes every env's reset
    every step.

    ``exclude_ranks``: i32[K] *interior ranks* ``(i-1)*(W-2) + (j-1)`` of
    distinct excluded interior tiles (K static, may be 0).
    """
    wi = w - 2
    kx = exclude_ranks.shape[0]
    n = jnp.float32((h - 2) * wi - kx)
    u = jax.random.uniform(key, (), dtype=jnp.float32)
    k = jnp.clip(jnp.floor(u * n), 0.0, jnp.maximum(n - 1.0, 0.0)).astype(
        jnp.int32
    )
    # Order statistics over the complement: bump the rank past each excluded
    # tile at or below it, in ascending order (running r).
    r = k
    rs = jnp.sort(exclude_ranks) if kx > 1 else exclude_ranks
    for q in range(kx):
        r = r + (rs[q] <= r).astype(jnp.int32)
    return jnp.stack([1 + r // wi, 1 + r % wi]).astype(jnp.int32)


def interior_rank(tile: jax.Array, w: int) -> jax.Array:
    """Row-major interior rank of an interior tile i32[2] (inverse of the
    rank->tile mapping in :func:`sample_empty_interior_tile`)."""
    return (tile[0] - 1) * (w - 2) + (tile[1] - 1)


def sample_interior_tile(key: jax.Array, h: int, w: int) -> jax.Array:
    """Uniform tile in the interior ``[1, H-1) x [1, W-1)`` — the goal draw
    (/root/reference/src/single_room.jl:120: i then j, uniform over
    ``2:H-1 x 2:W-1`` 1-indexed)."""
    return jax.random.randint(
        key,
        (2,),
        jnp.array([1, 1]),
        jnp.array([h - 1, w - 1]),
        dtype=jnp.int32,
    )


def sample_heading(
    key: jax.Array, num_directions: int, continuous: bool = False
) -> jax.Array:
    """Uniform heading in ``[0, num_directions)``
    (/root/reference/src/single_room.jl:128) — an int32 angle unit, or a
    float32 when the config opts into continuous headings."""
    if continuous:
        return jax.random.uniform(
            key, (), dtype=jnp.float32, maxval=float(num_directions)
        )
    return jax.random.randint(key, (), 0, num_directions, dtype=jnp.int32)

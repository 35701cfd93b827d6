"""Closed-form raycaster for room-shaped maps (border ring + K unit boxes).

The reference's map is structurally trivial: a solid border ring plus one
goal tile (/root/reference/src/single_room.jl:55-63), and the MultiGoalRoom /
DynamicRoom families only add K more unit boxes.  A DDA march is therefore
overkill — the first occupied tile along any interior ray is either

* the border wall whose inner face the ray crosses first, at
  ``t = (face - origin) / dir`` per axis (take the nearer axis), or
* the nearest of the K unit boxes, via standard slab (ray-vs-AABB) tests,

whichever is closer.  O(K) per ray instead of O(H+W) masked DDA iterations —
~an order of magnitude fewer ops for the reference's 8x16 room at small K.

Numerics: distances here are computed in one rounding step, while the DDA
accumulates ``side += delta`` — results agree to ~1e-6 relative but are NOT
bit-identical to the DDA/oracle path.  The bit-exact parity guarantee is
owned by the scan DDA (``raycast_backend="scan"``); this backend is selected
explicitly (``raycast_backend="analytic"``, SingleRoom only) when raw
throughput matters more than bitwise reproducibility.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from .raycast import RayHits


def cast_rays_boxes(
    cfg: EnvConfig,
    boxes_tu: jax.Array,
    pos_wu: jax.Array,
    dir_au: jax.Array,
) -> RayHits:
    """Exact first-hit for border-ring + K unit-box maps (one env; vmap for
    batches).  ``boxes_tu`` is int32[K, 2]; rows outside the interior (e.g.
    (-1, -1) for collected goals) can never win against the border and act
    as disabled slots.  Matches DDA hit tiles/faces; distances agree to
    float32 rounding.  O(K) per ray — for the K<=8 of the room-shaped
    families this is an order of magnitude fewer ops than the masked
    O(H+W) DDA march."""
    from . import lut as lut_ops

    h, w = cfg.H, cfg.W
    dirs = lut_ops.take_rows(jnp.asarray(cfg.ray_fan_lut), dir_au)  # [R, 2]
    dx, dy = dirs[:, 0], dirs[:, 1]
    px, py = pos_wu[0], pos_wu[1]

    inf = jnp.asarray(jnp.inf, dirs.dtype)

    # --- border walls: inner faces at i=1 / i=h-1 and j=1 / j=w-1 ---
    face_i = jnp.where(dx > 0, jnp.asarray(h - 1, dirs.dtype), jnp.asarray(1, dirs.dtype))
    face_j = jnp.where(dy > 0, jnp.asarray(w - 1, dirs.dtype), jnp.asarray(1, dirs.dtype))
    t_i = jnp.where(dx != 0, (face_i - px) / dx, inf)
    t_j = jnp.where(dy != 0, (face_j - py) / dy, inf)
    wall_dim = jnp.where(t_i < t_j, 0, 1).astype(jnp.int32)
    t_wall = jnp.minimum(t_i, t_j)
    # wall tile: step into the ring at the crossing point
    wi = jnp.where(
        wall_dim == 0,
        jnp.where(dx > 0, h - 1, 0),
        jnp.floor(px + t_wall * dx).astype(jnp.int32),
    )
    wj = jnp.where(
        wall_dim == 1,
        jnp.where(dy > 0, w - 1, 0),
        jnp.floor(py + t_wall * dy).astype(jnp.int32),
    )
    wi = jnp.clip(wi, 0, h - 1)
    wj = jnp.clip(wj, 0, w - 1)

    # --- K unit boxes: slab test on [gi, gi+1] x [gj, gj+1], broadcast
    # [R, K] (K static and small) ---
    g0 = boxes_tu.astype(dirs.dtype)  # [K, 2]
    g1 = g0 + 1.0
    dxk = dx[:, None]
    dyk = dy[:, None]
    # per-axis entry/exit params (inf-safe: dir==0 handled by +/-inf ordering)
    tx1 = jnp.where(dxk != 0, (g0[None, :, 0] - px) / dxk,
                    jnp.where(px >= g0[None, :, 0], -inf, inf))
    tx2 = jnp.where(dxk != 0, (g1[None, :, 0] - px) / dxk,
                    jnp.where(px <= g1[None, :, 0], inf, -inf))
    ty1 = jnp.where(dyk != 0, (g0[None, :, 1] - py) / dyk,
                    jnp.where(py >= g0[None, :, 1], -inf, inf))
    ty2 = jnp.where(dyk != 0, (g1[None, :, 1] - py) / dyk,
                    jnp.where(py <= g1[None, :, 1], inf, -inf))
    tx_in = jnp.minimum(tx1, tx2)
    tx_out = jnp.maximum(tx1, tx2)
    ty_in = jnp.minimum(ty1, ty2)
    ty_out = jnp.maximum(ty1, ty2)
    t_enter = jnp.maximum(tx_in, ty_in)  # [R, K]
    t_exit = jnp.minimum(tx_out, ty_out)
    box_hit = (t_enter > 0) & (t_enter <= t_exit)
    box_dim = jnp.where(tx_in >= ty_in, 0, 1).astype(jnp.int32)

    t_box = jnp.where(box_hit, t_enter, inf)  # [R, K]
    best = jnp.argmin(t_box, axis=1)  # [R]
    onehot = best[:, None] == jnp.arange(boxes_tu.shape[0])[None, :]
    t_best = jnp.min(t_box, axis=1)  # [R]
    dim_best = jnp.sum(jnp.where(onehot, box_dim, 0), axis=1)
    bi = jnp.sum(
        jnp.where(onehot, boxes_tu[None, :, 0], 0), axis=1
    ).astype(jnp.int32)
    bj = jnp.sum(
        jnp.where(onehot, boxes_tu[None, :, 1], 0), axis=1
    ).astype(jnp.int32)

    use_box = t_best < t_wall
    dist = jnp.where(use_box, t_best, t_wall)
    hit_dim = jnp.where(use_box, dim_best, wall_dim)
    hit_i = jnp.where(use_box, bi, wi)
    hit_j = jnp.where(use_box, bj, wj)

    return RayHits(
        ray_dirs=dirs,
        hit_tu=jnp.stack([hit_i, hit_j], axis=-1),
        hit_dim=hit_dim,
        dist_wu=dist,
    )


def cast_rays_analytic(
    cfg: EnvConfig,
    goal_tu: jax.Array,
    pos_wu: jax.Array,
    dir_au: jax.Array,
) -> RayHits:
    """Border + single-goal specialization (SingleRoom): K=1 box."""
    return cast_rays_boxes(cfg, goal_tu[None, :], pos_wu, dir_au)

"""Top-view (bird's-eye) renderer — the debug/visualization view.

Reference: ``draw_tile_map!`` + ``update_top_view!``
(/root/reference/src/single_room.jl:342-372,446-483): tile grid as filled
rectangles with 1-px grid lines, 512 ray segments from the player to each hit
point, and the player circle, drawn with SimpleDraw shapes.

Batched: the tile blit and grid lines are pure broadcasting; the ray
segments are Bresenham marches vectorized across all rays under one
``lax.scan`` whose points scatter into the image; the player circle is a
distance-band mask.  Pixel-level algorithms (Bresenham, circle) are specified
here and mirrored exactly in the NumPy oracle — SimpleDraw's private
rasterization rules are not reproduced bit-for-bit (API parity, not pixel
parity, for this debug surface; the *layout* — geometry, colors, draw order —
matches the reference).

This stays off the RL hot path by default (camera view is the observation,
ref :576); it is available as an obs_type for parity/debug workloads.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import colors
from ..config import EnvConfig
from .raycast import RayHits
from .units import wu_to_pu


def bresenham_points(
    p0: jax.Array, p1: jax.Array, max_len: int
) -> Tuple[jax.Array, jax.Array]:
    """Integer Bresenham line points for a batch of segments.

    p0, p1: i32[..., 2] endpoints (inclusive).
    Returns (points i32[max_len, ..., 2], valid bool[max_len, ...]).
    Standard integer Bresenham; points beyond the segment end are invalid.
    """
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    dx = jnp.abs(x1 - x0)
    dy = -jnp.abs(y1 - y0)
    sx = jnp.where(x0 < x1, 1, -1)
    sy = jnp.where(y0 < y1, 1, -1)

    def body(carry, _):
        x, y, err, alive = carry
        pt = jnp.stack([x, y], axis=-1)
        at_end = (x == x1) & (y == y1)
        e2 = 2 * err
        step_x = (e2 >= dy) & alive & ~at_end
        step_y = (e2 <= dx) & alive & ~at_end
        err = err + jnp.where(step_x, dy, 0) + jnp.where(step_y, dx, 0)
        x = x + jnp.where(step_x, sx, 0)
        y = y + jnp.where(step_y, sy, 0)
        return (x, y, err, alive & ~at_end), (pt, alive)

    init = (x0, y0, dx + dy, jnp.ones_like(x0, bool))
    _, (pts, valid) = jax.lax.scan(body, init, None, length=max_len)
    return pts, valid


def render_tile_blit(
    cfg: EnvConfig,
    wall_map: jax.Array,
    goal_tu: jax.Array,
    goal_map=None,
    block_map=None,
) -> jax.Array:
    """Tile rectangles + grid lines (ref draw_tile_map!, :342-372):
    wall=white, goal=red, empty=black (tile_map_colors, :288), 1-px
    0xCCCCCC border around every tile (:364-367).  ``goal_map`` (dense bool)
    overrides the single ``goal_tu`` tile (multi-goal family); ``block_map``
    adds moving obstacles in blue (DynamicRoom)."""
    ppt = cfg.pu_per_tu
    h, w = cfg.H, cfg.W
    if goal_map is None:
        ii = jnp.arange(h)[:, None]
        jj = jnp.arange(w)[None, :]
        goal_map = (ii == goal_tu[0]) & (jj == goal_tu[1])
    tile_color = jnp.where(
        wall_map,
        jnp.uint32(colors.TILE_WALL),
        jnp.where(goal_map, jnp.uint32(colors.TILE_GOAL), jnp.uint32(colors.TILE_EMPTY)),
    )
    if block_map is not None:
        tile_color = jnp.where(
            block_map & ~wall_map, jnp.uint32(colors.TILE_BLOCK), tile_color
        )
    img = jnp.repeat(jnp.repeat(tile_color, ppt, axis=0), ppt, axis=1)
    pi = jnp.arange(h * ppt) % ppt
    pj = jnp.arange(w * ppt) % ppt
    line = (pi[:, None] == 0) | (pi[:, None] == ppt - 1) \
        | (pj[None, :] == 0) | (pj[None, :] == ppt - 1)
    return jnp.where(line, jnp.uint32(colors.GRID_LINE), img)


def render_top_view(
    cfg: EnvConfig,
    wall_map: jax.Array,
    goal_tu: jax.Array,
    pos_wu: jax.Array,
    player_radius_pu_hint: int,
    hits: RayHits,
    goal_map=None,
    block_map=None,
    others_pu=None,
) -> jax.Array:
    """uint32[H*ppt, W*ppt] top view for one env (ref :446-483).

    Draw order matches the reference: tile map, then ray segments, then the
    player circle on top.  ``others_pu`` (i32[K, 2], optional) draws other
    players as FILLED circles of the player radius in the TILE_BLOCK color
    between the rays and the self circle (MultiPlayerRoom sprite mode —
    sub-tile positions, unlike ``block_map``'s whole tiles).
    """
    ppt = cfg.pu_per_tu
    hpu, wpu = cfg.top_view_shape
    img = render_tile_blit(cfg, wall_map, goal_tu, goal_map, block_map)

    # --- ray segments (ref :474-478) ---
    p_px = wu_to_pu(pos_wu, ppt)  # i32[2]
    # Endpoint: the hit-axis coordinate is ALWAYS exactly a gridline (the
    # entered face of the hit tile), so compute it from integer hit data —
    # a float `pos + dist*dir` is FMA-fusion-sensitive and flips the floor()
    # pixel by one on exactly these gridline values.  Only the cross-axis
    # coordinate (generically non-integer) stays in float.
    step_pos = hits.ray_dirs >= 0  # [R, 2]
    face = jnp.where(step_pos, hits.hit_tu, hits.hit_tu + 1)  # i32[R, 2]
    cross_wu = pos_wu[None, :] + hits.dist_wu[:, None] * hits.ray_dirs
    cross_px = wu_to_pu(cross_wu, ppt)  # i32[R, 2]
    axis_px = face * ppt
    is_axis = (
        jnp.arange(2, dtype=jnp.int32)[None, :] == hits.hit_dim[:, None]
    )
    stop_px = jnp.where(is_axis, axis_px, cross_px)  # i32[R, 2]
    r = hits.ray_dirs.shape[0]
    p0 = jnp.broadcast_to(p_px[None, :], (r, 2))
    pts, valid = bresenham_points(p0, stop_px, max_len=hpu + wpu)  # [L, R, 2]
    flat_idx = pts[..., 0] * wpu + pts[..., 1]
    inb = (
        valid
        & (pts[..., 0] >= 0) & (pts[..., 0] < hpu)
        & (pts[..., 1] >= 0) & (pts[..., 1] < wpu)
    )
    # Out-of-range sentinel (NOT -1: negative indices wrap, they don't drop).
    flat_idx = jnp.where(inb, flat_idx, hpu * wpu)
    img = (
        img.reshape(-1)
        .at[flat_idx.reshape(-1)]
        .set(jnp.uint32(colors.RAY), mode="drop")
        .reshape(hpu, wpu)
    )

    rad = player_radius_pu_hint

    # --- other players as filled circles (sprite mode) ---
    if others_pu is not None:
        oi = jnp.arange(hpu)[:, None, None] - others_pu[None, None, :, 0]
        oj = jnp.arange(wpu)[None, :, None] - others_pu[None, None, :, 1]
        od = jnp.sqrt((oi * oi + oj * oj).astype(jnp.float32))
        filled = jnp.any(jnp.round(od).astype(jnp.int32) <= rad, axis=-1)
        img = jnp.where(filled, jnp.uint32(colors.TILE_BLOCK), img)

    # --- player circle outline (ref :480): center = player pixel, radius in
    # pixels; band where rounded distance equals the radius ---
    di = jnp.arange(hpu)[:, None] - p_px[0]
    dj = jnp.arange(wpu)[None, :] - p_px[1]
    dist = jnp.sqrt((di * di + dj * dj).astype(jnp.float32))
    on_circle = jnp.round(dist).astype(jnp.int32) == rad
    return jnp.where(on_circle, jnp.uint32(colors.PLAYER), img)

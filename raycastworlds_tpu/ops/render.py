"""Camera-view renderer — the RL observation.

Reference: ``update_camera_view!`` (/root/reference/src/single_room.jl:374-444):
per ray, fisheye-correct the DDA distance by the dot with the player direction,
compute a wall-column height, pick a two-shade color by (wall-or-goal x
hit-face axis), and write a mirrored ceiling/wall/floor column.

Batched re-conception: no per-column loop or branches — the whole
[H_pu, R] image is a single vectorized compare-and-select over a row-index
iota against per-ray padding, which XLA fuses with the DDA epilogue into one
kernel.  The reference's ``for i; if/else`` per column disappears entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import colors
from ..config import EnvConfig
from .raycast import RayHits


def projected_depth(player_dir_wu: jax.Array, hits: RayHits) -> jax.Array:
    """Fisheye-corrected depth per ray: ``dist * dot(player_dir, ray_dir)``
    (ref :404)."""
    return hits.dist_wu * jnp.sum(player_dir_wu[None, :] * hits.ray_dirs, axis=-1)


def column_colors_u32(
    wall_words: jax.Array, shape, hits: RayHits, block_words=None
) -> jax.Array:
    """Per-ray wall-slab color, uint32[R], from a bit-packed wall map.

    Ref :417-429: if the hit tile has the WALL bit -> wall shades, else goal
    shades; shade picked by hit-face axis (two shades fake lighting).
    ``block_words`` (DynamicRoom moving obstacles; no reference equivalent)
    adds a third two-shade pair checked between wall and goal.
    """
    from . import bitmap

    hi = hits.hit_tu[:, 0]
    hj = hits.hit_tu[:, 1]
    h, w = shape
    idx = jnp.clip(hi, 0, h - 1) * w + jnp.clip(hj, 0, w - 1)
    is_wall = bitmap.lookup_bit(wall_words, idx)
    dim_i = hits.hit_dim == 0
    wall_c = jnp.where(
        dim_i,
        jnp.uint32(colors.WALL_DIM_I),
        jnp.uint32(colors.WALL_DIM_J),
    )
    goal_c = jnp.where(
        dim_i,
        jnp.uint32(colors.GOAL_DIM_I),
        jnp.uint32(colors.GOAL_DIM_J),
    )
    out = jnp.where(is_wall, wall_c, goal_c)
    if block_words is not None:
        is_block = bitmap.lookup_bit(block_words, idx)
        block_c = jnp.where(
            dim_i,
            jnp.uint32(colors.BLOCK_DIM_I),
            jnp.uint32(colors.BLOCK_DIM_J),
        )
        out = jnp.where(is_block & ~is_wall, block_c, out)
    return out


def _column_pads(cfg: EnvConfig, player_dir_wu: jax.Array, hits: RayHits):
    """(pad i32[R], height_line f32[R]) — the shared column geometry of the
    camera renderers (reference :401-441 under 0-indexing):
      height_line = cam_h * R / (2 * sfov * projected)       (:406)
      non-finite height -> full column                        (:407-411)
      height_pu >= H_pu - 1 -> full wall column (pad 0)       (:433-434)
      else pad = (H_pu - height_pu) // 2                      (:436-439)
    Factored out so the u32 and pal8 renders share the exact arithmetic —
    palette-decode parity between them is structural, not numerical luck.
    """
    hpu = cfg.height_camera_view_pu
    r = cfg.num_rays
    proj = projected_depth(player_dir_wu, hits)  # f32[R]
    # Host-computed constants at cfg precision (identical in the NumPy
    # oracle) keep the expression bit-reproducible across backends.
    num = jnp.asarray(
        cfg.float_dtype(cfg.camera_height_tile_wu * r), proj.dtype
    )
    denom_c = jnp.asarray(
        cfg.float_dtype(2.0 * cfg.semi_field_of_view_wu), proj.dtype
    )
    height_line = num / (denom_c * proj)
    finite = jnp.isfinite(height_line)
    # Clamp before the int cast (avoids int overflow); clamping at hpu keeps
    # the `>= hpu - 1` full-column predicate intact.
    h_pu = jnp.where(
        finite,
        jnp.floor(jnp.minimum(height_line, jnp.asarray(hpu, proj.dtype))).astype(jnp.int32),
        hpu,
    )
    full = h_pu >= hpu - 1
    pad = jnp.where(full, 0, (hpu - h_pu) // 2)  # i32[R]
    return pad, height_line


def render_camera_u32(
    cfg: EnvConfig,
    wall_words: jax.Array,
    player_dir_wu: jax.Array,
    hits: RayHits,
    block_words=None,
    pos_wu=None,
) -> jax.Array:
    """uint32[H_pu, num_rays] 0x00RRGGBB camera view for one env.

    Bit-exact with the reference algorithm (:401-441) under 0-indexing: see
    :func:`_column_pads` for the column geometry; columns are written
    mirrored, ``k = R - 1 - i`` (:431).
    """
    hpu = cfg.height_camera_view_pu
    pad, height_line = _column_pads(cfg, player_dir_wu, hits)

    slab = column_colors_u32(
        wall_words, (cfg.H, cfg.W), hits, block_words
    )  # u32[R]
    # Mirror (:431) by flipping the cheap per-ray vectors BEFORE the [H, R]
    # broadcast — flipping the full image afterwards is a whole-image
    # relayout pass for nothing.
    pad = jnp.flip(pad, axis=0)
    slab = jnp.flip(slab, axis=0)
    row = jnp.arange(hpu, dtype=jnp.int32)[:, None]  # [H_pu, 1]
    wall_px = slab[None, :]
    if cfg.wall_texture != "none":
        if pos_wu is None:
            raise ValueError("wall_texture requires pos_wu (the ray origin)")
        wall_px = _texture_wall(cfg, wall_px, hits, pos_wu, height_line, row)
    img = jnp.where(
        row < pad[None, :],
        jnp.uint32(colors.CEILING),
        jnp.where(
            row >= (hpu - pad)[None, :],
            jnp.uint32(colors.FLOOR),
            wall_px,
        ),
    )
    return img


def _texture_uv(cfg, hits: RayHits, pos_wu, height_line, row):
    """(ui i32[R] mirrored, vi i32[H_pu, R]) integer texel coordinates of
    the procedural wall textures — shared by the u32 and pal8 renderers so
    their texel selection is structurally identical.

    Texture coordinates follow the classic raycaster scheme: ``u`` is the
    fractional hit coordinate along the wall face — the non-hit-axis
    component of ``pos + dist*dir`` minus the hit tile's low edge; ``v`` runs
    down the *unclipped* projected column so close-up walls magnify
    correctly.
    """
    t = cfg.texture_cells
    hpu = cfg.height_camera_view_pu

    # u in [0, 1): cross-axis offset of the hit point within the hit tile.
    take_j = hits.hit_dim == 0  # hit face perpendicular to i => cross axis j
    dir_cross = jnp.where(take_j, hits.ray_dirs[:, 1], hits.ray_dirs[:, 0])
    pos_cross = jnp.where(take_j, pos_wu[1], pos_wu[0])
    tile_cross = jnp.where(
        take_j, hits.hit_tu[:, 1], hits.hit_tu[:, 0]
    ).astype(hits.dist_wu.dtype)
    cross = pos_cross + hits.dist_wu * dir_cross
    frac_u = jnp.clip(cross - tile_cross, 0.0, 1.0 - 1e-6)
    ui = jnp.clip((frac_u * t).astype(jnp.int32), 0, t - 1)  # i32[R]
    ui = jnp.flip(ui, axis=0)  # mirrored like the slab colors

    # v: position down the *unclipped* column (perspective-correct close up),
    # computed in exact integer arithmetic.  A float formulation
    # ``vi = floor(t * (row - top)/hl)`` lands *structurally* on the knife
    # edge v == 0.5 at the column's center row, where 1-ulp noise from
    # LLVM-level FMA contraction (below HLO, so optimization_barrier cannot
    # pin it) flips the texel between compilation contexts and vs the scalar
    # oracle.  With an integer column height h = floor(height_line) the texel
    # index is vi = floor(t * (2*row - hpu + h) / (2*h)) — doubled
    # coordinates keep the half-pixel top offset exact, and the only
    # float->int transition left is the same floor the slab renderer already
    # takes.  Integer ops are also cheaper than an [H, R] f32 divide.
    # Bounds t * (2*row + h) below int32 overflow for any texture_cells:
    # 2^20 for small t (the historical value — bit-identical images), shrunk
    # so that t * 2 * cap stays under 2^31 when t is large.
    cap = min(1 << 20, (1 << 30) // (2 * t))
    hl = jnp.flip(height_line, axis=0)  # f32[R] (may be inf)
    h_full = jnp.where(
        jnp.isfinite(hl),
        jnp.floor(jnp.minimum(hl, jnp.asarray(float(cap), hl.dtype))).astype(
            jnp.int32
        ),
        cap,
    )
    h_full = jnp.maximum(h_full, 1)  # i32[R]
    numer = t * (2 * row - hpu + h_full[None, :])  # i32[H_pu, R]
    vi = jnp.clip(
        jnp.floor_divide(numer, 2 * h_full[None, :]), 0, t - 1
    )  # i32[H_pu, R]
    return ui, vi


def _texture_factor_index(cfg, ui, vi):
    """i32[H_pu, R] index into ``colors.texture_factors`` per pixel —
    THE texel selection rule, shared by the u32 (factor arithmetic) and
    pal8 (palette index) paths.  checker/brick: 0 = bright, 1 = dim;
    xor: the gradient level ui ^ vi in [0, texture_cells)."""
    t = cfg.texture_cells
    if cfg.wall_texture == "checker":
        return (ui[None, :] + vi) & 1
    if cfg.wall_texture == "brick":
        course_h = max(t // 4, 1)          # brick course height in texels
        brick_w = max(t // 2, 2)           # brick length in texels
        course = vi // course_h
        off = jnp.where((course & 1) == 1, brick_w // 2, 0)
        mortar = (vi % course_h == 0) | (((ui[None, :] + off) % brick_w) == 0)
        return mortar.astype(jnp.int32)
    # "xor"
    return ui[None, :] ^ vi


def _texture_wall(cfg, wall_px, hits: RayHits, pos_wu, height_line, row):
    """Procedural per-pixel wall texturing, fully arithmetic (no texture
    memory, no gathers).  The
    pattern modulates the flat two-shade slab color, so texel brightness
    composes with the reference's fake-lighting face shading.  See
    :func:`_texture_uv` / :func:`_texture_factor_index` for the texel
    selection shared with the pal8 path."""
    ui, vi = _texture_uv(cfg, hits, pos_wu, height_line, row)
    fidx = _texture_factor_index(cfg, ui, vi)

    if cfg.wall_texture == "checker":
        factor = jnp.where(fidx == 0, 1.0, 0.55).astype(jnp.float32)
    elif cfg.wall_texture == "brick":
        factor = jnp.where(fidx == 1, 0.45, 1.0).astype(jnp.float32)
    else:  # "xor"
        g = fidx.astype(jnp.float32) / float(max(cfg.texture_cells - 1, 1))
        factor = 0.4 + 0.6 * g

    r = ((wall_px >> 16) & 0xFF).astype(jnp.float32) * factor
    gch = ((wall_px >> 8) & 0xFF).astype(jnp.float32) * factor
    b = (wall_px & 0xFF).astype(jnp.float32) * factor
    return (
        (r.astype(jnp.uint32) << 16)
        | (gch.astype(jnp.uint32) << 8)
        | b.astype(jnp.uint32)
    )




def u32_to_rgb(img: jax.Array) -> jax.Array:
    """Unpack 0x00RRGGBB -> uint8[..., 3] on device.

    A channels-minor u8 array of width 3 is an awkward memory layout;
    max-throughput RGB consumers can take camera_u32 and unpack on the
    consumer side, where the conversion fuses into their first op
    (parallel/ppo.preprocess_obs does exactly this)."""
    return jnp.stack(
        [
            (img >> 16) & 0xFF,
            (img >> 8) & 0xFF,
            img & 0xFF,
        ],
        axis=-1,
    ).astype(jnp.uint8)


def u32_to_gray(img: jax.Array) -> jax.Array:
    """Rec.601 luma in [0, 1] float32."""
    r = ((img >> 16) & 0xFF).astype(jnp.float32)
    g = ((img >> 8) & 0xFF).astype(jnp.float32)
    b = (img & 0xFF).astype(jnp.float32)
    return (0.299 * r + 0.587 * g + 0.114 * b) / 255.0


def u32_to_gray_u8(img: jax.Array) -> jax.Array:
    """Rec.601 luma quantized to uint8 [0, 255] — the 1-byte grayscale
    observation (``camera_gray_u8``).  Planar [H_pu, R] layout: the wide ray
    axis stays minor, unlike the channels-minor u8 forms.  The u32
    intermediate fuses into this conversion under jit (verified for the rgb
    unpack by compiled memory analysis), so only the 1-byte image is
    written to device memory.

    Rounds to nearest (+0.5 then truncate) rather than truncating: pure
    truncation maps white to 254 whenever FMA/fusion lands the f32 weight
    sum one ulp below 255, which made bit-parity against unfused host
    arithmetic backend-dependent; round-to-nearest is a half-ulp away from
    any boundary for these weights."""
    r = ((img >> 16) & 0xFF).astype(jnp.float32)
    g = ((img >> 8) & 0xFF).astype(jnp.float32)
    b = (img & 0xFF).astype(jnp.float32)
    return (0.299 * r + 0.587 * g + 0.114 * b + 0.5).astype(jnp.uint8)


def column_colors_pal8(
    wall_words: jax.Array, shape, hits: RayHits, block_words=None
) -> jax.Array:
    """Per-ray wall-slab PALETTE INDEX, uint8[R] — the 1-byte twin of
    :func:`column_colors_u32` (identical predicates, index constants from
    ``colors.PALETTE`` instead of 0x00RRGGBB values)."""
    from . import bitmap

    hi = hits.hit_tu[:, 0]
    hj = hits.hit_tu[:, 1]
    h, w = shape
    idx = jnp.clip(hi, 0, h - 1) * w + jnp.clip(hj, 0, w - 1)
    is_wall = bitmap.lookup_bit(wall_words, idx)
    dim_i = hits.hit_dim == 0
    wall_c = jnp.where(
        dim_i,
        jnp.uint8(colors.PAL_WALL_DIM_I),
        jnp.uint8(colors.PAL_WALL_DIM_J),
    )
    goal_c = jnp.where(
        dim_i,
        jnp.uint8(colors.PAL_GOAL_DIM_I),
        jnp.uint8(colors.PAL_GOAL_DIM_J),
    )
    out = jnp.where(is_wall, wall_c, goal_c)
    if block_words is not None:
        is_block = bitmap.lookup_bit(block_words, idx)
        block_c = jnp.where(
            dim_i,
            jnp.uint8(colors.PAL_BLOCK_DIM_I),
            jnp.uint8(colors.PAL_BLOCK_DIM_J),
        )
        out = jnp.where(is_block & ~is_wall, block_c, out)
    return out


def _slab_slots(wall_words, shape, hits: RayHits, block_words=None):
    """Per-ray textured-slab slot i32[R] in ``colors.TEX_SLABS`` order
    (wall_i, wall_j, goal_i, goal_j, block_i, block_j) — same predicates as
    :func:`column_colors_u32`, producing an index instead of a color."""
    from . import bitmap

    hi = hits.hit_tu[:, 0]
    hj = hits.hit_tu[:, 1]
    h, w = shape
    idx = jnp.clip(hi, 0, h - 1) * w + jnp.clip(hj, 0, w - 1)
    is_wall = bitmap.lookup_bit(wall_words, idx)
    dim_j = (hits.hit_dim == 1).astype(jnp.int32)  # +1 selects the _J shade
    slot = jnp.where(is_wall, dim_j, 2 + dim_j)
    if block_words is not None:
        is_block = bitmap.lookup_bit(block_words, idx)
        slot = jnp.where(is_block & ~is_wall, 4 + dim_j, slot)
    return slot


def render_camera_pal8(
    cfg: EnvConfig,
    wall_words: jax.Array,
    player_dir_wu: jax.Array,
    hits: RayHits,
    block_words=None,
    pos_wu=None,
) -> jax.Array:
    """uint8[H_pu, num_rays] palette-index camera view for one env.

    LOSSLESS: the scene vocabulary is ``cfg.palette_np`` — the 12-color
    base ``colors.PALETTE``, extended (wall textures on) with the 6 slab
    colors x F brightness factors, each entry the exact u32 the float
    texture chain produces — so
    ``pal8_to_u32(render_camera_pal8(...), cfg.palette_np)
    == render_camera_u32(...)`` bit-exactly (same :func:`_column_pads`
    geometry, same select predicates, same :func:`_texture_factor_index`
    texel rule; only constants-vs-indices differ).  At 1/4 the observation
    bytes of ``camera_u32`` this is the max-throughput camera form.
    """
    hpu = cfg.height_camera_view_pu
    pad, height_line = _column_pads(cfg, player_dir_wu, hits)
    row = jnp.arange(hpu, dtype=jnp.int32)[:, None]  # [H_pu, 1]
    if cfg.wall_texture != "none":
        if pos_wu is None:
            raise ValueError("wall_texture requires pos_wu (the ray origin)")
        nf = len(colors.texture_factors(cfg.wall_texture, cfg.texture_cells))
        slot = jnp.flip(
            _slab_slots(wall_words, (cfg.H, cfg.W), hits, block_words),
            axis=0,
        )  # mirrored like the u32 slab colors
        ui, vi = _texture_uv(cfg, hits, pos_wu, height_line, row)
        fidx = _texture_factor_index(cfg, ui, vi)  # i32[H_pu, R]
        wall_band = (
            colors.PAL_TEX_BASE + slot[None, :] * nf + fidx
        ).astype(jnp.uint8)
    else:
        slab = column_colors_pal8(
            wall_words, (cfg.H, cfg.W), hits, block_words
        )  # u8[R]
        wall_band = jnp.flip(slab, axis=0)[None, :]
    pad = jnp.flip(pad, axis=0)  # mirror (:431), flipped before broadcast
    return jnp.where(
        row < pad[None, :],
        jnp.uint8(colors.PAL_CEILING),
        jnp.where(
            row >= (hpu - pad)[None, :],
            jnp.uint8(colors.PAL_FLOOR),
            wall_band,
        ),
    )


def sprite_overlay(
    cfg: EnvConfig,
    img: jax.Array,
    player_dir_wu: jax.Array,
    hits: RayHits,
    t_sprite: jax.Array,
    color: jax.Array,
    sprite_height_wu: float,
) -> jax.Array:
    """Overlay floor-standing billboard sprite columns onto a rendered
    camera image (MultiPlayerRoom's sub-tile player rendering; no reference
    equivalent — the reference is single-player).

    ``t_sprite``: f32[R] distance along each (unflipped, cast-order) ray to
    the nearest sprite surface, +inf where the ray misses every sprite.
    The sprite is drawn where it is CLOSER than the wall/goal hit
    (occlusion), as a column whose bottom sits where a wall column at the
    sprite's fisheye-projected distance would end (same pad rule as
    :func:`_column_pads` — the sprite stands on the floor) and whose height
    is ``sprite_height_wu`` of that distance's wall height.  ``color`` must
    be a scalar of the image dtype (u32 color or u8 palette index), so the
    overlay works for camera_u32 and camera_pal8 alike.  Scalar mirror:
    oracle/families.OracleMultiPlayer.
    """
    hpu = cfg.height_camera_view_pu
    r = cfg.num_rays
    dt = hits.dist_wu.dtype
    visible = t_sprite < hits.dist_wu
    proj = t_sprite * jnp.sum(player_dir_wu[None, :] * hits.ray_dirs, axis=-1)
    num = jnp.asarray(cfg.float_dtype(cfg.camera_height_tile_wu * r), dt)
    denom_c = jnp.asarray(
        cfg.float_dtype(2.0 * cfg.semi_field_of_view_wu), dt
    )
    h_line = num / (denom_c * proj)
    h_line = jnp.where(visible & jnp.isfinite(h_line), h_line, 0.0)
    h_pu = jnp.floor(jnp.minimum(h_line, jnp.asarray(hpu, dt))).astype(
        jnp.int32
    )
    pad = jnp.where(h_pu >= hpu - 1, 0, (hpu - h_pu) // 2)
    bottom = hpu - pad  # [R]
    hs = jnp.floor(
        jnp.minimum(
            jnp.asarray(cfg.float_dtype(sprite_height_wu), dt) * h_line,
            jnp.asarray(hpu, dt),
        )
    ).astype(jnp.int32)
    top = jnp.maximum(bottom - hs, 0)  # [R]
    # mirror like the wall columns (ref :431), flipped before broadcast
    visible = jnp.flip(visible, axis=0)
    top = jnp.flip(top, axis=0)
    bottom = jnp.flip(bottom, axis=0)
    row = jnp.arange(hpu, dtype=jnp.int32)[:, None]
    mask = visible[None, :] & (row >= top[None, :]) & (row < bottom[None, :])
    return jnp.where(mask, color, img)


def ray_circle_t(
    pos_wu: jax.Array,
    ray_dirs: jax.Array,
    centers: jax.Array,
    center_mask: jax.Array,
    radius_sq,
) -> jax.Array:
    """Nearest positive ray-circle intersection distance per ray: f32[R],
    +inf where every circle is missed.  ``centers`` f32[K, 2] with bool[K]
    ``center_mask`` disabling rows; standard quadratic (b = d.(c-p),
    disc = b^2 - |c-p|^2 + r^2, near root t = b - sqrt(disc))."""
    dt = ray_dirs.dtype
    dx = ray_dirs[:, 0][:, None]  # [R, 1]
    dy = ray_dirs[:, 1][:, None]
    ox = (centers[:, 0] - pos_wu[0])[None, :]  # [1, K]
    oy = (centers[:, 1] - pos_wu[1])[None, :]
    b = dx * ox + dy * oy                      # [R, K]
    c2 = ox * ox + oy * oy                     # [1, K]
    disc = b * b - c2 + jnp.asarray(radius_sq, dt)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = b - sq
    valid = center_mask[None, :] & (disc >= 0) & (t > 0)
    inf = jnp.asarray(jnp.inf, dt)
    return jnp.min(jnp.where(valid, t, inf), axis=1)  # [R]


def pal8_to_u32(img: jax.Array, palette=None) -> jax.Array:
    """Decode palette indices to 0x00RRGGBB uint32 on device (the consumer-
    side inverse of ``camera_pal8``; fuses into the consumer's first op).
    ``palette`` defaults to the 12-entry base table; textured configs pass
    ``cfg.palette_np``."""
    import numpy as np

    pal = jnp.asarray(
        np.asarray(colors.PALETTE_NP if palette is None else palette)
    )
    return pal[img.astype(jnp.int32)]


def render_observation(
    cfg: EnvConfig,
    wall_words: jax.Array,
    goal_tu: jax.Array,
    player_dir_wu: jax.Array,
    hits: RayHits,
    block_words=None,
    goal_words=None,
    pos_wu=None,
) -> jax.Array:
    """Dispatch on cfg.obs_type.  The u32 camera view is the reference's RL
    state (/root/reference/src/single_room.jl:576)."""
    if cfg.obs_type == "depth":
        return jnp.flip(projected_depth(player_dir_wu, hits), axis=0)
    if cfg.obs_type == "tile_grid":
        from . import bitmap

        grid = bitmap.unpack_bits(wall_words, (cfg.H, cfg.W)).astype(jnp.int32)
        if block_words is not None:
            grid = jnp.where(
                bitmap.unpack_bits(block_words, (cfg.H, cfg.W)), 3, grid
            )
        if goal_words is not None:
            return jnp.where(
                bitmap.unpack_bits(goal_words, (cfg.H, cfg.W)), 2, grid
            )
        return grid.at[goal_tu[0], goal_tu[1]].set(2)
    if cfg.obs_type == "camera_pal8":
        # Native 1-byte path: no u32 intermediate at all.
        return render_camera_pal8(
            cfg, wall_words, player_dir_wu, hits, block_words,
            pos_wu=pos_wu,
        )
    img = render_camera_u32(
        cfg, wall_words, player_dir_wu, hits, block_words, pos_wu
    )
    if cfg.obs_type == "camera_u32":
        return img
    if cfg.obs_type == "camera_rgb":
        return u32_to_rgb(img)
    if cfg.obs_type == "camera_gray":
        return u32_to_gray(img)
    if cfg.obs_type == "camera_gray_u8":
        return u32_to_gray_u8(img)
    raise AssertionError(cfg.obs_type)

"""Render palette.

Byte-for-byte the reference's twelve 0x00RRGGBB constants
(/root/reference/src/single_room.jl:288-296) plus the grid-line gray used by
``draw_tile_map!`` (/root/reference/src/single_room.jl:364-367).
"""

from __future__ import annotations

import numpy as np

# tile_map_colors, indexed by object channel then "empty" last
# (reference :288: (wall, goal, empty)).
TILE_WALL = 0x00FFFFFF
TILE_GOAL = 0x00FF0000
TILE_EMPTY = 0x00000000

RAY = 0x00808080
PLAYER = 0x00C0C0C0
FLOOR = 0x00404040
CEILING = 0x00FFFFFF
WALL_DIM_I = 0x00808080   # hit face perpendicular to i-axis (reference dim 1)
WALL_DIM_J = 0x00C0C0C0   # hit face perpendicular to j-axis (reference dim 2)
GOAL_DIM_I = 0x00800000
GOAL_DIM_J = 0x00C00000
GRID_LINE = 0x00CCCCCC

# Moving-obstacle blocks (DynamicRoom; no reference equivalent — the
# reference palette stops at wall/goal shades).  Blue two-shade pair in the
# same fake-lighting style as the wall/goal pairs.
TILE_BLOCK = 0x000000FF
BLOCK_DIM_I = 0x00000080
BLOCK_DIM_J = 0x000000C0


# ---------------------------------------------------------------------------
# Canonical palette for 1-byte indexed observations ("camera_pal8").
#
# The whole render vocabulary above is 12 DISTINCT 0x00RRGGBB values — the
# scene is a palette image by construction, so a uint8 index carries exactly
# the same information as the uint32 pixel at 1/4 the memory traffic.
# Index order is frozen: parity tests and trained policies depend on it.
# ---------------------------------------------------------------------------

PALETTE = (
    0x00000000,  # 0  black (empty tile)
    0x00FFFFFF,  # 1  white (ceiling, tile-map wall)
    0x00808080,  # 2  gray (wall face dim-i, top-view rays)
    0x00C0C0C0,  # 3  light gray (wall face dim-j, player)
    0x00404040,  # 4  dark gray (floor)
    0x00FF0000,  # 5  red (tile-map goal)
    0x00800000,  # 6  dark red (goal face dim-i)
    0x00C00000,  # 7  mid red (goal face dim-j)
    0x00CCCCCC,  # 8  grid-line gray
    0x000000FF,  # 9  blue (tile-map block)
    0x00000080,  # 10 dark blue (block face dim-i)
    0x000000C0,  # 11 mid blue (block face dim-j)
)

PAL_EMPTY = 0
PAL_CEILING = 1
PAL_WALL_DIM_I = 2
PAL_WALL_DIM_J = 3
PAL_FLOOR = 4
PAL_GOAL = 5
PAL_GOAL_DIM_I = 6
PAL_GOAL_DIM_J = 7
PAL_GRID_LINE = 8
PAL_BLOCK = 9
PAL_BLOCK_DIM_I = 10
PAL_BLOCK_DIM_J = 11

PALETTE_NP = np.array(PALETTE, dtype=np.uint32)
# [12, 3] float32 RGB in [0, 1] — the learner-side decode table
# (parallel/ppo.preprocess_obs one-hot-contracts indices against this).
PALETTE_RGB_F32 = (
    np.stack(
        [(PALETTE_NP >> 16) & 0xFF, (PALETTE_NP >> 8) & 0xFF, PALETTE_NP & 0xFF],
        axis=-1,
    ).astype(np.float32)
    / 255.0
)


# ---------------------------------------------------------------------------
# Extended palette for textured pal8 observations.
#
# The procedural wall textures multiply a slab color by a brightness factor
# drawn from a FINITE set (checker: {1.0, 0.55}; brick: {1.0, 0.45}; xor:
# {0.4 + 0.6*k/(t-1), k in [0, t)}), so "continuous shading" is actually a
# small discrete vocabulary: 12 base colors + 6 textured slab colors x F
# factors.  With F <= MAX_TEX_FACTORS (40) the whole textured scene still
# fits a uint8 index — LOSSLESSLY, because each extended entry stores the
# exact uint32 the float multiply-and-truncate chain produces.
# Entry layout: [0, 12) = PALETTE; 12 + slab_slot*F + factor_idx for the
# textured wall band (slab_slot order = TEX_SLABS).
# ---------------------------------------------------------------------------

PAL_TEX_BASE = 12
TEX_SLABS = (
    WALL_DIM_I, WALL_DIM_J, GOAL_DIM_I, GOAL_DIM_J, BLOCK_DIM_I, BLOCK_DIM_J
)
MAX_TEX_FACTORS = (256 - PAL_TEX_BASE) // len(TEX_SLABS)  # 40


def texture_factors(wall_texture: str, texture_cells: int) -> np.ndarray:
    """float32[F] brightness factors of a texture config, in factor-index
    order (the index the pal8 renderer computes per pixel).  Mirrors the
    jnp arithmetic of ops/render._texture_wall exactly (same f32 constants,
    mul-then-add order for xor)."""
    if wall_texture == "checker":
        return np.array([1.0, 0.55], np.float32)
    if wall_texture == "brick":
        return np.array([1.0, 0.45], np.float32)
    if wall_texture == "xor":
        t = texture_cells
        k = np.arange(t, dtype=np.float32)
        g = k / np.float32(max(t - 1, 1))
        return (np.float32(0.4) + np.float32(0.6) * g).astype(np.float32)
    raise ValueError(f"no texture factors for wall_texture={wall_texture!r}")


def build_texture_palette(wall_texture: str, texture_cells: int) -> np.ndarray:
    """uint32[12 + 6*F] extended palette for a textured config: base PALETTE
    followed by each TEX_SLABS color under each factor, packed with the same
    per-channel f32-multiply-then-truncate the u32 renderer uses."""
    fac = texture_factors(wall_texture, texture_cells)
    if len(fac) > MAX_TEX_FACTORS:
        raise ValueError(
            f"{wall_texture} with texture_cells={texture_cells} needs "
            f"{len(fac)} factors; pal8 fits at most {MAX_TEX_FACTORS}"
        )
    entries = list(PALETTE)
    for slab in TEX_SLABS:
        r = np.float32((slab >> 16) & 0xFF)
        g = np.float32((slab >> 8) & 0xFF)
        b = np.float32(slab & 0xFF)
        for f in fac:
            entries.append(
                (int(np.uint32(r * f)) << 16)
                | (int(np.uint32(g * f)) << 8)
                | int(np.uint32(b * f))
            )
    return np.array(entries, dtype=np.uint32)


def palette_rgb_f32(palette_np: np.ndarray) -> np.ndarray:
    """[N, 3] float32 RGB in [0, 1] decode table for any palette (the
    learner-side one-hot contraction target; see PALETTE_RGB_F32)."""
    p = np.asarray(palette_np, dtype=np.uint32)
    return (
        np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1)
        .astype(np.float32)
        / 255.0
    )


def pal8_to_u32_np(img_pal8: np.ndarray, palette: np.ndarray = None) -> np.ndarray:
    """Decode a palette-index image to 0x00RRGGBB uint32 (host side).
    ``palette`` defaults to the 12-entry base PALETTE; textured configs pass
    ``cfg.palette_np``."""
    pal = PALETTE_NP if palette is None else np.asarray(palette, np.uint32)
    return pal[np.asarray(img_pal8, dtype=np.int64)]


def u32_to_rgb(img_u32: np.ndarray) -> np.ndarray:
    """Unpack 0x00RRGGBB uint32 image to uint8 [..., 3] RGB."""
    img_u32 = np.asarray(img_u32, dtype=np.uint32)
    r = (img_u32 >> 16) & 0xFF
    g = (img_u32 >> 8) & 0xFF
    b = img_u32 & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def rgb_to_u32(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, dtype=np.uint32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]

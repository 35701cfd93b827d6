"""Maze: procedural multi-room mazes, generated on-device per env
(BASELINE config 4).

No reference equivalent.  Classic maze generators (DFS backtracker, Kruskal)
are inherently sequential; the batched choice is the *binary-tree* maze:
every cell independently carves a passage north or west (edge cells have no
choice), which yields a perfect maze — all cells connected, no cycles — from
one vectorized Bernoulli draw, no loops at all.  "Multi-room" then carves K
random rectangular rooms out of the walls; removing walls preserves
connectivity, so every goal stays reachable without any flood fill.

Tile-map layout: odd dimensions ``H = 2*CH+1``, ``W = 2*CW+1``; cells live at
odd coordinates, walls between/around them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..ops import bitmap, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class MazeConfig(EnvConfig):
    """EnvConfig + maze-carving knobs.  H and W must be odd (cells at odd
    coordinates)."""

    height_tile_map_tu: int = 17
    width_tile_map_tu: int = 17
    num_rooms: int = 3           # rectangular rooms carved into the maze
    room_max_half_tu: int = 2    # max room half-extent in tiles

    def __post_init__(self):
        super().__post_init__()
        if self.height_tile_map_tu % 2 == 0 or self.width_tile_map_tu % 2 == 0:
            raise ValueError("maze dimensions must be odd (cells at odd coords)")
        if self.height_tile_map_tu < 5 or self.width_tile_map_tu < 5:
            raise ValueError("maze needs at least 2x2 cells (>= 5x5 tiles)")
        if self.num_rooms < 0:
            raise ValueError("num_rooms must be >= 0")


class Maze(Game):
    def __init__(self, cfg: MazeConfig):
        if not isinstance(cfg, MazeConfig):
            raise TypeError("Maze requires a MazeConfig")
        super().__init__(cfg)

    def _generate_walls(self, k_map: jax.Array) -> jax.Array:
        cfg: MazeConfig = self.cfg
        h, w = cfg.H, cfg.W
        ch, cw = (h - 1) // 2, (w - 1) // 2

        k_coin, k_rooms = jax.random.split(k_map)
        coin = jax.random.bernoulli(k_coin, 0.5, (ch, cw))
        ci = jnp.arange(ch)[:, None]
        cj = jnp.arange(cw)[None, :]
        # binary-tree rule: north when possible and (no west option or coin)
        carve_north = (ci > 0) & ((cj == 0) | coin)
        carve_west = (cj > 0) & ~carve_north

        wall = jnp.ones((h, w), bool)
        wall = wall.at[1::2, 1::2].set(False)                     # cells
        wall = wall.at[2:h - 1:2, 1::2].set(~carve_north[1:, :])  # north passages
        wall = wall.at[1::2, 2:w - 1:2].set(~carve_west[:, 1:])   # west passages

        if cfg.num_rooms > 0:
            ii = jnp.arange(h)[:, None]
            jj = jnp.arange(w)[None, :]
            interior = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
            keys = jax.random.split(k_rooms, cfg.num_rooms)
            for k in range(cfg.num_rooms):
                kc, ks = jax.random.split(keys[k])
                center = jax.random.randint(
                    kc, (2,), jnp.array([1, 1]), jnp.array([h - 1, w - 1])
                )
                half = jax.random.randint(
                    ks, (2,), 1, cfg.room_max_half_tu + 1
                )
                room = (
                    (jnp.abs(ii - center[0]) <= half[0])
                    & (jnp.abs(jj - center[1]) <= half[1])
                    & interior
                )
                wall = wall & ~room
        return wall

    def reset_single(self, key: jax.Array) -> EnvState:
        cfg: MazeConfig = self.cfg
        h, w = cfg.H, cfg.W
        next_key, k_map, k_goal, k_spawn, k_dir = jax.random.split(key, 5)

        wall_map = self._generate_walls(k_map)

        # goal + spawn with one shared prefix count (bit-identical to two
        # masked draws; the reset runs every step under dense auto-reset)
        goal_tu, spawn_tu = sampling.sample_empty_tile_pair(
            k_goal, k_spawn, wall_map
        )
        pos_wu = spawn_tu.astype(cfg.float_dtype) + 0.5
        dir_au = sampling.sample_heading(
            k_dir, cfg.num_directions, cfg.continuous_heading
        )

        zero = jnp.float32(0)
        return EnvState(
            wall_words=bitmap.pack_bits(wall_map),
            hw=(h, w),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zero,
            done=jnp.asarray(False),
            rng_key=next_key,
            t=jnp.int32(0),
            episode_return=zero,
            pending_reset=jnp.asarray(False),
        )


def make(cfg: MazeConfig | None = None, **kw) -> Maze:
    return Maze(cfg if cfg is not None else MazeConfig(**kw))

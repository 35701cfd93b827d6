"""MultiGoalRoom: a walled room with K goal tiles.

No reference equivalent — the reference always has exactly one goal
(/root/reference/src/single_room.jl:28,62-63).  This family generalizes the
goal to a *bit-packed goal mask* (``EnvState.goal_words``, same packed-word
representation as the walls), which keeps every hot-path consumer gather-free:
the raycast obstacle union ORs the goal words in, the renderer's color pick
tests the wall bit and falls through to the goal shades, and the collision
test runs over the packed mask directly.

Two modes:
* ``collect_all=True`` (default): touching a goal pays ``goal_reward`` per
  goal touched and *clears it*; the episode ends when all K are collected.
* ``collect_all=False``: touching any goal terminates (SingleRoom semantics
  with K chances).

Touching a goal never moves the player (the reference's goal-blocks-entry
rule, /root/reference/src/single_room.jl:165-168, kept per-goal here).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..ops import bitmap, collision, raycast, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class MultiGoalConfig(EnvConfig):
    num_goals: int = 3
    collect_all: bool = True

    def __post_init__(self):
        super().__post_init__()
        interior = (self.height_tile_map_tu - 2) * (self.width_tile_map_tu - 2)
        if not (1 <= self.num_goals < interior):
            raise ValueError(
                f"num_goals must be in [1, {interior}) for this map size"
            )


class MultiGoalRoom(Game):
    supports_analytic_raycast = True  # border ring + K unit boxes

    def __init__(self, cfg: MultiGoalConfig):
        if not isinstance(cfg, MultiGoalConfig):
            raise TypeError("MultiGoalRoom requires a MultiGoalConfig")
        super().__init__(cfg)

    def _analytic_boxes(self, state: EnvState):
        return state.goal_tiles

    def reset_single(self, key: jax.Array) -> EnvState:
        cfg: MultiGoalConfig = self.cfg
        h, w = cfg.H, cfg.W
        next_key, k_goals, k_spawn, k_dir = jax.random.split(key, 4)

        wall_words = jnp.asarray(cfg.border_wall_words)

        # K distinct goals, drawn sequentially without replacement via the
        # closed-form interior sampler (bit-identical to the old dense
        # masked-categorical chain; dense auto-reset recomputes every env's
        # reset every step, so the O(K^2) scalar form vs O(K * H*W) dense
        # mask/prefix work keeps the reset from dominating the step).
        gkeys = jax.random.split(k_goals, cfg.num_goals)
        first_goal = None
        tiles = []
        ranks = []
        for k in range(cfg.num_goals):
            ex = (
                jnp.stack(ranks)
                if ranks
                else jnp.zeros((0,), jnp.int32)
            )
            g = sampling.sample_empty_interior_tile(gkeys[k], h, w, ex)
            if first_goal is None:
                first_goal = g
            ranks.append(sampling.interior_rank(g, w))
            tiles.append(g)
        goal_tiles = jnp.stack(tiles).astype(jnp.int32)  # [K, 2]
        goal_words = bitmap.tiles_to_words(
            goal_tiles, (h, w), wall_words.shape[-1]
        )

        spawn_tu = sampling.sample_empty_interior_tile(
            k_spawn, h, w, jnp.stack(ranks)
        )
        pos_wu = spawn_tu.astype(cfg.float_dtype) + 0.5
        dir_au = sampling.sample_heading(
            k_dir, cfg.num_directions, cfg.continuous_heading
        )

        zero = jnp.float32(0)
        return EnvState(
            wall_words=wall_words,
            hw=(h, w),
            goal_tu=first_goal,
            goal_words=goal_words,
            goal_tiles=goal_tiles,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zero,
            done=jnp.asarray(False),
            rng_key=next_key,
            t=jnp.int32(0),
            episode_return=zero,
            pending_reset=jnp.asarray(False),
        )

    def step_single(self, state: EnvState, action: jax.Array) -> EnvState:
        cfg: MultiGoalConfig = self.cfg
        moving, cand = self._move_candidate(state, action)
        r = cfg.player_radius_wu
        shape = (cfg.H, cfg.W)

        touched = collision.colliding_occupied_words(
            state.goal_words, shape, cand, r
        )
        touched = jnp.where(moving, touched, jnp.uint32(0))
        n_hit = jnp.sum(jax.lax.population_count(touched)).astype(jnp.int32)
        hit_goal = n_hit > 0
        hit_wall = moving & collision.is_player_colliding_packed(
            state.wall_words, shape, cand, r
        )

        dtype = state.pos_wu.dtype
        if cfg.collect_all:
            new_goal_words = state.goal_words & ~touched
            reward = n_hit.astype(dtype) * jnp.asarray(cfg.goal_reward, dtype)
            done = ~jnp.any(new_goal_words != 0)
            # keep the tile list in sync: rows whose bit was cleared become
            # disabled (-1, -1) slots (ignored by the box raycaster)
            gidx = state.goal_tiles[:, 0] * cfg.W + state.goal_tiles[:, 1]
            alive = state.goal_tiles[:, 0] >= 0
            row_touched = alive & bitmap.lookup_bit(
                touched, jnp.clip(gidx, 0, cfg.H * cfg.W - 1)
            )
            new_goal_tiles = jnp.where(
                row_touched[:, None], jnp.int32(-1), state.goal_tiles
            )
        else:
            new_goal_words = state.goal_words
            new_goal_tiles = state.goal_tiles
            reward = jnp.where(
                hit_goal, jnp.asarray(cfg.goal_reward, dtype),
                jnp.asarray(0, dtype),
            )
            done = hit_goal

        new_pos = jnp.where(moving & ~hit_goal & ~hit_wall, cand, state.pos_wu)
        new_dir = self._turned_dir(state, action, moving)

        return state.replace(
            pos_wu=new_pos,
            dir_au=new_dir,
            goal_words=new_goal_words,
            goal_tiles=new_goal_tiles,
            reward=reward,
            done=done,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    # Obstacle union for the raycaster: walls OR remaining goals.

    def _packed_maps(self, state: EnvState):
        return state.wall_words, state.wall_words | state.goal_words

    def _packed_maps_batch(self, state: EnvState):
        return state.wall_words, state.wall_words | state.goal_words

    # Column colors already fall through to the goal shades whenever the hit
    # tile isn't a wall, so the renderer needs no override.


def make(cfg: MultiGoalConfig | None = None, **kw) -> MultiGoalRoom:
    return MultiGoalRoom(cfg if cfg is not None else MultiGoalConfig(**kw))

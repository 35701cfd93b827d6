"""MultiPlayerRoom: P players in one walled room, shared goal.

No reference equivalent — the reference is strictly single-player
(/root/reference/src/single_room.jl:21-40 has one position/direction).
Batched multi-agent re-conception: the per-env state carries player
AXES (``pos_wu[P, 2]``, ``dir_au[P]``, ``reward[P]``) instead of per-player
structs, every per-player computation is a vectorized axis over the same
branch-free kernels the single-player families use, and the whole P-player
step remains one fused program per env batch.

Semantics (each a deliberate, documented choice):
* All players act SIMULTANEOUSLY: each player's move candidate is tested
  against walls, the goal, and the OTHER players' current positions
  (circle-circle at 2r), mirroring DynamicRoom's simultaneous block rule —
  a player may move into a tile another vacates only next step.  Candidates
  converging on the same point are resolved deterministically: the lower
  player index wins, the higher is blocked (so pairwise separation >= 2r is
  a step invariant when ``player_collision`` is on).
* Goal contact pays ``goal_reward`` to every scoring player, terminates the
  episode (``done`` is episode-level, scalar per env), and — the
  reference's goal-blocks-entry rule per player — does not move scorers.
* Each player's camera observation is rendered from their own pose;
  the OTHER players appear as occupying blocks at their current tiles
  (rendered in the block color pair and occluding like walls) — a
  tile-resolution approximation of sprite rendering, chosen because it
  reuses the gather-free point-obstacle cast/render paths unchanged.
* ``actions`` are int32[..., P]; observations gain a leading player axis
  per env; rewards are float32[..., P].

Train with independent/parameter-shared policies by folding the player
axis into the batch axis; the PPO learner in parallel/ppo.py is
single-agent and does this folding outside (see tests for the pattern).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import colors
from ..config import EnvConfig
from ..ops import bitmap, collision, lut, raycast, render, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class MultiPlayerConfig(EnvConfig):
    num_players: int = 2
    # Players block each other (circle-circle at 2*player_radius_wu).
    player_collision: bool = True
    # Other players are visible in camera/top/depth observations.
    players_visible: bool = True
    # How visible players render:
    #   "sprite" — billboard cylinder sprites at the players' ACTUAL
    #              positions: per-ray circle intersection (radius
    #              player_radius_wu), occlusion-tested against the wall/goal
    #              hit, floor-standing columns of sprite_height_wu world
    #              units, drawn in the pure-blue TILE_BLOCK palette color
    #              (the dim block pairs stay reserved for tile obstacles).
    #   "block"  — the round-3 tile-resolution approximation: the other
    #              players' tiles join the obstacle map and render/occlude
    #              like DynamicRoom blocks.
    player_render: str = "sprite"
    # Sprite cylinder height in world units (a wall is 1 wu tall).
    sprite_height_wu: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        interior = (self.height_tile_map_tu - 2) * (self.width_tile_map_tu - 2)
        if not (1 <= self.num_players < interior):
            raise ValueError(
                f"num_players must be in [1, {interior}) for this map size"
            )
        if self.player_render not in ("sprite", "block"):
            raise ValueError(
                f"unknown player_render: {self.player_render!r} "
                "(expected 'sprite' or 'block')"
            )
        if not (0.0 < self.sprite_height_wu <= self.camera_height_tile_wu * 4):
            raise ValueError("sprite_height_wu must be in (0, 4*camera_height]")

    @property
    def obs_shape(self):
        base = super().obs_shape
        return (self.num_players,) + base


class MultiPlayerRoom(Game):
    def __init__(self, cfg: MultiPlayerConfig):
        if not isinstance(cfg, MultiPlayerConfig):
            raise TypeError("MultiPlayerRoom requires a MultiPlayerConfig")
        super().__init__(cfg)

    @property
    def action_shape(self):
        return (self.cfg.num_players,)

    # -- reset ----------------------------------------------------------

    def reset_single(self, key: jax.Array) -> EnvState:
        cfg: MultiPlayerConfig = self.cfg
        h, w = cfg.H, cfg.W
        p = cfg.num_players
        next_key, k_goal, k_spawns, k_dirs = jax.random.split(key, 4)

        wall_words = jnp.asarray(cfg.border_wall_words)
        goal_tu = sampling.sample_interior_tile(k_goal, h, w)

        # P distinct spawn tiles (closed-form interior sampler, excluding
        # the goal and previously placed players), centered per tile.
        ranks = [sampling.interior_rank(goal_tu, w)]
        skeys = jax.random.split(k_spawns, p)
        tiles = []
        for i in range(p):
            t = sampling.sample_empty_interior_tile(
                skeys[i], h, w, jnp.stack(ranks)
            )
            ranks.append(sampling.interior_rank(t, w))
            tiles.append(t)
        spawn = jnp.stack(tiles).astype(jnp.int32)           # [P, 2]
        pos_wu = spawn.astype(cfg.float_dtype) + 0.5          # [P, 2]
        dkeys = jax.random.split(k_dirs, p)
        dir_au = jnp.stack([
            sampling.sample_heading(
                dkeys[i], cfg.num_directions, cfg.continuous_heading
            )
            for i in range(p)
        ])                                                    # [P]

        zerop = jnp.zeros((p,), jnp.float32)
        return EnvState(
            wall_words=wall_words,
            hw=(h, w),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zerop,
            done=jnp.asarray(False),
            rng_key=next_key,
            t=jnp.int32(0),
            episode_return=zerop,
            pending_reset=jnp.asarray(False),
        )

    # -- step ------------------------------------------------------------

    def step_single(self, state: EnvState, action: jax.Array) -> EnvState:
        """Simultaneous P-player step; ``action`` int32[P]."""
        cfg: MultiPlayerConfig = self.cfg
        dtype = state.pos_wu.dtype
        r = cfg.player_radius_wu
        shape = (cfg.H, cfg.W)

        if cfg.continuous_heading:
            ang = state.dir_au.astype(dtype) * (
                2.0 * jnp.pi / cfg.num_directions
            )
            dir_wu = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
        else:
            dir_wu = lut.take_rows(
                jnp.asarray(cfg.directions_wu, dtype), state.dir_au
            )                                                  # [P, 2]
        moving = action < 2                                    # [P]
        sign = jnp.where(action == 0, 1.0, -1.0).astype(dtype)
        cand = state.pos_wu + (
            sign[:, None] * jnp.asarray(cfg.position_increment_wu, dtype)
            * dir_wu
        )                                                      # [P, 2]

        hit_goal = moving & jax.vmap(
            lambda c: collision.is_colliding_with_goal(c, state.goal_tu, r)
        )(cand)
        hit_wall = moving & jax.vmap(
            lambda c: collision.is_player_colliding_packed(
                state.wall_words, shape, c, r
            )
        )(cand)

        if cfg.player_collision:
            # Simultaneous-move collision, two tests:
            # 1. candidate vs the OTHERS' CURRENT circles — a player may
            #    move into space another vacates only next step;
            # 2. candidate vs LOWER-INDEX movers' candidates — two players
            #    converging on the same point would otherwise both pass and
            #    interpenetrate; the deterministic tie-break is that the
            #    lower player index wins (moves) and the higher is blocked.
            # Together (with spawns on distinct tiles) these keep pairwise
            # distance >= 2r invariantly: moved-vs-held pairs are covered by
            # test 1, moved-vs-moved pairs by test 2.
            p = cfg.num_players
            off_diag = ~jnp.eye(p, dtype=bool)
            thresh = jnp.asarray((2.0 * r) ** 2, dtype)
            d2 = jnp.sum(
                (cand[:, None, :] - state.pos_wu[None, :, :]) ** 2, axis=-1
            )                                                  # [P, P]
            hit_player = moving & jnp.any(off_diag & (d2 < thresh), axis=1)
            # Lower-index movers that pass test 1 (and walls/goal) block
            # higher-index candidates that land within 2r of THEIR candidate.
            base_ok = moving & ~hit_goal & ~hit_wall & ~hit_player
            c2 = jnp.sum(
                (cand[:, None, :] - cand[None, :, :]) ** 2, axis=-1
            )                                                  # [P, P]
            lower = (
                jnp.arange(p)[None, :] < jnp.arange(p)[:, None]
            )                                                  # [P, P] j < i
            hit_cand = jnp.any(
                lower & base_ok[None, :] & (c2 < thresh), axis=1
            )
            hit_player = hit_player | (moving & hit_cand)
        else:
            hit_player = jnp.zeros_like(moving)

        reward = jnp.where(
            hit_goal, jnp.asarray(cfg.goal_reward, jnp.float32), 0.0
        )
        done = jnp.any(hit_goal)
        ok = moving & ~hit_goal & ~hit_wall & ~hit_player
        new_pos = jnp.where(ok[:, None], cand, state.pos_wu)

        turn = jnp.where(action == 2, 1, jnp.where(action == 3, -1, 0))
        if cfg.continuous_heading:
            inc = jnp.asarray(cfg.turn_increment_au, state.dir_au.dtype)
            dstep = jnp.where(moving, 0.0, turn * inc)
        else:
            dstep = jnp.where(moving, 0, turn)
        new_dir = jnp.mod(state.dir_au + dstep, cfg.num_directions)

        return state.replace(
            pos_wu=new_pos,
            dir_au=new_dir,
            reward=reward,
            done=done,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    # -- observation ------------------------------------------------------

    def _others_tiles(self, state: EnvState) -> jax.Array:
        """int32[P, P, 2]: for player p, all players' tiles with row p
        disabled (-1) — the point obstacles p sees."""
        tiles = jnp.floor(state.pos_wu).astype(jnp.int32)      # [P, 2]
        p = self.cfg.num_players
        self_mask = jnp.eye(p, dtype=bool)[:, :, None]          # [P, P, 1]
        return jnp.where(self_mask, jnp.int32(-1), tiles[None, :, :])

    @property
    def _sprite_mode(self) -> bool:
        cfg: MultiPlayerConfig = self.cfg
        return cfg.players_visible and cfg.player_render == "sprite"

    def _obstacles_for(self, state: EnvState, others: jax.Array):
        """(obstacle_words, block_words) for one player.  Block mode: walls |
        goal | other players' tiles, with the tiles doubling as the block
        render layer.  Sprite mode (default): walls | goal only — the other
        players are drawn as billboard sprites AFTER the cast, not as map
        obstacles."""
        cfg = self.cfg
        nw = state.wall_words.shape[-1]
        _, base = self._packed_maps(state)  # walls | goal
        if not cfg.players_visible or self._sprite_mode:
            return base, None
        blocks = bitmap.tiles_to_words(others, (cfg.H, cfg.W), nw)
        return base | blocks, blocks


    def _player_pose_dirs(self, pos, dir_au):
        """(player_dir, ray_dirs-or-None) for ONE player's pose — the
        continuous-heading-aware twin of Game._player_dir/_ray_dirs (which
        read the whole-state scalar pose and don't apply per player)."""
        cfg = self.cfg
        if cfg.continuous_heading:
            ang = dir_au.astype(pos.dtype) * (
                2.0 * jnp.pi / cfg.num_directions
            )
            pdir = jnp.stack([jnp.cos(ang), jnp.sin(ang)])
            return pdir, raycast.ray_fan(cfg, pdir)
        return lut.take_rows(
            jnp.asarray(cfg.directions_wu, pos.dtype), dir_au
        ), None

    def _shared_obstacles(self, state: EnvState):
        """(obstacle_words, block_words) when they DON'T depend on the
        viewing player — sprite mode and invisible mode (walls | goal only).
        Hoisted out of the per-player vmap so the packed-map build runs
        once per env instead of P times; block mode returns None (its
        obstacle union includes the per-player others' tiles)."""
        if self._sprite_mode or not self.cfg.players_visible:
            _, base = self._packed_maps(state)
            return base, None
        return None

    def _cast_player(
        self, state: EnvState, pos, dir_au, others, others_mask, shared=None
    ):
        """(pdir, hits, t_sprite-or-None, block_words) for ONE player."""
        cfg: MultiPlayerConfig = self.cfg
        if shared is not None:
            obstacle_words, block_words = shared
        else:
            obstacle_words, block_words = self._obstacles_for(state, others)
        pdir, dirs = self._player_pose_dirs(pos, dir_au)
        hits = raycast.cast_rays(
            cfg, obstacle_words, pos, dir_au, ray_dirs=dirs
        )
        t_s = None
        if self._sprite_mode:
            t_s = render.ray_circle_t(
                pos, hits.ray_dirs, state.pos_wu, others_mask,
                cfg.float_dtype(cfg.player_radius_wu ** 2),
            )
        return pdir, hits, t_s, block_words

    def _observe_player(
        self, state: EnvState, pos, dir_au, others, others_mask, shared=None
    ) -> jax.Array:
        """One player's observation (vmapped over the player axis)."""
        cfg: MultiPlayerConfig = self.cfg
        pdir, hits, t_s, block_words = self._cast_player(
            state, pos, dir_au, others, others_mask, shared
        )
        if cfg.obs_type == "depth":
            h = hits if t_s is None else hits._replace(
                dist_wu=jnp.minimum(hits.dist_wu, t_s)
            )
            return jnp.flip(render.projected_depth(pdir, h), axis=0)
        if cfg.obs_type == "tile_grid":
            # tile-resolution by nature: visible players mark their tiles
            # regardless of the camera render mode
            blocks = None
            if cfg.players_visible:
                blocks = bitmap.tiles_to_words(
                    others, (cfg.H, cfg.W), state.wall_words.shape[-1]
                )
            return render.render_observation(
                cfg, state.wall_words, state.goal_tu, pdir, hits,
                block_words=blocks, pos_wu=pos,
            )
        if cfg.obs_type == "camera_pal8":
            img = render.render_camera_pal8(
                cfg, state.wall_words, pdir, hits, block_words=block_words,
                pos_wu=pos,
            )
            if t_s is not None:
                img = render.sprite_overlay(
                    cfg, img, pdir, hits, t_s,
                    jnp.uint8(colors.PAL_BLOCK), cfg.sprite_height_wu,
                )
            return img
        img = self._camera_u32_player(state, pdir, hits, t_s, block_words, pos)
        if cfg.obs_type == "camera_u32":
            return img
        if cfg.obs_type == "camera_rgb":
            return render.u32_to_rgb(img)
        if cfg.obs_type == "camera_gray":
            return render.u32_to_gray(img)
        if cfg.obs_type == "camera_gray_u8":
            return render.u32_to_gray_u8(img)
        raise AssertionError(cfg.obs_type)

    def _camera_u32_player(self, state, pdir, hits, t_s, block_words, pos):
        cfg: MultiPlayerConfig = self.cfg
        img = render.render_camera_u32(
            cfg, state.wall_words, pdir, hits,
            block_words=block_words, pos_wu=pos,
        )
        if t_s is not None:
            img = render.sprite_overlay(
                cfg, img, pdir, hits, t_s,
                jnp.uint32(colors.TILE_BLOCK), cfg.sprite_height_wu,
            )
        return img

    def _others_mask(self) -> jax.Array:
        return ~jnp.eye(self.cfg.num_players, dtype=bool)  # [P, P]

    def observe_single(self, state: EnvState) -> jax.Array:
        cfg: MultiPlayerConfig = self.cfg
        if cfg.obs_type in ("top_u32", "top_rgb"):
            img = self.top_view_single(state)
            one = (
                render.u32_to_rgb(img) if cfg.obs_type == "top_rgb" else img
            )
            # top view is whole-world: identical for every player
            return jnp.broadcast_to(
                one[None], (cfg.num_players,) + one.shape
            )
        others = self._others_tiles(state)
        shared = self._shared_obstacles(state)

        def one(pos, d, oth, mask):
            return self._observe_player(state, pos, d, oth, mask, shared)

        return jax.vmap(one)(
            state.pos_wu, state.dir_au, others, self._others_mask()
        )

    def observe_batch(self, state: EnvState) -> jax.Array:
        return jax.vmap(self.observe_single)(state)

    def camera_view_single(self, state: EnvState) -> jax.Array:
        """uint32[P, H_pu, R] camera views (one per player)."""
        others = self._others_tiles(state)
        shared = self._shared_obstacles(state)

        def one(pos, d, oth, mask):
            pdir, hits, t_s, block_words = self._cast_player(
                state, pos, d, oth, mask, shared
            )
            return self._camera_u32_player(
                state, pdir, hits, t_s, block_words, pos
            )

        return jax.vmap(one)(
            state.pos_wu, state.dir_au, others, self._others_mask()
        )

    def top_view_single(self, state: EnvState) -> jax.Array:
        """One whole-world top view: player 0's rays/circle; the other
        players as filled circles at their actual positions (sprite mode)
        or as blue tiles (block mode)."""
        from ..ops import topview
        from ..ops.units import wu_to_pu

        cfg = self.cfg
        others0 = self._others_tiles(state)[0]
        obstacle_words, block_words = self._obstacles_for(state, others0)
        pos0 = state.pos_wu[0]
        dir0 = state.dir_au[0]
        _, dirs0 = self._player_pose_dirs(pos0, dir0)
        hits = raycast.cast_rays(cfg, obstacle_words, pos0, dir0, ray_dirs=dirs0)
        others_pu = None
        if self._sprite_mode and cfg.num_players > 1:
            others_pu = wu_to_pu(state.pos_wu[1:], cfg.pu_per_tu)  # i32[P-1, 2]
        return topview.render_top_view(
            cfg,
            state.wall_map,
            state.goal_tu,
            pos0,
            cfg.player_radius_pu,
            hits,
            block_map=(
                None
                if block_words is None
                else bitmap.unpack_bits(block_words, (cfg.H, cfg.W))
            ),
            others_pu=others_pu,
        )


def make(cfg: MultiPlayerConfig | None = None, **kw) -> MultiPlayerRoom:
    return MultiPlayerRoom(cfg if cfg is not None else MultiPlayerConfig(**kw))

"""Game base class: shared step / observe logic for all world families.

The reference declares ``AbstractGame`` plus generic-function stubs
(/root/reference/src/RayCastWorlds.jl:5-14) and implements them per game.
Here a ``Game`` is a *stateless* object carrying only the static ``EnvConfig``;
all dynamics are pure functions of ``(EnvState, action)`` so they jit/vmap/
shard freely.  Subclasses provide ``reset_single`` (map + goal + spawn
generation — the only part that differs between world families).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import (
    EnvConfig,
    MOVE_FORWARD,
    TURN_LEFT,
    TURN_RIGHT,
)
from ..ops import bitmap, collision, lut, raycast, render
from ..state import EnvState


class Game:
    """Base game over the generic grid-world dynamics."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg

    # -- per-family -----------------------------------------------------

    def reset_single(self, key: jax.Array) -> EnvState:
        raise NotImplementedError

    # -- heading --------------------------------------------------------
    # Discrete headings (the reference's angle units) read the precomputed
    # direction / ray-fan LUTs; continuous headings (cfg.continuous_heading)
    # compute both live from the float heading.

    def _player_dir(self, state: EnvState) -> jax.Array:
        cfg = self.cfg
        dtype = state.pos_wu.dtype
        if cfg.continuous_heading:
            ang = state.dir_au.astype(dtype) * (
                2.0 * jnp.pi / cfg.num_directions
            )
            return jnp.stack([jnp.cos(ang), jnp.sin(ang)])
        return lut.take_rows(
            jnp.asarray(cfg.directions_wu, dtype), state.dir_au
        )

    def _ray_dirs(self, state: EnvState) -> jax.Array:
        cfg = self.cfg
        if cfg.continuous_heading:
            return raycast.ray_fan(cfg, self._player_dir(state))
        return lut.take_rows(jnp.asarray(cfg.ray_fan_lut), state.dir_au)

    # -- shared dynamics ------------------------------------------------

    def step_single(self, state: EnvState, action: jax.Array) -> EnvState:
        """One action on one env; branch-free translation of ``act!``
        (/root/reference/src/single_room.jl:139-191):

        * actions 0/1 translate along the heading LUT vector; the candidate
          position is collision-tested against the goal and the walls
          separately (:162-163); a goal hit pays ``goal_reward`` and
          terminates **without moving** (:166-168); a wall hit blocks
          (:169-172); otherwise the move commits (:173-177).
        * actions 2/3 turn by +/-1 angle unit, modular (:179-187).
        * ``done``/``reward`` are re-derived every step (not sticky), as in
          the reference.
        """
        cfg = self.cfg
        dtype = state.pos_wu.dtype
        moving, cand = self._move_candidate(state, action)

        r = cfg.player_radius_wu
        hit_goal = moving & collision.is_colliding_with_goal(
            cand, state.goal_tu, r
        )
        hit_wall = moving & collision.is_player_colliding_packed(
            state.wall_words, (cfg.H, cfg.W), cand, r
        )

        reward = jnp.where(
            hit_goal, jnp.asarray(cfg.goal_reward, dtype), jnp.asarray(0, dtype)
        )
        done = hit_goal
        new_pos = jnp.where(moving & ~hit_goal & ~hit_wall, cand, state.pos_wu)
        new_dir = self._turned_dir(state, action, moving)

        return state.replace(
            pos_wu=new_pos,
            dir_au=new_dir,
            reward=reward,
            done=done,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    # Shared pieces of the step, reused by family overrides (multi-goal,
    # moving obstacles) so the translate/turn semantics stay identical.

    def _move_candidate(self, state: EnvState, action: jax.Array):
        """(moving bool, candidate position f32[2]) for one action
        (ref :153-160)."""
        cfg = self.cfg
        dtype = state.pos_wu.dtype
        dir_wu = self._player_dir(state)
        moving = action < 2
        sign = jnp.where(action == MOVE_FORWARD, 1.0, -1.0).astype(dtype)
        cand = state.pos_wu + sign * jnp.asarray(
            cfg.position_increment_wu, dtype
        ) * dir_wu
        return moving, cand

    def _turned_dir(self, state: EnvState, action: jax.Array, moving):
        """New heading after a turn action (ref :179-187); continuous
        headings turn by ``turn_increment_au`` float angle units."""
        cfg = self.cfg
        turn = jnp.where(
            action == TURN_LEFT, 1, jnp.where(action == TURN_RIGHT, -1, 0)
        )
        if cfg.continuous_heading:
            inc = jnp.asarray(cfg.turn_increment_au, state.dir_au.dtype)
            step = jnp.where(moving, 0.0, turn * inc)
        else:
            step = jnp.where(moving, 0, turn)
        return jnp.mod(state.dir_au + step, cfg.num_directions)

    def _packed_maps(self, state: EnvState):
        """(wall_words, obstacle_words): the obstacle map is the union of all
        object channels (ref :209) — walls plus the goal bit, OR-ed in
        arithmetically (no scatter)."""
        cfg = self.cfg
        wall_words = state.wall_words
        gidx = state.goal_tu[0] * cfg.W + state.goal_tu[1]
        nw = wall_words.shape[-1]
        goal_vec = jnp.where(
            jnp.arange(nw, dtype=jnp.int32) == (gidx >> 5),
            jnp.uint32(1) << (gidx & 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
        return wall_words, wall_words | goal_vec

    # Games whose maps are exactly border-ring + K unit boxes (SingleRoom,
    # MultiGoalRoom, DynamicRoom) can use the closed-form raycaster:
    # _analytic_boxes returns the int32[K, 2] box tiles (rows of (-1, -1)
    # are disabled slots that can never beat the border).
    supports_analytic_raycast: bool = False

    def _analytic_boxes(self, state: EnvState):
        return state.goal_tu[None, :]

    def _use_analytic(self) -> bool:
        return (
            self.supports_analytic_raycast
            and self.cfg.raycast_backend == "analytic"
        )

    def cast_single(self, state: EnvState) -> raycast.RayHits:
        """Ray-cast the current pose (``cast_rays!``, ref :195-231)."""
        if self._use_analytic():
            from ..ops import raycast_analytic

            return raycast_analytic.cast_rays_boxes(
                self.cfg, self._analytic_boxes(state), state.pos_wu,
                state.dir_au,
            )
        _, obstacle_words = self._packed_maps(state)
        return raycast.cast_rays(
            self.cfg, obstacle_words, state.pos_wu, state.dir_au,
            ray_dirs=self._ray_dirs(state) if self.cfg.continuous_heading
            else None,
        )

    def _block_words(self, state: EnvState):
        """Packed words of dynamic obstacle tiles, or None (DynamicRoom
        overrides; rendered in their own color pair)."""
        return None

    def _block_words_batch(self, state: EnvState):
        """Batched ``_block_words`` (u32[B, NW] or None)."""
        return None

    def observe_from_hits_single(
        self, state: EnvState, hits: raycast.RayHits
    ) -> jax.Array:
        cfg = self.cfg
        player_dir = self._player_dir(state)
        return render.render_observation(
            cfg, state.wall_words, state.goal_tu, player_dir, hits,
            block_words=self._block_words(state),
            goal_words=state.goal_words,
            pos_wu=state.pos_wu,
        )

    def observe_single(self, state: EnvState) -> jax.Array:
        cfg = self.cfg
        if cfg.obs_type in ("top_u32", "top_rgb"):
            img = self.top_view_single(state)
            return render.u32_to_rgb(img) if cfg.obs_type == "top_rgb" else img
        return self.observe_from_hits_single(state, self.cast_single(state))

    # -- batch-level entry points (Env uses these) -----------------------

    def _packed_maps_batch(self, state: EnvState):
        cfg = self.cfg
        wall_words = state.wall_words
        gidx = state.goal_tu[:, 0] * cfg.W + state.goal_tu[:, 1]
        nw = wall_words.shape[-1]
        goal_vec = jnp.where(
            jnp.arange(nw, dtype=jnp.int32)[None, :] == (gidx[:, None] >> 5),
            jnp.uint32(1) << (gidx[:, None] & 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
        return wall_words, wall_words | goal_vec

    def cast_batch(self, state: EnvState) -> raycast.RayHits:
        cfg = self.cfg
        if cfg.raycast_backend != "scan_flat":
            return jax.vmap(self.cast_single)(state)
        # flattened [B*R]-lane DDA; bit-identical to the vmapped scan.
        _, obstacle_words = self._packed_maps_batch(state)
        dirs = lut.take_rows(jnp.asarray(cfg.ray_fan_lut), state.dir_au)  # [B, R, 2]
        hit_tu, hit_dim, dist = raycast.cast_rays_scan_flat(
            obstacle_words, (cfg.H, cfg.W), state.pos_wu, dirs,
            cfg.dda_steps, unroll=cfg.dda_unroll,
        )
        return raycast.RayHits(
            ray_dirs=dirs, hit_tu=hit_tu, hit_dim=hit_dim, dist_wu=dist
        )

    def observe_batch(self, state: EnvState) -> jax.Array:
        cfg = self.cfg
        if cfg.obs_type in ("top_u32", "top_rgb"):
            return jax.vmap(self.observe_single)(state)
        hits = self.cast_batch(state)
        return jax.vmap(self.observe_from_hits_single)(state, hits)

    def top_view_single(self, state: EnvState) -> jax.Array:
        """uint32 top view (ref ``update_top_view!``, single_room.jl:446-483)."""
        from ..ops import topview

        cfg = self.cfg
        hits = self.cast_single(state)
        block_words = self._block_words(state)
        return topview.render_top_view(
            cfg,
            state.wall_map,
            state.goal_tu,
            state.pos_wu,
            cfg.player_radius_pu,
            hits,
            goal_map=(
                None
                if state.goal_words is None
                else bitmap.unpack_bits(state.goal_words, (cfg.H, cfg.W))
            ),
            block_map=(
                None
                if block_words is None
                else bitmap.unpack_bits(block_words, (cfg.H, cfg.W))
            ),
        )

    def camera_view_single(self, state: EnvState) -> jax.Array:
        """uint32 camera view regardless of obs_type (ref
        ``update_camera_view!``, single_room.jl:374-444)."""
        cfg = self.cfg
        hits = self.cast_single(state)
        player_dir = self._player_dir(state)
        return render.render_camera_u32(
            cfg, state.wall_words, player_dir, hits,
            block_words=self._block_words(state),
            pos_wu=state.pos_wu,
        )

    # -- conveniences ---------------------------------------------------

    @property
    def num_actions(self) -> int:
        return 4

    # Trailing per-env action shape: () for single-player families, (P,)
    # for MultiPlayerRoom (Env.sample_action and drivers consume this).
    action_shape: tuple = ()

    def action_names(self):
        from ..config import ACTION_NAMES

        return ACTION_NAMES

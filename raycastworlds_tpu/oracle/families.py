"""Scalar NumPy oracles for the extended world families and wall textures.

Same philosophy as oracle/single_room.py: independent, deliberately naive
reimplementations (mutable state, Python branches, per-ray loops, per-pixel
render loops) of the semantics the JAX build computes branch-free and
batched.  Agreement on fixed-seed trajectories is the parity evidence for
everything the reference never had: multi-goal collection (models/multi_goal.py),
moving obstacle blocks (models/dynamic_room.py), and procedural wall textures
(ops/render.py:_texture_wall).

Only the PRNG draws share infrastructure (jax.random on CPU with the same
key-split order as the JAX resets — threefry is backend-deterministic, which
is what makes parity bit-exact); all game logic here is NumPy.

For families whose reset runs a procedural generator (Maze, RandomRoom), the
oracle does not re-derive the generator: construct via ``from_map`` with the
generated map and the parity test covers dynamics + rendering on arbitrary
maps (generator invariants are tested separately in tests/test_worlds.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .. import colors
from ..config import EnvConfig
from .single_room import OracleSingleRoom, wu_to_tu

_CARDINAL = ((-1, 0), (1, 0), (0, -1), (0, 1))  # models/dynamic_room.py:34


class OracleWorld(OracleSingleRoom):
    """OracleSingleRoom generalized to arbitrary wall maps, K goals, moving
    blocks, and textured walls.  Subclasses/constructors fill the extras."""

    def __init__(self, cfg: EnvConfig):
        super().__init__(cfg)
        self.goal_tiles: List[Tuple[int, int]] = []  # alive goals (multi)
        self.blocks: List[List[int]] = []            # [i, j, dir] rows

    # -- construction from a generated state (Maze / RandomRoom) ---------

    @classmethod
    def from_map(
        cls, cfg: EnvConfig, wall_map, goal_tu, pos_wu, dir_au
    ) -> "OracleWorld":
        o = cls(cfg)
        o.wall_map = np.array(wall_map, dtype=bool)
        o.goal_tu = (int(goal_tu[0]), int(goal_tu[1]))
        o.pos_wu = np.array(pos_wu, np.float32)
        o.dir_au = int(dir_au)
        return o

    # -- shared helpers ---------------------------------------------------

    def _draw_empty(self, key, occupied: np.ndarray) -> Tuple[int, int]:
        """cumsum-inversion draw, mirroring ops/sampling.sample_empty_tile."""
        import jax

        empty = (~occupied.reshape(-1)).astype(np.int32)
        c = np.cumsum(empty)
        n = int(c[-1])
        u = np.float32(np.asarray(jax.random.uniform(key, (), dtype='float32')))
        kk = int(np.floor(u * np.float32(n)))
        kk = min(max(kk, 0), max(n - 1, 0))
        idx = int(np.argmax(c > kk))
        return idx // occupied.shape[1], idx % occupied.shape[1]

    def _circle_hits_tile(self, pos: np.ndarray, ti: int, tj: int) -> bool:
        r = np.float32(self.cfg.player_radius_wu)
        cx = np.float32(ti + 0.5)
        cy = np.float32(tj + 0.5)
        rx = np.float32(pos[0] - cx)
        ry = np.float32(pos[1] - cy)
        px = min(max(rx, np.float32(-0.5)), np.float32(0.5))
        py = min(max(ry, np.float32(-0.5)), np.float32(0.5))
        return float((rx - px) ** 2 + (ry - py) ** 2) < float(r * r)

    def _block_map(self) -> np.ndarray:
        m = np.zeros_like(self.wall_map)
        for b in self.blocks:
            m[b[0], b[1]] = True
        return m

    def _solid_map(self) -> np.ndarray:
        """Tiles that block player movement (walls + blocks)."""
        return self.wall_map | self._block_map()

    def _obstacle_map(self) -> np.ndarray:
        """Raycaster union: walls OR goal(s) OR blocks (models/base.py
        _packed_maps + family overrides)."""
        m = self.wall_map.copy()
        if self.goal_tiles:
            for g in self.goal_tiles:
                m[g] = True
        else:
            m[self.goal_tu] = True
        return m | self._block_map()

    def cast_rays(self):
        cfg = self.cfg
        obstacle = self._obstacle_map()
        dirs = self.ray_fan()
        hit_tu = np.zeros((cfg.num_rays, 2), np.int32)
        hit_dim = np.zeros(cfg.num_rays, np.int32)
        dist = np.zeros(cfg.num_rays, np.float32)
        for i in range(cfg.num_rays):
            a, b, c, d = self.cast_one(
                obstacle, self.pos_wu[0], self.pos_wu[1], dirs[i, 0], dirs[i, 1]
            )
            hit_tu[i] = (a, b)
            hit_dim[i] = c
            dist[i] = d
        return dirs, hit_tu, hit_dim, dist

    # -- camera view with block colors + procedural textures --------------

    def _column_color(self, hit_i: int, hit_j: int, dim: int) -> int:
        """Wall > block > goal precedence (ops/render.py column_colors_u32:
        block overrides the goal fall-through only when not a wall)."""
        h, w = self.wall_map.shape
        ci = min(max(hit_i, 0), h - 1)
        cj = min(max(hit_j, 0), w - 1)
        if self.wall_map[ci, cj]:
            return colors.WALL_DIM_I if dim == 0 else colors.WALL_DIM_J
        if self.blocks and self._block_map()[ci, cj]:
            return colors.BLOCK_DIM_I if dim == 0 else colors.BLOCK_DIM_J
        return colors.GOAL_DIM_I if dim == 0 else colors.GOAL_DIM_J

    def camera_view(self) -> np.ndarray:
        cfg = self.cfg
        hpu = cfg.height_camera_view_pu
        r = cfg.num_rays
        img = np.zeros((hpu, r), np.uint32)
        dirs, hit_tu, hit_dim, dist = self.cast_rays()
        pd = self.player_dir()
        num = np.float32(cfg.camera_height_tile_wu * r)
        denom_c = np.float32(2.0 * cfg.semi_field_of_view_wu)
        for i in range(r):
            proj = np.float32(dist[i] * (pd[0] * dirs[i, 0] + pd[1] * dirs[i, 1]))
            with np.errstate(divide="ignore", over="ignore"):
                height_line = np.float32(num / np.float32(denom_c * proj))
            if np.isfinite(height_line):
                h_pu = int(math.floor(min(float(height_line), float(hpu))))
            else:
                h_pu = hpu
            color = self._column_color(hit_tu[i, 0], hit_tu[i, 1], hit_dim[i])
            k = r - 1 - i  # mirrored column (ref :431)
            if h_pu >= hpu - 1:
                lo, hi = 0, hpu
            else:
                pad = (hpu - h_pu) // 2
                img[:pad, k] = colors.CEILING
                img[hpu - pad :, k] = colors.FLOOR
                lo, hi = pad, hpu - pad
            if cfg.wall_texture == "none":
                img[lo:hi, k] = color
            else:
                self._texture_column(
                    img, k, lo, hi, color, height_line,
                    dirs[i], hit_tu[i], hit_dim[i], dist[i],
                )
        return img

    def _texture_column(
        self, img, k, lo, hi, color, height_line, ray, hit, dim, dist
    ) -> None:
        """Scalar mirror of ops/render.py:_texture_wall (same float32 ops)."""
        cfg = self.cfg
        t = cfg.texture_cells
        hpu = cfg.height_camera_view_pu

        take_j = dim == 0  # hit face perpendicular to i => cross axis j
        dir_cross = np.float32(ray[1] if take_j else ray[0])
        pos_cross = np.float32(self.pos_wu[1] if take_j else self.pos_wu[0])
        tile_cross = np.float32(hit[1] if take_j else hit[0])
        cross = np.float32(pos_cross + np.float32(dist) * dir_cross)
        frac_u = min(max(np.float32(cross - tile_cross), np.float32(0.0)),
                     np.float32(1.0 - 1e-6))
        ui = min(max(int(np.float32(frac_u * t)), 0), t - 1)

        # Integer column height / texel row, exactly as ops/render.py
        # _texture_wall: vi = floor(t*(2*row - hpu + h)/(2*h)) with
        # h = floor(min(height_line, cap)), cap scaled down for large t so
        # t * 2 * cap never overflows int32.
        cap = min(1 << 20, (1 << 30) // (2 * t))
        if np.isfinite(height_line):
            h_full = int(math.floor(min(float(height_line), float(cap))))
        else:
            h_full = cap
        h_full = max(h_full, 1)
        for row in range(lo, hi):
            vi = min(max((t * (2 * row - hpu + h_full)) // (2 * h_full), 0),
                     t - 1)
            if cfg.wall_texture == "checker":
                factor = np.float32(1.0 if ((ui + vi) & 1) == 0 else 0.55)
            elif cfg.wall_texture == "brick":
                course_h = max(t // 4, 1)
                brick_w = max(t // 2, 2)
                course = vi // course_h
                off = brick_w // 2 if (course & 1) == 1 else 0
                mortar = (vi % course_h == 0) or (((ui + off) % brick_w) == 0)
                factor = np.float32(0.45 if mortar else 1.0)
            else:  # "xor"
                g = np.float32(ui ^ vi) / np.float32(max(t - 1, 1))
                factor = np.float32(0.4 + 0.6 * float(g))
            rr = np.uint32(np.float32((color >> 16) & 0xFF) * factor)
            gg = np.uint32(np.float32((color >> 8) & 0xFF) * factor)
            bb = np.uint32(np.float32(color & 0xFF) * factor)
            img[row, k] = (rr << np.uint32(16)) | (gg << np.uint32(8)) | bb


class OracleMultiGoal(OracleWorld):
    """Mirror of models/multi_goal.py (K goals, collect-all or first-hit)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_goals = cfg.num_goals
        self.collect_all = cfg.collect_all

    def reset(self, key) -> None:
        """Draw order: split(key, 4) -> (next, k_goals, k_spawn, k_dir);
        K sequential empty-tile draws without replacement
        (models/multi_goal.py:62-86)."""
        import jax

        cfg = self.cfg
        next_key, k_goals, k_spawn, k_dir = jax.random.split(key, 4)
        occupied = self.wall_map.copy()
        gkeys = jax.random.split(k_goals, self.num_goals)
        self.goal_tiles = []
        for k in range(self.num_goals):
            g = self._draw_empty(gkeys[k], occupied)
            occupied[g] = True
            self.goal_tiles.append(g)
        self.goal_tu = self.goal_tiles[0]
        s = self._draw_empty(k_spawn, occupied)
        self.pos_wu = np.array([s[0] + 0.5, s[1] + 0.5], np.float32)
        self.dir_au = int(np.asarray(jax.random.randint(
            k_dir, (), 0, cfg.num_directions, dtype=np.int32)))
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        self.rng_key = next_key

    def step(self, action: int) -> None:
        cfg = self.cfg
        assert 0 <= action < 4
        if action < 2:
            d = self.directions_wu[self.dir_au]
            inc = np.float32(cfg.position_increment_wu)
            sign = np.float32(1.0 if action == 0 else -1.0)
            cand = (self.pos_wu + sign * inc * d).astype(np.float32)
            touched = [
                g for g in self.goal_tiles
                if self._circle_hits_tile(cand, g[0], g[1])
            ]
            hit_wall = self._is_colliding(self.wall_map, cand)
            n_hit = len(touched)
            if self.collect_all:
                for g in touched:
                    self.goal_tiles.remove(g)
                self.reward = np.float32(n_hit * cfg.goal_reward)
                self.done = len(self.goal_tiles) == 0
            else:
                self.reward = np.float32(cfg.goal_reward if n_hit else 0)
                self.done = n_hit > 0
            if n_hit == 0 and not hit_wall:
                self.pos_wu = cand
        else:
            if action == 2:
                self.dir_au = (self.dir_au + 1) % cfg.num_directions
            else:
                self.dir_au = (self.dir_au - 1) % cfg.num_directions
            self.reward = np.float32(0)
            self.done = len(self.goal_tiles) == 0 if self.collect_all else False
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)


class OracleContinuous(OracleWorld):
    """Scalar mirror of the continuous-heading mode
    (EnvConfig.continuous_heading, models/base.py): float heading in
    [0, num_directions), fractional turns by ``turn_increment_au``, heading
    vector and ray fan computed LIVE instead of via the per-heading LUTs.

    Precision contract: the heading transcendentals (cos/sin) are evaluated
    through the same XLA CPU scalar kernels as the env — the exact analog of
    the discrete oracles sharing ``directions_wu``/``ray_fan_lut`` (libm vs
    XLA can differ in the last ulp, which would break exact equality for no
    informative reason).  Everything downstream — the fan lerp+normalize,
    movement, collision, DDA, render — is independent NumPy float32.
    """

    def _draw_heading(self, k_dir) -> None:
        import jax

        self.dir_au = np.float32(np.asarray(jax.random.uniform(
            k_dir, (), dtype="float32",
            maxval=float(self.cfg.num_directions),
        )))

    def reset(self, key) -> None:
        # Same draw order as OracleSingleRoom.reset; only the heading draw
        # differs (uniform float32 instead of randint —
        # ops/sampling.sample_heading continuous branch).
        import jax

        cfg = self.cfg
        next_key, k_goal, k_spawn, k_dir = jax.random.split(key, 4)
        gi, gj = np.asarray(jax.random.randint(
            k_goal, (2,), np.array([1, 1]),
            np.array([cfg.H - 1, cfg.W - 1]), dtype=np.int32))
        self.goal_tu = (int(gi), int(gj))
        occupied = self.wall_map.copy()
        occupied[self.goal_tu] = True
        s = self._draw_empty(k_spawn, occupied)
        self.pos_wu = np.array([s[0] + 0.5, s[1] + 0.5], np.float32)
        self._draw_heading(k_dir)
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        self.rng_key = next_key

    def player_dir(self) -> np.ndarray:
        import jax.numpy as jnp

        ang = np.float32(self.dir_au) * np.float32(
            2.0 * np.pi / self.cfg.num_directions
        )
        # shared XLA transcendentals (see class docstring)
        return np.array(
            [np.asarray(jnp.cos(jnp.float32(ang))),
             np.asarray(jnp.sin(jnp.float32(ang)))], np.float32,
        )

    def ray_fan(self) -> np.ndarray:
        """NumPy float32 mirror of ops/raycast.ray_fan (the live formula):
        lerp across the camera plane, then normalize."""
        cfg = self.cfg
        d = self.player_dir()
        cam = np.array([d[1], -d[0]], np.float32)
        s = np.float32(cfg.semi_field_of_view_wu)
        first = (d + s * cam).astype(np.float32)
        last = (d - s * cam).astype(np.float32)
        r = cfg.num_rays
        t = (np.arange(r, dtype=np.float32) / np.float32(r - 1))[:, None]
        un = (first[None, :] + t * (last - first)[None, :]).astype(np.float32)
        norm = np.sqrt(np.sum(un * un, axis=-1, keepdims=True)).astype(
            np.float32
        )
        return (un / norm).astype(np.float32)

    def step(self, action: int) -> None:
        cfg = self.cfg
        assert 0 <= action < 4
        if action < 2:
            d = self.player_dir()
            inc = np.float32(cfg.position_increment_wu)
            sign = np.float32(1.0 if action == 0 else -1.0)
            cand = (self.pos_wu + np.float32(sign * inc) * d).astype(
                np.float32
            )
            hit_goal = self._is_colliding(self._goal_map(), cand)
            hit_wall = self._is_colliding(self.wall_map, cand)
            if hit_goal:
                self.reward = np.float32(cfg.goal_reward)
                self.done = True
            else:
                self.reward = np.float32(0)
                self.done = False
                if not hit_wall:
                    self.pos_wu = cand
            # moving actions still pass the heading through mod (identity
            # for dir in [0, D) — models/base.py _turned_dir)
            self.dir_au = np.float32(
                np.mod(self.dir_au, np.float32(cfg.num_directions))
            )
        else:
            turn = np.float32(1.0 if action == 2 else -1.0)
            step = np.float32(turn * np.float32(cfg.turn_increment_au))
            self.dir_au = np.float32(np.mod(
                np.float32(self.dir_au + step),
                np.float32(cfg.num_directions),
            ))
            self.reward = np.float32(0)
            self.done = False
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)


class OracleMultiPlayer(OracleWorld):
    """Scalar mirror of models/multi_player.py: P simultaneous players, one
    shared goal, circle-circle blocking at 2r with the lower-index-wins
    candidate tie-break, per-player cameras where the OTHER players occlude
    as tile blocks.  Discrete headings only (the continuous mode has its own
    oracle extension)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.p = cfg.num_players
        self.ppos = np.zeros((self.p, 2), np.float32)   # [P, 2]
        self.pdir = [0] * self.p                         # [P] angle units
        self.rewards = np.zeros(self.p, np.float32)

    # -- closed-form interior draw (ops/sampling.sample_empty_interior_tile)

    def _draw_interior_excl(self, key, exclude_ranks) -> Tuple[int, int]:
        import jax

        cfg = self.cfg
        wi = cfg.W - 2
        n = np.float32((cfg.H - 2) * wi - len(exclude_ranks))
        u = np.float32(np.asarray(jax.random.uniform(key, (), dtype="float32")))
        k = int(np.clip(np.floor(u * n), np.float32(0.0),
                        max(np.float32(n - 1.0), np.float32(0.0))))
        r = k
        for q in sorted(exclude_ranks):
            if q <= r:
                r += 1
        return (1 + r // wi, 1 + r % wi)

    def reset(self, key) -> None:
        """Draw order: split(key, 4) -> (next, k_goal, k_spawns, k_dirs);
        P sequential interior draws excluding the goal and earlier players
        (models/multi_player.py reset_single)."""
        import jax

        cfg = self.cfg
        next_key, k_goal, k_spawns, k_dirs = jax.random.split(key, 4)
        gi, gj = np.asarray(jax.random.randint(
            k_goal, (2,), np.array([1, 1]),
            np.array([cfg.H - 1, cfg.W - 1]), dtype=np.int32))
        self.goal_tu = (int(gi), int(gj))
        wi = cfg.W - 2
        ranks = [(self.goal_tu[0] - 1) * wi + (self.goal_tu[1] - 1)]
        skeys = jax.random.split(k_spawns, self.p)
        tiles = []
        for i in range(self.p):
            t = self._draw_interior_excl(skeys[i], ranks)
            ranks.append((t[0] - 1) * wi + (t[1] - 1))
            tiles.append(t)
        self.ppos = np.array(
            [[t[0] + 0.5, t[1] + 0.5] for t in tiles], np.float32
        )
        dkeys = jax.random.split(k_dirs, self.p)
        self.pdir = [
            int(np.asarray(jax.random.randint(
                dkeys[i], (), 0, cfg.num_directions, dtype=np.int32)))
            for i in range(self.p)
        ]
        self.rewards = np.zeros(self.p, np.float32)
        self.done = False
        self.t = 0
        self.episode_return = np.zeros(self.p, np.float32)  # per player
        self.rng_key = next_key

    # -- simultaneous step (models/multi_player.py step_single) -----------

    def step(self, actions) -> None:
        cfg = self.cfg
        p = self.p
        inc = np.float32(cfg.position_increment_wu)
        r = np.float32(cfg.player_radius_wu)
        thresh = np.float32((2.0 * cfg.player_radius_wu) ** 2)

        moving = [a < 2 for a in actions]
        cand = self.ppos.copy()
        for i in range(p):
            d = self.directions_wu[self.pdir[i]]
            sign = np.float32(1.0 if actions[i] == 0 else -1.0)
            cand[i] = (self.ppos[i] + np.float32(sign * inc) * d).astype(
                np.float32
            )

        hit_goal = [
            moving[i]
            and self._circle_hits_tile(cand[i], self.goal_tu[0], self.goal_tu[1])
            for i in range(p)
        ]
        hit_wall = [
            moving[i] and self._is_colliding(self.wall_map, cand[i])
            for i in range(p)
        ]

        def d2(a, b):
            dx = np.float32(a[0] - b[0])
            dy = np.float32(a[1] - b[1])
            return np.float32(dx * dx + dy * dy)

        hit_player = [False] * p
        if cfg.player_collision:
            # test 1: candidate vs the OTHERS' current circles
            for i in range(p):
                hit_player[i] = moving[i] and any(
                    d2(cand[i], self.ppos[j]) < thresh
                    for j in range(p) if j != i
                )
            # test 2: candidate vs LOWER-INDEX movers' candidates
            base_ok = [
                moving[i] and not hit_goal[i] and not hit_wall[i]
                and not hit_player[i]
                for i in range(p)
            ]
            for i in range(p):
                if moving[i] and any(
                    base_ok[j] and d2(cand[i], cand[j]) < thresh
                    for j in range(i)
                ):
                    hit_player[i] = True

        self.rewards = np.array(
            [np.float32(cfg.goal_reward) if hit_goal[i] else np.float32(0)
             for i in range(p)], np.float32,
        )
        self.done = any(hit_goal)
        for i in range(p):
            if (moving[i] and not hit_goal[i] and not hit_wall[i]
                    and not hit_player[i]):
                self.ppos[i] = cand[i]
            if not moving[i]:
                if actions[i] == 2:
                    self.pdir[i] = (self.pdir[i] + 1) % cfg.num_directions
                else:
                    self.pdir[i] = (self.pdir[i] - 1) % cfg.num_directions
        self.t += 1
        self.episode_return = (self.episode_return + self.rewards).astype(
            np.float32
        )

    # -- per-player cameras ----------------------------------------------

    def camera_views(self) -> np.ndarray:
        """uint32[P, H_pu, R]: player p's camera with the others visible.
        Block mode: other tiles join the obstacle union and render in the
        block color pair (wall > block > goal precedence).  Sprite mode
        (default): others are billboard circle sprites overlaid after the
        cast (ops/render.sprite_overlay + ray_circle_t, mirrored here in
        scalar float32)."""
        cfg = self.cfg
        sprite = cfg.players_visible and cfg.player_render == "sprite"
        out = np.zeros(
            (self.p, cfg.height_camera_view_pu, cfg.num_rays), np.uint32
        )
        for i in range(self.p):
            self.pos_wu = self.ppos[i]
            self.dir_au = self.pdir[i]
            if cfg.players_visible and not sprite:
                self.blocks = [
                    [int(math.floor(self.ppos[j][0])),
                     int(math.floor(self.ppos[j][1])), 0]
                    for j in range(self.p) if j != i
                ]
            else:
                self.blocks = []
            img = self.camera_view()
            if sprite:
                self._overlay_sprites(img, i)
            out[i] = img
        self.blocks = []
        return out

    def _overlay_sprites(self, img: np.ndarray, i: int) -> None:
        """Scalar mirror of ops/render.ray_circle_t + sprite_overlay for
        player i's frame: nearest positive ray-circle hit per ray, occluded
        by the wall/goal hit, floor-standing TILE_BLOCK column of
        sprite_height_wu at the fisheye-projected distance."""
        cfg = self.cfg
        hpu = cfg.height_camera_view_pu
        r = cfg.num_rays
        dirs, hit_tu, hit_dim, dist = self.cast_rays()
        pd = self.player_dir()
        num = np.float32(cfg.camera_height_tile_wu * r)
        denom = np.float32(2.0 * cfg.semi_field_of_view_wu)
        r2 = np.float32(cfg.player_radius_wu ** 2)
        sh = np.float32(cfg.sprite_height_wu)
        for ridx in range(r):
            dx = np.float32(dirs[ridx, 0])
            dy = np.float32(dirs[ridx, 1])
            t_best = np.float32(np.inf)
            for j in range(self.p):
                if j == i:
                    continue
                ox = np.float32(self.ppos[j][0] - self.pos_wu[0])
                oy = np.float32(self.ppos[j][1] - self.pos_wu[1])
                b = np.float32(np.float32(dx * ox) + np.float32(dy * oy))
                c2 = np.float32(np.float32(ox * ox) + np.float32(oy * oy))
                disc = np.float32(np.float32(b * b - c2) + r2)
                if disc < 0:
                    continue
                t = np.float32(b - np.float32(np.sqrt(disc)))
                if t > 0 and t < t_best:
                    t_best = t
            if not (t_best < dist[ridx]):
                continue
            proj = np.float32(t_best * np.float32(
                np.float32(pd[0] * dirs[ridx, 0])
                + np.float32(pd[1] * dirs[ridx, 1])
            ))
            with np.errstate(divide="ignore", over="ignore"):
                h_line = np.float32(num / np.float32(denom * proj))
            if not np.isfinite(h_line):
                continue
            h_pu = int(math.floor(min(float(h_line), float(hpu))))
            pad = 0 if h_pu >= hpu - 1 else (hpu - h_pu) // 2
            bottom = hpu - pad
            hs = int(math.floor(min(float(np.float32(sh * h_line)),
                                    float(hpu))))
            top = max(bottom - hs, 0)
            img[top:bottom, r - 1 - ridx] = colors.TILE_BLOCK


class OracleMultiPlayerContinuous(OracleMultiPlayer):
    """OracleMultiPlayer with continuous float headings: uniform float32
    heading draws, fractional turns, live per-player direction vectors and
    ray fans (same shared-transcendental contract as OracleContinuous)."""

    def reset(self, key) -> None:
        import jax

        super().reset(key)
        # re-derive the heading draws as the continuous branch does
        # (sampling.sample_heading continuous=True): same k_dirs splits,
        # uniform instead of randint
        _, _, _, k_dirs = jax.random.split(key, 4)
        dkeys = jax.random.split(k_dirs, self.p)
        self.pdir = [
            np.float32(np.asarray(jax.random.uniform(
                dkeys[i], (), dtype="float32",
                maxval=float(self.cfg.num_directions),
            )))
            for i in range(self.p)
        ]

    def _pdir_vec(self, dir_au) -> np.ndarray:
        import jax.numpy as jnp

        ang = np.float32(dir_au) * np.float32(
            2.0 * np.pi / self.cfg.num_directions
        )
        return np.array(
            [np.asarray(jnp.cos(jnp.float32(ang))),
             np.asarray(jnp.sin(jnp.float32(ang)))], np.float32,
        )

    def player_dir(self) -> np.ndarray:
        return self._pdir_vec(self.dir_au)

    def ray_fan(self) -> np.ndarray:
        cfg = self.cfg
        d = self.player_dir()
        cam = np.array([d[1], -d[0]], np.float32)
        s = np.float32(cfg.semi_field_of_view_wu)
        first = (d + s * cam).astype(np.float32)
        last = (d - s * cam).astype(np.float32)
        r = cfg.num_rays
        t = (np.arange(r, dtype=np.float32) / np.float32(r - 1))[:, None]
        un = (first[None, :] + t * (last - first)[None, :]).astype(np.float32)
        norm = np.sqrt(np.sum(un * un, axis=-1, keepdims=True)).astype(
            np.float32
        )
        return (un / norm).astype(np.float32)

    def step(self, actions) -> None:
        cfg = self.cfg
        p = self.p
        inc = np.float32(cfg.position_increment_wu)
        thresh = np.float32((2.0 * cfg.player_radius_wu) ** 2)

        moving = [a < 2 for a in actions]
        cand = self.ppos.copy()
        for i in range(p):
            d = self._pdir_vec(self.pdir[i])
            sign = np.float32(1.0 if actions[i] == 0 else -1.0)
            cand[i] = (self.ppos[i] + np.float32(sign * inc) * d).astype(
                np.float32
            )

        hit_goal = [
            moving[i]
            and self._circle_hits_tile(cand[i], self.goal_tu[0], self.goal_tu[1])
            for i in range(p)
        ]
        hit_wall = [
            moving[i] and self._is_colliding(self.wall_map, cand[i])
            for i in range(p)
        ]

        def d2(a, b):
            dx = np.float32(a[0] - b[0])
            dy = np.float32(a[1] - b[1])
            return np.float32(dx * dx + dy * dy)

        hit_player = [False] * p
        if cfg.player_collision:
            for i in range(p):
                hit_player[i] = moving[i] and any(
                    d2(cand[i], self.ppos[j]) < thresh
                    for j in range(p) if j != i
                )
            base_ok = [
                moving[i] and not hit_goal[i] and not hit_wall[i]
                and not hit_player[i]
                for i in range(p)
            ]
            for i in range(p):
                if moving[i] and any(
                    base_ok[j] and d2(cand[i], cand[j]) < thresh
                    for j in range(i)
                ):
                    hit_player[i] = True

        self.rewards = np.array(
            [np.float32(cfg.goal_reward) if hit_goal[i] else np.float32(0)
             for i in range(p)], np.float32,
        )
        self.done = any(hit_goal)
        tinc = np.float32(cfg.turn_increment_au)
        nd = np.float32(cfg.num_directions)
        for i in range(p):
            if (moving[i] and not hit_goal[i] and not hit_wall[i]
                    and not hit_player[i]):
                self.ppos[i] = cand[i]
            if moving[i]:
                # moving actions pass the heading through mod (identity)
                self.pdir[i] = np.float32(np.mod(self.pdir[i], nd))
            else:
                turn = np.float32(1.0 if actions[i] == 2 else -1.0)
                self.pdir[i] = np.float32(np.mod(
                    np.float32(self.pdir[i] + np.float32(turn * tinc)), nd
                ))
        self.t += 1
        self.episode_return = (self.episode_return + self.rewards).astype(
            np.float32
        )


class OracleDynamicRoom(OracleWorld):
    """Mirror of models/dynamic_room.py (K patrolling blocks)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_blocks = cfg.num_blocks
        self.block_period = cfg.block_period

    def reset(self, key) -> None:
        """Draw order: split(key, 6) -> (next, k_goal, k_blocks, k_dirs,
        k_spawn, k_dir) (models/dynamic_room.py:76-103)."""
        import jax

        cfg = self.cfg
        next_key, k_goal, k_blocks, k_dirs, k_spawn, k_dir = jax.random.split(
            key, 6
        )
        gi, gj = np.asarray(jax.random.randint(
            k_goal, (2,), np.array([1, 1]),
            np.array([cfg.H - 1, cfg.W - 1]), dtype=np.int32))
        self.goal_tu = (int(gi), int(gj))
        occupied = self.wall_map.copy()
        occupied[self.goal_tu] = True
        bkeys = jax.random.split(k_blocks, self.num_blocks)
        tiles = []
        for k in range(self.num_blocks):
            b = self._draw_empty(bkeys[k], occupied)
            occupied[b] = True
            tiles.append(b)
        dirs = np.asarray(jax.random.randint(
            k_dirs, (self.num_blocks,), 0, 4, dtype=np.int32))
        self.blocks = [[t[0], t[1], int(d)] for t, d in zip(tiles, dirs)]
        s = self._draw_empty(k_spawn, occupied)
        self.pos_wu = np.array([s[0] + 0.5, s[1] + 0.5], np.float32)
        self.dir_au = int(np.asarray(jax.random.randint(
            k_dir, (), 0, cfg.num_directions, dtype=np.int32)))
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        self.rng_key = next_key

    def _advance_blocks(self) -> None:
        """Simultaneous tick: advance or bounce (dir ^= 1) off walls, the
        goal, other blocks' CURRENT tiles, and the player circle
        (models/dynamic_room.py:128-155)."""
        h, w = self.wall_map.shape
        current = {(b[0], b[1]) for b in self.blocks}
        new_blocks = []
        for b in self.blocks:
            di, dj = _CARDINAL[b[2]]
            ci, cj = b[0] + di, b[1] + dj
            cci = min(max(ci, 0), h - 1)
            ccj = min(max(cj, 0), w - 1)
            blocked = (
                self.wall_map[cci, ccj]
                or (ci, cj) == self.goal_tu
                or (ci, cj) in current
                or self._circle_hits_tile(self.pos_wu, ci, cj)
            )
            if blocked:
                new_blocks.append([b[0], b[1], b[2] ^ 1])
            else:
                new_blocks.append([ci, cj, b[2]])
        self.blocks = new_blocks

    def step(self, action: int) -> None:
        cfg = self.cfg
        assert 0 <= action < 4
        if (self.t + 1) % self.block_period == 0:
            self._advance_blocks()
        if action < 2:
            d = self.directions_wu[self.dir_au]
            inc = np.float32(cfg.position_increment_wu)
            sign = np.float32(1.0 if action == 0 else -1.0)
            cand = (self.pos_wu + sign * inc * d).astype(np.float32)
            hit_goal = self._is_colliding(self._goal_map(), cand)
            hit_wall = self._is_colliding(self._solid_map(), cand)
            if hit_goal:
                self.reward = np.float32(cfg.goal_reward)
                self.done = True
            else:
                self.reward = np.float32(0)
                self.done = False
                if not hit_wall:
                    self.pos_wu = cand
        else:
            if action == 2:
                self.dir_au = (self.dir_au + 1) % cfg.num_directions
            else:
                self.dir_au = (self.dir_au - 1) % cfg.num_directions
            self.reward = np.float32(0)
            self.done = False
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)


class OracleLockedRoom(OracleWorld):
    """Scalar mirror of models/locked_room.py: a full-height DOOR line at
    ``cfg.resolved_door_col`` acts as walls and renders in the blue block
    pair until the KEY — a red zero-reward collectable on the near side —
    is touched (contact collects and blocks the move, the goal-blocks-entry
    rule applied to the key); the goal lives on the far side.  Doors ride
    the oracle's block list and the key its goal-tiles list, so the
    obstacle union and column colors mirror the JAX side by construction.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self.door_col = cfg.resolved_door_col
        self.key_tu: Tuple[int, int] = (0, 0)
        self.key_held = False

    def _sync_solids(self) -> None:
        h = self.cfg.height_tile_map_tu
        if self.key_held:
            self.blocks = []
            self.goal_tiles = [self.goal_tu]
        else:
            self.blocks = [
                [i, self.door_col, 0] for i in range(1, h - 1)
            ]
            self.goal_tiles = [self.goal_tu, self.key_tu]

    def reset(self, key) -> None:
        """Draw order mirrors models/locked_room.py reset_single:
        split(key, 5) -> (next, k_goal, k_key, k_spawn, k_dir); goal
        uniform right of the door, key uniform left, spawn via the
        rank-with-one-exclusion closed form over the left interior."""
        import jax

        cfg = self.cfg
        h, w = cfg.height_tile_map_tu, cfg.width_tile_map_tu
        dc = self.door_col
        next_key, k_goal, k_key, k_spawn, k_dir = jax.random.split(key, 5)

        g = np.asarray(jax.random.randint(
            k_goal, (2,), np.array([1, dc + 1]), np.array([h - 1, w - 1]),
            dtype=np.int32,
        ))
        self.goal_tu = (int(g[0]), int(g[1]))
        kt = np.asarray(jax.random.randint(
            k_key, (2,), np.array([1, 1]), np.array([h - 1, dc]),
            dtype=np.int32,
        ))
        self.key_tu = (int(kt[0]), int(kt[1]))

        wi = dc - 1
        n = np.float32((h - 2) * wi - 1)
        u = np.float32(np.asarray(
            jax.random.uniform(k_spawn, (), dtype="float32")
        ))
        kk = np.floor(np.float32(u * n))
        kk = int(min(max(kk, np.float32(0.0)),
                     np.float32(max(float(n) - 1.0, 0.0))))
        key_rank = (self.key_tu[0] - 1) * wi + (self.key_tu[1] - 1)
        r = kk + (1 if key_rank <= kk else 0)
        spawn = (1 + r // wi, 1 + r % wi)
        self.pos_wu = np.array([spawn[0] + 0.5, spawn[1] + 0.5], np.float32)
        self.dir_au = int(np.asarray(jax.random.randint(
            k_dir, (), 0, cfg.num_directions, dtype=np.int32)))

        self.key_held = False
        self._sync_solids()
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        self.rng_key = next_key

    def step(self, action: int) -> None:
        cfg = self.cfg
        assert 0 <= action < 4
        if action < 2:
            d = self.directions_wu[self.dir_au]
            inc = np.float32(cfg.position_increment_wu)
            sign = np.float32(1.0 if action == 0 else -1.0)
            cand = (self.pos_wu + sign * inc * d).astype(np.float32)
            hit_goal = self._circle_hits_tile(cand, *self.goal_tu)
            hit_key = (not self.key_held) and self._circle_hits_tile(
                cand, *self.key_tu
            )
            # doors (the block list) are solid BEFORE this step's collection
            solid = self.wall_map | self._block_map()
            hit_wall = self._is_colliding(solid, cand)
            self.reward = np.float32(cfg.goal_reward if hit_goal else 0)
            self.done = bool(hit_goal)
            if hit_key:
                self.key_held = True
                self._sync_solids()
            if (not hit_goal) and (not hit_key) and (not hit_wall):
                self.pos_wu = cand
        else:
            if action == 2:
                self.dir_au = (self.dir_au + 1) % cfg.num_directions
            else:
                self.dir_au = (self.dir_au - 1) % cfg.num_directions
            self.reward = np.float32(0)
            self.done = False
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)

"""Scalar NumPy oracle for SingleRoom — the fixed-seed parity target.

An independent, deliberately *naive* reimplementation of the reference
semantics (/root/reference/src/single_room.jl, utils.jl,
collision_detection.jl, plus the Lodev DDA contract of RayCaster.jl at
single_room.jl:223-227): mutable state, Python branches, per-ray while-loops,
per-column render loops — the exact opposite of the JAX build, which is the
point: agreement between the two is strong evidence both are right.

Only the PRNG is shared infrastructure: reset draws use ``jax.random``
with the same key-split order as ``SingleRoom.reset_single``, because JAX's
threefry is deterministic across backends — that is what makes the parity
*bit-exact* rather than merely statistical.  All game logic here is NumPy.

Indexing is 0-based like the JAX build (the Julia reference is 1-based; the
translation is ``wu_to_tu(x) = floor(x)`` and tile centers at ``i + 0.5``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..config import EnvConfig
from .. import colors


def wu_to_tu(x: float) -> int:
    return int(math.floor(x))


def wu_to_pu(x: float, ppu: int) -> int:
    return int(math.floor(x * ppu))


class OracleSingleRoom:
    """Mutable single-env world, reference-faithful."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        h, w = cfg.H, cfg.W
        self.wall_map = np.array(cfg.border_wall_map, dtype=bool)
        self.goal_tu = (1, 1)
        self.pos_wu = np.zeros(2, np.float32)
        self.dir_au = 0
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        # float32 LUT identical to EnvConfig.directions_wu
        self.directions_wu = np.array(cfg.directions_wu, np.float32)
        self.rng_key = None

    # -- reset (PRNG stream shared with the JAX build) -------------------

    def reset(self, key) -> None:
        """Same draw order as SingleRoom.reset_single: split(key, 4) ->
        (next, goal, spawn, heading)."""
        import jax

        cfg = self.cfg
        next_key, k_goal, k_spawn, k_dir = jax.random.split(key, 4)
        gi, gj = np.asarray(
            jax.random.randint(
                k_goal, (2,), np.array([1, 1]),
                np.array([cfg.H - 1, cfg.W - 1]), dtype=np.int32,
            )
        )
        self.goal_tu = (int(gi), int(gj))

        occupied = self.wall_map.copy()
        occupied[self.goal_tu] = True
        # cumsum-inversion sampler, mirroring ops/sampling.sample_empty_tile
        empty = (~occupied.reshape(-1)).astype(np.int32)
        c = np.cumsum(empty)
        n = int(c[-1])
        u = np.float32(np.asarray(jax.random.uniform(k_spawn, (), dtype='float32')))
        k = int(np.floor(u * np.float32(n)))
        k = min(max(k, 0), max(n - 1, 0))
        idx = int(np.argmax(c > k))
        si, sj = idx // cfg.W, idx % cfg.W
        self.pos_wu = np.array([si + 0.5, sj + 0.5], np.float32)

        self.dir_au = int(
            np.asarray(
                jax.random.randint(k_dir, (), 0, cfg.num_directions, dtype=np.int32)
            )
        )
        self.reward = np.float32(0)
        self.done = False
        self.t = 0
        self.episode_return = np.float32(0)
        self.rng_key = next_key

    # -- collision (ref collision_detection.jl) --------------------------

    def _is_colliding(self, obstacle_map: np.ndarray, pos: np.ndarray) -> bool:
        """3x3 neighborhood scan with early-out (collision_detection.jl:21-42)."""
        r = np.float32(self.cfg.player_radius_wu)
        ti, tj = wu_to_tu(pos[0]), wu_to_tu(pos[1])
        for j in range(tj - 1, tj + 2):
            for i in range(ti - 1, ti + 2):
                if not obstacle_map[i, j]:
                    continue
                cx = np.float32(i + 0.5)
                cy = np.float32(j + 0.5)
                rx = np.float32(pos[0] - cx)
                ry = np.float32(pos[1] - cy)
                px = min(max(rx, np.float32(-0.5)), np.float32(0.5))
                py = min(max(ry, np.float32(-0.5)), np.float32(0.5))
                d2 = (rx - px) ** 2 + (ry - py) ** 2
                if d2 < r * r:
                    return True
        return False

    def _goal_map(self) -> np.ndarray:
        m = np.zeros_like(self.wall_map)
        m[self.goal_tu] = True
        return m

    # -- act (ref single_room.jl:139-191) --------------------------------

    def step(self, action: int) -> None:
        assert 0 <= action < 4
        cfg = self.cfg
        if action < 2:
            d = self.directions_wu[self.dir_au]
            inc = np.float32(cfg.position_increment_wu)
            if action == 0:
                cand = (self.pos_wu + inc * d).astype(np.float32)
            else:
                cand = (self.pos_wu - inc * d).astype(np.float32)
            hit_goal = self._is_colliding(self._goal_map(), cand)
            hit_wall = self._is_colliding(self.wall_map, cand)
            if hit_goal or hit_wall:
                if hit_goal:
                    self.reward = np.float32(cfg.goal_reward)
                    self.done = True
                else:
                    self.reward = np.float32(0)
                    self.done = False
            else:
                self.pos_wu = cand
                self.reward = np.float32(0)
                self.done = False
        else:
            if action == 2:
                self.dir_au = (self.dir_au + 1) % cfg.num_directions
            else:
                self.dir_au = (self.dir_au - 1) % cfg.num_directions
            self.reward = np.float32(0)
            self.done = False
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)

    # -- raycast (ref single_room.jl:193-231 + Lodev DDA) ----------------

    def player_dir(self) -> np.ndarray:
        """f32[2] heading vector — the discrete LUT row (OracleContinuous
        overrides with the live cos/sin of the float heading)."""
        return self.directions_wu[self.dir_au]

    def ray_fan(self) -> np.ndarray:
        """Per-heading ray directions.  Uses the shared host-side float64 LUT
        (EnvConfig.ray_fan_lut) — like the direction LUT, the fan is a config
        constant shared by both implementations; its geometry is
        independently checked in tests/test_raycast.py."""
        return np.array(self.cfg.ray_fan_lut[self.dir_au], np.float32)

    def cast_one(
        self, obstacle_map: np.ndarray, px: float, py: float, dx: float, dy: float
    ) -> Tuple[int, int, int, float]:
        """Scalar raycast dispatch: the sequential Lodev DDA, or the
        crossing-formulation mirror when the config selects that backend.
        Returns (i_hit, j_hit, hit_dim in {0,1}, euclidean distance along
        the ray to the hit face)."""
        if self.cfg.resolved_raycast_backend == "crossing":
            return self.cast_one_crossing(obstacle_map, px, py, dx, dy)
        return self.cast_one_scan(obstacle_map, px, py, dx, dy)

    def cast_one_crossing(
        self, obstacle_map: np.ndarray, px: float, py: float, dx: float, dy: float
    ) -> Tuple[int, int, int, float]:
        """Scalar mirror of ops/raycast.cast_rays_crossing — identical
        float32 expressions per candidate (closed-form ``(frac + k)/|d|``,
        no accumulation), same tie rules, same clip-and-mask handling."""
        h, w = obstacle_map.shape
        big = np.float32(np.finfo(np.float32).max)
        px = np.float32(px)
        py = np.float32(py)
        dx = np.float32(dx)
        dy = np.float32(dy)

        def axis(d_main, d_cross, p_main, p_cross, n, size_cross, main_is_i):
            main0 = int(math.floor(p_main))
            size_main = h if main_is_i else w
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                step = -1 if d_main < 0 else 1
                frac = np.float32(p_main - np.float32(math.floor(p_main)))
                frac_sel = np.float32(
                    frac if d_main < 0 else np.float32(1.0) - frac
                )
                ad = np.float32(abs(d_main))
                best = big
                kb = 0
                cb = 0
                for k in range(n):
                    # add-then-divide, matching ops/raycast._crossing_axis
                    # (no contractible mul+add pattern on either side)
                    t = np.float32(np.float32(frac_sel + np.float32(k)) / ad)
                    finite = bool(np.isfinite(t))
                    c = (
                        np.float32(p_cross + np.float32(t * d_cross))
                        if finite
                        else np.float32(0.0)
                    )
                    if main_is_i:
                        # d_cross == 0 -> floor, matching the scan's map_j0
                        c_tile = (
                            np.floor(c) if d_cross >= 0 else np.ceil(c) - np.float32(1.0)
                        )
                    else:
                        c_tile = (
                            np.ceil(c) - np.float32(1.0) if d_cross > 0 else np.floor(c)
                        )
                    c_id = int(min(max(float(c_tile), 0.0), float(size_cross - 1)))
                    m_id = main0 + (k + 1) * step
                    mc = min(max(m_id, 0), size_main - 1)
                    occ = bool(
                        obstacle_map[mc, c_id] if main_is_i else obstacle_map[c_id, mc]
                    ) and finite
                    if k == 0:
                        cb = c_id
                    tm = t if occ else big
                    if tm < best:
                        best = tm
                        kb = k
                        cb = c_id
            return best, main0 + (kb + 1) * step, cb

        best_i, mi, ci = axis(dx, dy, px, py, h, w, True)
        best_j, mj, cj = axis(dy, dx, py, px, w, h, False)
        if best_j <= best_i:  # ties check j first, like the sequential march
            return cj, mj, 1, float(best_j)
        return mi, ci, 0, float(best_i)

    def cast_one_scan(
        self, obstacle_map: np.ndarray, px: float, py: float, dx: float, dy: float
    ) -> Tuple[int, int, int, float]:
        """Scalar Lodev DDA.  Returns (i_hit, j_hit, hit_dim in {0,1},
        euclidean distance along the ray to the hit face)."""
        px = np.float32(px)
        py = np.float32(py)
        dx = np.float32(dx)
        dy = np.float32(dy)
        map_i = int(math.floor(px))
        map_j = int(math.floor(py))
        with np.errstate(divide="ignore"):
            delta_i = np.float32(abs(np.float32(1.0) / dx)) if dx != 0 else np.float32(np.inf)
            delta_j = np.float32(abs(np.float32(1.0) / dy)) if dy != 0 else np.float32(np.inf)
        step_i = -1 if dx < 0 else 1
        step_j = -1 if dy < 0 else 1
        frac_i = np.float32(px - np.float32(math.floor(px)))
        frac_j = np.float32(py - np.float32(math.floor(py)))
        side_i = np.float32((frac_i if dx < 0 else np.float32(1.0) - frac_i) * delta_i)
        side_j = np.float32((frac_j if dy < 0 else np.float32(1.0) - frac_j) * delta_j)
        h, w = obstacle_map.shape
        for _ in range(self.cfg.dda_steps):
            if side_i < side_j:
                dist = side_i
                side_i = np.float32(side_i + delta_i)
                map_i += step_i
                dim = 0
            else:
                dist = side_j
                side_j = np.float32(side_j + delta_j)
                map_j += step_j
                dim = 1
            ci = min(max(map_i, 0), h - 1)
            cj = min(max(map_j, 0), w - 1)
            if obstacle_map[ci, cj]:
                return map_i, map_j, dim, float(dist)
        return map_i, map_j, dim, float(np.float32(np.finfo(np.float32).max))

    def cast_rays(self):
        cfg = self.cfg
        obstacle = self.wall_map.copy()
        obstacle[self.goal_tu] = True
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

    # -- camera view (ref single_room.jl:374-444) ------------------------

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
            if self.wall_map[hit_tu[i, 0], hit_tu[i, 1]]:
                color = colors.WALL_DIM_I if hit_dim[i] == 0 else colors.WALL_DIM_J
            else:
                color = colors.GOAL_DIM_I if hit_dim[i] == 0 else colors.GOAL_DIM_J
            k = r - 1 - i  # mirrored column (ref :431)
            if h_pu >= hpu - 1:
                img[:, k] = color
            else:
                pad = (hpu - h_pu) // 2
                img[:pad, k] = colors.CEILING
                img[pad : hpu - pad, k] = color
                img[hpu - pad :, k] = colors.FLOOR
        return img

    # -- top view (ref single_room.jl:342-372,446-483; pixel algorithms per
    # ops/topview.py spec) ------------------------------------------------

    def top_view(self) -> np.ndarray:
        cfg = self.cfg
        ppt = cfg.pu_per_tu
        hpu, wpu = cfg.top_view_shape
        img = np.zeros((hpu, wpu), np.uint32)
        # tile blit + grid lines
        for i in range(cfg.H):
            for j in range(cfg.W):
                if self.wall_map[i, j]:
                    c = colors.TILE_WALL
                elif (i, j) == self.goal_tu:
                    c = colors.TILE_GOAL
                else:
                    c = colors.TILE_EMPTY
                img[i * ppt : (i + 1) * ppt, j * ppt : (j + 1) * ppt] = c
                img[i * ppt, j * ppt : (j + 1) * ppt] = colors.GRID_LINE
                img[(i + 1) * ppt - 1, j * ppt : (j + 1) * ppt] = colors.GRID_LINE
                img[i * ppt : (i + 1) * ppt, j * ppt] = colors.GRID_LINE
                img[i * ppt : (i + 1) * ppt, (j + 1) * ppt - 1] = colors.GRID_LINE
        # ray segments (Bresenham)
        dirs, hit_tu, hit_dim, dist = self.cast_rays()
        p0 = (
            wu_to_pu(self.pos_wu[0], ppt),
            wu_to_pu(self.pos_wu[1], ppt),
        )
        for r in range(cfg.num_rays):
            # hit-axis endpoint from exact integer gridline (ops/topview.py
            # spec); cross axis in float
            sx = np.float32(self.pos_wu[0] + np.float32(dist[r] * dirs[r, 0]))
            sy = np.float32(self.pos_wu[1] + np.float32(dist[r] * dirs[r, 1]))
            px1 = wu_to_pu(sx, ppt)
            py1 = wu_to_pu(sy, ppt)
            if hit_dim[r] == 0:
                face = hit_tu[r, 0] if dirs[r, 0] >= 0 else hit_tu[r, 0] + 1
                px1 = int(face) * ppt
            else:
                face = hit_tu[r, 1] if dirs[r, 1] >= 0 else hit_tu[r, 1] + 1
                py1 = int(face) * ppt
            p1 = (px1, py1)
            for (x, y) in self._bresenham(p0, p1):
                if 0 <= x < hpu and 0 <= y < wpu:
                    img[x, y] = colors.RAY
        # player circle: rounded-distance band
        rad = cfg.player_radius_pu
        for x in range(hpu):
            for y in range(wpu):
                d = math.sqrt((x - p0[0]) ** 2 + (y - p0[1]) ** 2)
                if int(round(d)) == rad:
                    img[x, y] = colors.PLAYER
        return img

    @staticmethod
    def _bresenham(p0, p1):
        x0, y0 = p0
        x1, y1 = p1
        dx = abs(x1 - x0)
        dy = -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        while True:
            yield (x0, y0)
            if x0 == x1 and y0 == y1:
                return
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x0 += sx
            if e2 <= dx:
                err += dx
                y0 += sy

    def tile_grid(self) -> np.ndarray:
        grid = self.wall_map.astype(np.int32)
        grid[self.goal_tu] = 2
        return grid

    def observe(self) -> np.ndarray:
        cfg = self.cfg
        if cfg.obs_type == "camera_u32":
            return self.camera_view()
        if cfg.obs_type == "tile_grid":
            return self.tile_grid()
        raise NotImplementedError(cfg.obs_type)

"""Native (C++) scalar reference engine binding — the fast CPU oracle.

Same semantics as :class:`oracle.single_room.OracleSingleRoom` (a third
independent implementation, in scalar C++ at native/refengine.cpp), bound via
ctypes.  ~1000x faster than the Python-loop oracle, making long-horizon
fixed-seed parity sweeps (the reference test's 5000-step episodes,
/root/reference/test/runtests.jl:6) practical.  Resets share the threefry
PRNG stream with the JAX env exactly like the NumPy oracle.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .. import colors
from ..config import EnvConfig
from .single_room import OracleSingleRoom

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _stale(so: str, srcdir: str) -> bool:
    """True when the .so predates its sources (refengine.cpp / Makefile) —
    a stale binary may lack symbols or carry different FMA flags, silently
    breaking the exact-equality parity assertions."""
    try:
        so_mtime = os.path.getmtime(so)
    except OSError:
        return True
    for name in ("refengine.cpp", "Makefile"):
        src = os.path.join(srcdir, name)
        if os.path.exists(src) and os.path.getmtime(src) > so_mtime:
            return True
    return False


def native_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    srcdir = os.path.join(root, "native")
    so = os.path.join(srcdir, "librefengine.so")
    if not os.path.exists(so) or _stale(so, srcdir):
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", srcdir, "librefengine.so"],
                check=True, capture_output=True, timeout=60,
            )
        except Exception:
            # A stale binary that failed to rebuild is exactly the
            # different-FMA-flags hazard _stale documents — refuse to load
            # it rather than risk silently breaking exact-equality parity.
            return None
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    for sym in ("rcw_step", "rcw_cast", "rcw_cast_crossing",
                "rcw_render_camera"):
        if not hasattr(lib, sym):
            return None  # stale binary that could not be rebuilt
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rcw_step.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, f32p, i32p,
    ]
    lib.rcw_cast.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        i32p, i32p, i32p, f32p,
    ]
    lib.rcw_cast_crossing.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        i32p, i32p, i32p, f32p,
    ]
    lib.rcw_render_camera.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, f32p,
        i32p, i32p, i32p, f32p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        u32p,
    ]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeOracleSingleRoom(OracleSingleRoom):
    """Drop-in OracleSingleRoom with C++ dynamics (reset stays in Python so
    the PRNG stream is shared)."""

    def __init__(self, cfg: EnvConfig):
        super().__init__(cfg)
        self._lib = native_lib()
        if self._lib is None:
            raise RuntimeError(
                "librefengine.so not available; run `make -C native`"
            )
        self._walls_u8 = np.ascontiguousarray(self.wall_map, np.uint8)
        self._fan = np.ascontiguousarray(self.cfg.ray_fan_lut, np.float32)

    def step(self, action: int) -> None:
        assert 0 <= action < 4
        cfg = self.cfg
        pos = np.ascontiguousarray(self.pos_wu, np.float32)
        dir_au = np.array([self.dir_au], np.int32)
        reward = np.zeros(1, np.float32)
        done = np.zeros(1, np.int32)
        self._lib.rcw_step(
            _ptr(self._walls_u8, ctypes.c_uint8), cfg.H, cfg.W,
            _ptr(self.directions_wu, ctypes.c_float), cfg.num_directions,
            ctypes.c_float(np.float32(cfg.player_radius_wu)),
            ctypes.c_float(np.float32(cfg.position_increment_wu)),
            ctypes.c_float(np.float32(cfg.goal_reward)),
            int(self.goal_tu[0]), int(self.goal_tu[1]), int(action),
            _ptr(pos, ctypes.c_float), _ptr(dir_au, ctypes.c_int32),
            _ptr(reward, ctypes.c_float), _ptr(done, ctypes.c_int32),
        )
        self.pos_wu = pos
        self.dir_au = int(dir_au[0])
        self.reward = np.float32(reward[0])
        self.done = bool(done[0])
        self.t += 1
        self.episode_return = np.float32(self.episode_return + self.reward)

    def cast_rays(self):
        cfg = self.cfg
        obstacle = self._walls_u8.copy()
        obstacle[self.goal_tu] = 1
        fan = np.ascontiguousarray(
            self._fan[self.dir_au], np.float32
        )
        r = cfg.num_rays
        hit_i = np.zeros(r, np.int32)
        hit_j = np.zeros(r, np.int32)
        hit_dim = np.zeros(r, np.int32)
        dist = np.zeros(r, np.float32)
        if self.cfg.resolved_raycast_backend == "crossing":
            self._lib.rcw_cast_crossing(
                _ptr(obstacle, ctypes.c_uint8), cfg.H, cfg.W,
                _ptr(fan, ctypes.c_float), r,
                ctypes.c_float(self.pos_wu[0]),
                ctypes.c_float(self.pos_wu[1]),
                _ptr(hit_i, ctypes.c_int32), _ptr(hit_j, ctypes.c_int32),
                _ptr(hit_dim, ctypes.c_int32), _ptr(dist, ctypes.c_float),
            )
        else:
            self._lib.rcw_cast(
                _ptr(obstacle, ctypes.c_uint8), cfg.H, cfg.W,
                _ptr(fan, ctypes.c_float), r,
                ctypes.c_float(self.pos_wu[0]),
                ctypes.c_float(self.pos_wu[1]),
                cfg.dda_steps,
                _ptr(hit_i, ctypes.c_int32), _ptr(hit_j, ctypes.c_int32),
                _ptr(hit_dim, ctypes.c_int32), _ptr(dist, ctypes.c_float),
            )
        return fan, np.stack([hit_i, hit_j], -1).astype(np.int32), hit_dim, dist

    def camera_view(self) -> np.ndarray:
        cfg = self.cfg
        fan, hit_tu, hit_dim, dist = self.cast_rays()
        r = cfg.num_rays
        hpu = cfg.height_camera_view_pu
        img = np.zeros((hpu, r), np.uint32)
        pd = np.ascontiguousarray(self.directions_wu[self.dir_au], np.float32)
        hit_i = np.ascontiguousarray(hit_tu[:, 0], np.int32)
        hit_j = np.ascontiguousarray(hit_tu[:, 1], np.int32)
        self._lib.rcw_render_camera(
            _ptr(self._walls_u8, ctypes.c_uint8), cfg.H, cfg.W,
            _ptr(fan, ctypes.c_float), r, _ptr(pd, ctypes.c_float),
            _ptr(hit_i, ctypes.c_int32), _ptr(hit_j, ctypes.c_int32),
            _ptr(np.ascontiguousarray(hit_dim, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(dist, np.float32), ctypes.c_float),
            hpu,
            ctypes.c_float(np.float32(cfg.camera_height_tile_wu * r)),
            ctypes.c_float(np.float32(2.0 * cfg.semi_field_of_view_wu)),
            colors.CEILING, colors.FLOOR,
            colors.WALL_DIM_I, colors.WALL_DIM_J,
            colors.GOAL_DIM_I, colors.GOAL_DIM_J,
            _ptr(img, ctypes.c_uint32),
        )
        return img

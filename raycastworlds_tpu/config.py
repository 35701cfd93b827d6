"""Static environment configuration.

The reference's entire config system is keyword arguments with defaults on two
constructors (``SingleRoomWorld`` kwargs, /root/reference/src/single_room.jl:42-53,
and the 3 extra rendering kwargs on ``SingleRoom``,
/root/reference/src/single_room.jl:258-272).  Here that becomes a frozen,
hashable dataclass so the whole config is a *static* jit argument: every field
participates in the compilation cache key and XLA sees only concrete shapes.

Unlike the Julia code (1-indexed), everything here is 0-indexed:
tile ``(i, j)`` occupies world units ``[i, i+1) x [j, j+1)`` with center
``(i+0.5, j+0.5)``; ``wu_to_tu(x) = floor(x)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

import numpy as np

# Object channels of the tile map (reference: /root/reference/src/single_room.jl:16-18).
NUM_OBJECTS = 2
WALL = 0
GOAL = 1

# Discrete action set (reference: /root/reference/src/single_room.jl:19,139-191).
NUM_ACTIONS = 4
MOVE_FORWARD = 0
MOVE_BACKWARD = 1
TURN_LEFT = 2
TURN_RIGHT = 3

ACTION_NAMES = ("MOVE_FORWARD", "MOVE_BACKWARD", "TURN_LEFT", "TURN_RIGHT")

# Hit-face axis returned by the raycaster: 0 = face perpendicular to the
# i/x-axis, 1 = perpendicular to the j/y-axis (reference hit_dimension 1/2,
# call contract at /root/reference/src/single_room.jl:223-227).
HIT_DIM_I = 0
HIT_DIM_J = 1


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Mirrors the reference's 12 constructor kwargs exactly, plus engine knobs.

    World kwargs (reference /root/reference/src/single_room.jl:42-53):
    """

    height_tile_map_tu: int = 8
    width_tile_map_tu: int = 16
    num_directions: int = 128          # angle units; 0 = +x axis
    player_radius_wu: float = 0.125    # must be < 0.5
    position_increment_wu: float = 0.125
    semi_field_of_view_wu: float = 2.0 / 3.0
    num_rays: int = 512
    goal_reward: float = 1.0

    # Rendering kwargs (reference /root/reference/src/single_room.jl:269-271).
    pu_per_tu: int = 32
    camera_height_tile_wu: float = 1.0
    height_camera_view_pu: int = 256

    # Engine knobs (no reference equivalent).
    # Fixed DDA trip count; <=0 means use the map-diameter bound H+W, which is
    # sufficient for any map with solid border walls.
    max_dda_steps: int = 0
    # Observation produced by `step`/`reset`:
    #   "camera_u32" : [H_pu, num_rays] uint32 0x00RRGGBB (reference parity,
    #                  RLBase.state at /root/reference/src/single_room.jl:576)
    #   "camera_rgb" : [H_pu, num_rays, 3] uint8 (channels-minor layout —
    #                  max-throughput RGB consumers can take camera_u32
    #                  and unpack consumer-side)
    #   "camera_gray": [H_pu, num_rays] float32 in [0, 1]
    #   "camera_pal8": [H_pu, num_rays] uint8 palette index into
    #                  EnvConfig.palette_np — LOSSLESS (the scene is 12
    #                  colors; textured scenes extend the palette with the
    #                  6 slab colors x their finite brightness-factor sets)
    #                  at 1/4 the bytes of camera_u32; the max-throughput
    #                  camera form.  Decode with
    #                  ops.render.pal8_to_u32(img, cfg.palette_np) /
    #                  colors.pal8_to_u32_np; xor textures need
    #                  texture_cells <= colors.MAX_TEX_FACTORS (40)
    #   "camera_gray_u8": [H_pu, num_rays] uint8 luma in [0, 255] (1-byte
    #                  grayscale; planar, ray axis minor)
    #   "depth"      : [num_rays] float32 projected (fisheye-corrected) depth
    #   "tile_grid"  : [H, W] int32 object grid (0 empty / 1 wall / 2 goal)
    #   "top_u32"    : [H*ppt, W*ppt] uint32 top view (debug; heavier)
    #   "top_rgb"    : [H*ppt, W*ppt, 3] uint8 top view
    obs_type: str = "camera_u32"
    # Raycast backend:
    #   "scan"     — lax.scan masked DDA (general maps; bit-exact parity path)
    #   "scan_flat" — the same DDA over flattened [B*R] lanes (batch path;
    #                bit-identical to "scan")
    #   "analytic" — closed-form border+goal intersection (SingleRoom-shaped
    #                maps only; fastest; ~1e-6 numerics vs DDA, not bit-exact)
    #   "crossing" — loop-free parallel-crossing DDA (general maps; min over
    #                all H+W grid-line crossings — no scan carries, fuses
    #                with the renderer; own oracle parity mode, hit tiles
    #                agree with scan except exact-corner float coincidences)
    #   "auto"     — "crossing"
    raycast_backend: str = "auto"
    # Unroll factor for the scan DDA (higher amortizes loop overhead; CPU
    # tests keep 1 for fast compiles).
    dda_unroll: int = 1
    # Episode time limit: > 0 enables truncation — envs reaching this many
    # steps are auto-reset (reported via StepResult.done and info["truncated"];
    # the goal-termination flag stays in info["terminated"]).  0 = unlimited,
    # the reference's behavior (episodes only end on goal contact).
    max_episode_steps: int = 0
    # Stop the DDA while-loop once all rays have hit (identical results; the
    # while_loop adds a cross-batch reduce per iteration; an option for
    # sparse scenes with far-above-typical trip counts).
    dda_early_exit: bool = False
    # Procedural wall texturing (no reference equivalent — the reference's
    # walls are flat two-shade colors, single_room.jl:417-429).  Textures are
    # computed arithmetically from the wall-face hit coordinate — no texture
    # memory, no gathers, elementwise work only:
    #   "none"    — flat shading (bit-exact reference parity path)
    #   "checker" — (u + v) parity checkerboard
    #   "brick"   — running-bond brick courses with mortar lines
    #   "xor"     — the classic Wolfenstein XOR gradient pattern
    wall_texture: str = "none"
    # Texels per tile edge for the procedural patterns.
    texture_cells: int = 8
    # Continuous headings (opt-in; no reference equivalent — the reference's
    # headings are integer angle units, single_room.jl:46).  The heading
    # becomes a float in [0, num_directions) (same angle-unit scale, so
    # num_directions still sets the angle<->radian conversion); turn actions
    # add +/-turn_increment_au; direction vectors and the ray fan are
    # computed live (ops/raycast.ray_fan) instead of via the per-heading
    # LUTs.  Off the parity path: oracles and the reference are discrete.
    # Requires a general-map raycast backend (crossing or scan).
    continuous_heading: bool = False
    turn_increment_au: float = 1.0
    # Geometry precision (the reference is generic over T,
    # /root/reference/src/single_room.jl:42-44): float dtype of positions,
    # ray math and render arithmetic.  "float64" requires JAX x64 mode
    # (jax.experimental.enable_x64 or jax_enable_x64) and is CPU-oriented —
    # accelerators run f64 far slower than f32.  Parity oracles are float32;
    # f64 configs are covered by invariant tests, not bit-parity.
    dtype: str = "float32"

    def __post_init__(self):
        if self.height_tile_map_tu < 3 or self.width_tile_map_tu < 3:
            raise ValueError("tile map must be at least 3x3 (border walls + interior)")
        if not (0.0 < self.player_radius_wu < 0.5):
            raise ValueError("player_radius_wu must be in (0, 0.5)")
        if self.num_rays < 2:
            raise ValueError("num_rays must be >= 2")
        if self.num_directions < 1:
            raise ValueError("num_directions must be >= 1")
        if self.obs_type not in (
            "camera_u32", "camera_rgb", "camera_gray", "camera_pal8",
            "camera_gray_u8", "depth", "tile_grid", "top_u32", "top_rgb",
        ):
            raise ValueError(f"unknown obs_type: {self.obs_type}")
        if self.obs_type == "camera_pal8" and self.wall_texture == "xor":
            from .colors import MAX_TEX_FACTORS

            if self.texture_cells > MAX_TEX_FACTORS:
                raise ValueError(
                    "obs_type 'camera_pal8' with wall_texture 'xor' needs "
                    f"texture_cells <= {MAX_TEX_FACTORS}: the xor gradient "
                    f"has texture_cells distinct brightness factors and the "
                    "extended uint8 palette holds at most "
                    f"{MAX_TEX_FACTORS} per slab color (checker/brick have "
                    "2 factors and always fit)"
                )
        if self.raycast_backend not in (
            "scan", "scan_flat", "crossing", "analytic", "auto",
        ):
            raise ValueError(f"unknown raycast_backend: {self.raycast_backend}")
        if self.wall_texture not in ("none", "checker", "brick", "xor"):
            raise ValueError(f"unknown wall_texture: {self.wall_texture}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype}")
        if not (2 <= self.texture_cells <= 1 << 15):
            raise ValueError(
                "texture_cells must be in [2, 32768] (int32 texel math)"
            )
        if self.continuous_heading and self.resolved_raycast_backend not in (
            "crossing", "scan",
        ):
            raise ValueError(
                "continuous_heading requires raycast_backend 'crossing' or "
                "'scan' (the LUT-free general-map backends)"
            )
        if self.turn_increment_au <= 0:
            raise ValueError("turn_increment_au must be > 0")

    # ------------------------------------------------------------------
    # Derived static quantities
    # ------------------------------------------------------------------

    @property
    def H(self) -> int:
        return self.height_tile_map_tu

    @property
    def W(self) -> int:
        return self.width_tile_map_tu

    @property
    def dda_steps(self) -> int:
        if self.max_dda_steps > 0:
            return self.max_dda_steps
        return self.height_tile_map_tu + self.width_tile_map_tu

    @property
    def resolved_raycast_backend(self) -> str:
        """'auto' resolved to a concrete backend, from the config alone.

        'auto' is XLA ``crossing``: the fastest general-map backend,
        parity-pinned against its own scalar-oracle and C++-engine modes.
        'scan' remains available as the reference-sequential-semantics path.
        """
        if self.raycast_backend == "auto":
            return "crossing"
        return self.raycast_backend

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        if self.obs_type == "camera_u32":
            return (self.height_camera_view_pu, self.num_rays)
        if self.obs_type == "camera_rgb":
            return (self.height_camera_view_pu, self.num_rays, 3)
        if self.obs_type == "camera_gray":
            return (self.height_camera_view_pu, self.num_rays)
        if self.obs_type in ("camera_pal8", "camera_gray_u8"):
            return (self.height_camera_view_pu, self.num_rays)
        if self.obs_type == "depth":
            return (self.num_rays,)
        if self.obs_type == "tile_grid":
            return (self.height_tile_map_tu, self.width_tile_map_tu)
        if self.obs_type == "top_u32":
            return self.top_view_shape
        if self.obs_type == "top_rgb":
            return self.top_view_shape + (3,)
        raise AssertionError(self.obs_type)

    @property
    def top_view_shape(self) -> Tuple[int, int]:
        return (
            self.height_tile_map_tu * self.pu_per_tu,
            self.width_tile_map_tu * self.pu_per_tu,
        )

    # ------------------------------------------------------------------
    # Host-side constants (computed in float64 then cast, so the embedded
    # constants are bit-identical across CPU/GPU backends — important for the
    # fixed-seed parity guarantee; the reference computes the same LUT at
    # construction, /root/reference/src/single_room.jl:65-69).
    # ------------------------------------------------------------------

    @property
    def float_dtype(self):
        """NumPy dtype of the geometry precision (EnvConfig.dtype)."""
        return np.float64 if self.dtype == "float64" else np.float32

    @functools.cached_property
    def directions_wu(self) -> np.ndarray:
        """[num_directions, 2] unit vectors (cfg dtype); au*2*pi/D, 0 = +x."""
        d = self.num_directions
        theta = np.arange(d, dtype=np.float64) * (2.0 * math.pi / d)
        return np.stack(
            [np.cos(theta), np.sin(theta)], axis=-1
        ).astype(self.float_dtype)

    @property
    def player_radius_pu(self) -> int:
        """Player radius in pixels for the top view (ref wu_to_pu of the
        radius, /root/reference/src/single_room.jl:470; 0-indexed floor)."""
        return int(math.floor(self.player_radius_wu * self.pu_per_tu))

    @functools.cached_property
    def ray_fan_lut(self) -> np.ndarray:
        """[num_directions, num_rays, 2] float32 normalized ray directions.

        The fan depends only on the (discrete) heading, so it is precomputed
        host-side in float64 and cast once.  This is both faster (per-step fan
        generation becomes one dynamic-slice) and bit-deterministic across
        XLA backends (elementwise recomputation is subject to backend FMA
        fusion, which changes low bits).

        Geometry (ref /root/reference/src/single_room.jl:213-221): rays lerp
        linearly across the camera plane from ``dir + sfov*cam`` to
        ``dir - sfov*cam`` with ``cam = rotate_minus_90(dir)``, then
        normalize.
        """
        d = self.num_directions
        r = self.num_rays
        theta = np.arange(d, dtype=np.float64) * (2.0 * math.pi / d)
        dirs = np.stack([np.cos(theta), np.sin(theta)], axis=-1)  # [D, 2]
        cam = np.stack([dirs[:, 1], -dirs[:, 0]], axis=-1)        # [D, 2]
        s = float(self.semi_field_of_view_wu)
        first = dirs + s * cam                                    # [D, 2]
        last = dirs - s * cam
        t = (np.arange(r, dtype=np.float64) / (r - 1))[None, :, None]
        un = first[:, None, :] + t * (last - first)[:, None, :]   # [D, R, 2]
        un /= np.linalg.norm(un, axis=-1, keepdims=True)
        return un.astype(self.float_dtype)

    @functools.cached_property
    def palette_np(self) -> np.ndarray:
        """uint32[N] active render palette for pal8 observations: the frozen
        12-entry base palette, extended with the 6 slab colors x F texture
        brightness factors when a wall texture is on (colors.py
        ``build_texture_palette``; lossless — each entry stores the exact
        u32 the float texture chain produces)."""
        from . import colors as _colors

        if self.wall_texture == "none":
            return _colors.PALETTE_NP
        return _colors.build_texture_palette(
            self.wall_texture, self.texture_cells
        )

    @functools.cached_property
    def palette_rgb_f32(self) -> np.ndarray:
        """[N, 3] float32 RGB decode table of ``palette_np`` (learner-side
        one-hot contraction target for pal8 features)."""
        from . import colors as _colors

        return _colors.palette_rgb_f32(self.palette_np)

    @functools.cached_property
    def border_wall_map(self) -> np.ndarray:
        """[H, W] bool — walls on the border (reference :57-60)."""
        m = np.zeros((self.H, self.W), dtype=bool)
        m[0, :] = m[-1, :] = True
        m[:, 0] = m[:, -1] = True
        return m

    @functools.cached_property
    def border_wall_words(self) -> np.ndarray:
        """Bit-packed ``border_wall_map`` (uint32[ceil(H*W/32)]), host-packed
        once so resets embed it as a compile-time constant."""
        from .ops.bitmap import pack_bits_np

        return pack_bits_np(self.border_wall_map)


def replace(cfg: EnvConfig, **kw: Any) -> EnvConfig:
    return dataclasses.replace(cfg, **kw)

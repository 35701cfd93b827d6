"""Parity and agreement tests for the loop-free 'crossing' raycast backend.

The crossing backend (ops/raycast.cast_rays_crossing) reformulates the
sequential DDA march as a parallel min over all grid-line crossings.  It has
its own scalar-oracle mode (oracle/single_room.py cast_one_crossing — same
float32 expressions), so parity is pinned the same way as the scan backend:
fixed-seed trajectories and pixel-exact camera views vs the independent
NumPy implementation.  Against the sequential scan it must agree on hit
tiles and hit dimensions everywhere (distances may differ by ~1 ulp:
closed-form ``side0 + k*delta`` vs accumulated sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.ops import bitmap, raycast
from raycastworlds_tpu.oracle.families import OracleWorld


def test_crossing_matches_scan_on_random_maps():
    rng = np.random.RandomState(0)
    total = 0
    for _ in range(60):
        h, w = rng.randint(5, 18), rng.randint(5, 18)
        m = rng.rand(h, w) < 0.25
        m[0] = m[-1] = True
        m[:, 0] = m[:, -1] = True
        free = np.argwhere(~m)
        if len(free) == 0:
            continue
        ti, tj = free[rng.randint(len(free))]
        px = ti + rng.rand() * 0.98 + 0.01
        py = tj + rng.rand() * 0.98 + 0.01
        ang = rng.rand(16) * 2 * np.pi
        dirs = jnp.asarray(
            np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        )
        words = jnp.asarray(bitmap.pack_bits_np(m))
        pos = jnp.asarray([px, py], jnp.float32)
        ht1, hd1, d1 = jax.jit(
            lambda wo, p, d: raycast.cast_rays_scan(wo, (h, w), p, d, h + w)
        )(words, pos, dirs)
        ht2, hd2, d2 = jax.jit(
            lambda wo, p, d: raycast.cast_rays_crossing(wo, (h, w), p, d)
        )(words, pos, dirs)
        np.testing.assert_array_equal(np.asarray(ht1), np.asarray(ht2))
        np.testing.assert_array_equal(np.asarray(hd1), np.asarray(hd2))
        np.testing.assert_allclose(
            np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
        )
        total += len(ang)
    assert total > 500


def test_crossing_matches_scan_on_large_maps():
    """Maps wider than 32 tiles use the multi-word line-occupancy path
    (n_lw >= 2); hit tiles/dims must still agree with the sequential scan
    — there is no fallback cliff at 32 (round-2 verdict item 4)."""
    rng = np.random.RandomState(1)
    for h, w in [(33, 20), (48, 48), (64, 40), (40, 70)]:
        m = rng.rand(h, w) < 0.15
        m[0] = m[-1] = True
        m[:, 0] = m[:, -1] = True
        free = np.argwhere(~m)
        ti, tj = free[rng.randint(len(free))]
        px = ti + rng.rand() * 0.98 + 0.01
        py = tj + rng.rand() * 0.98 + 0.01
        ang = rng.rand(32) * 2 * np.pi
        dirs = jnp.asarray(
            np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        )
        words = jnp.asarray(bitmap.pack_bits_np(m))
        pos = jnp.asarray([px, py], jnp.float32)
        ht1, hd1, d1 = jax.jit(
            lambda wo, p, d: raycast.cast_rays_scan(wo, (h, w), p, d, h + w)
        )(words, pos, dirs)
        ht2, hd2, d2 = jax.jit(
            lambda wo, p, d: raycast.cast_rays_crossing(wo, (h, w), p, d)
        )(words, pos, dirs)
        np.testing.assert_array_equal(np.asarray(ht1), np.asarray(ht2))
        np.testing.assert_array_equal(np.asarray(hd1), np.asarray(hd2))
        np.testing.assert_allclose(
            np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
        )


def test_crossing_gridline_parallel_ray_matches_scan():
    """A ray sliding exactly along a gridline (d_cross == 0, integer
    p_cross) must probe the tile row/column the scan probes (floor), not
    the one below (ADVICE r2: ceil-1 divergence)."""
    h = w = 8
    m = np.zeros((h, w), bool)
    m[0] = m[-1] = True
    m[:, 0] = m[:, -1] = True
    m[5, 4] = True  # obstacle touching the j=4 gridline from above
    words = jnp.asarray(bitmap.pack_bits_np(m))
    # origin on the gridline j=4.0, heading +i: slides along the line
    pos = jnp.asarray([2.5, 4.0], jnp.float32)
    dirs = jnp.asarray([[1.0, 0.0]], jnp.float32)
    ht_s, hd_s, d_s = jax.jit(
        lambda wo, p, d: raycast.cast_rays_scan(wo, (h, w), p, d, h + w)
    )(words, pos, dirs)
    ht_c, hd_c, d_c = jax.jit(
        lambda wo, p, d: raycast.cast_rays_crossing(wo, (h, w), p, d)
    )(words, pos, dirs)
    np.testing.assert_array_equal(np.asarray(ht_s), np.asarray(ht_c))
    np.testing.assert_array_equal(np.asarray(hd_s), np.asarray(hd_c))
    np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_c), rtol=1e-6)


@pytest.mark.parametrize("texture", ["none", "checker"])
def test_crossing_trajectory_parity(texture):
    """Fixed-seed pose + pixel parity vs the scalar crossing oracle."""
    cfg = rcw.EnvConfig(
        num_rays=48, height_camera_view_pu=32,
        raycast_backend="crossing", wall_texture=texture,
    )
    game = rcw.SingleRoom(cfg)
    reset = jax.jit(game.reset_single)
    step = jax.jit(game.step_single)
    observe = jax.jit(game.observe_single)
    oracle = OracleWorld(cfg)

    key = jax.random.PRNGKey(5)
    state = reset(key)
    oracle.reset(key)
    rng = np.random.RandomState(5)
    for t in range(260):
        assert np.asarray(state.pos_wu).tolist() == oracle.pos_wu.tolist(), t
        assert float(state.reward) == float(oracle.reward), t
        if t % 13 == 0:
            np.testing.assert_array_equal(
                np.asarray(observe(state)), oracle.camera_view(),
                err_msg=f"step {t}",
            )
        if bool(state.done):
            k = state.rng_key
            state = reset(k)
            oracle.reset(k)
        else:
            a = int(rng.choice(4, p=[0.55, 0.05, 0.2, 0.2]))
            state = step(state, jnp.int32(a))
            oracle.step(a)


def test_crossing_maze_parity():
    """Arbitrary generated map: dynamics + renderer parity on a maze."""
    cfg = rcw.MazeConfig(
        height_tile_map_tu=9, width_tile_map_tu=9,
        num_rays=48, height_camera_view_pu=32,
        raycast_backend="crossing",
    )
    game = rcw.Maze(cfg)
    reset = jax.jit(game.reset_single)
    step = jax.jit(game.step_single)
    observe = jax.jit(game.observe_single)

    key = jax.random.PRNGKey(7)
    state = reset(key)
    wall_map = np.asarray(bitmap.unpack_bits(state.wall_words, (cfg.H, cfg.W)))
    oracle = OracleWorld.from_map(
        cfg, wall_map, np.asarray(state.goal_tu),
        np.asarray(state.pos_wu), int(state.dir_au),
    )
    rng = np.random.RandomState(11)
    for t in range(120):
        assert np.asarray(state.pos_wu).tolist() == oracle.pos_wu.tolist(), t
        if t % 12 == 0:
            np.testing.assert_array_equal(
                np.asarray(observe(state)), oracle.camera_view(),
                err_msg=f"step {t}",
            )
        if bool(state.done):
            break
        a = int(rng.choice(4, p=[0.55, 0.05, 0.2, 0.2]))
        state = step(state, jnp.int32(a))
        oracle.step(a)


def test_crossing_axis_aligned_and_degenerate_rays():
    """dx == 0 / dy == 0 rays and integer positions don't produce NaNs or
    out-of-map hits."""
    cfg = rcw.EnvConfig(num_rays=8, raycast_backend="crossing")
    words = jnp.asarray(cfg.border_wall_words)
    dirs = jnp.asarray(
        [[1, 0], [-1, 0], [0, 1], [0, -1],
         [1, 0], [-1, 0], [0, 1], [0, -1]], jnp.float32
    )
    for pos in ([3.5, 7.5], [3.0, 7.5], [3.5, 7.0], [3.0, 7.0]):
        ht, hd, d = jax.jit(
            lambda p: raycast.cast_rays_crossing(
                words, (cfg.H, cfg.W), p, dirs
            )
        )(jnp.asarray(pos, jnp.float32))
        ht, hd, d = np.asarray(ht), np.asarray(hd), np.asarray(d)
        assert np.isfinite(d).all(), (pos, d)
        assert (d > 0).all(), (pos, d)
        assert (ht[:, 0] >= 0).all() and (ht[:, 0] < cfg.H).all()
        assert (ht[:, 1] >= 0).all() and (ht[:, 1] < cfg.W).all()


def test_auto_backend_shape_dispatch():
    """'auto' is XLA crossing for every shape, dtype and heading mode — the
    choice depends on the config, never on the platform; explicit choices
    are never overridden; removed kernel backends are rejected."""
    for kw in (
        dict(num_rays=512),
        dict(num_rays=256),
        dict(num_rays=64),
        dict(num_rays=512, height_tile_map_tu=64, width_tile_map_tu=64),
        dict(num_rays=512, dtype="float64"),
        dict(num_rays=512, continuous_heading=True),
    ):
        assert rcw.EnvConfig(**kw).resolved_raycast_backend == "crossing", kw
    for explicit in ("scan", "scan_flat", "crossing", "analytic"):
        assert (
            rcw.EnvConfig(raycast_backend=explicit).resolved_raycast_backend
            == explicit
        )
    for removed in ("crossing_kernel", "crossing_kernel_fused", "pallas",
                    "fused"):
        with pytest.raises(ValueError, match="raycast_backend"):
            rcw.EnvConfig(raycast_backend=removed)

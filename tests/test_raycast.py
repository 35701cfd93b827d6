"""DDA raycaster tests: hand-computed rays + geometric property checks
(coverage the reference lacks; SURVEY.md section 4 implications)."""

import jax
import jax.numpy as jnp
import numpy as np

from raycastworlds_tpu.config import EnvConfig
from raycastworlds_tpu.ops import raycast


def _room(h=8, w=16):
    m = np.zeros((h, w), dtype=bool)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    return m


def _cast(obstacle, pos, dirs, steps=24):
    from raycastworlds_tpu.ops import bitmap

    shape = obstacle.shape
    return jax.jit(
        lambda o, p, d: raycast.cast_rays_scan(
            bitmap.pack_bits(o), shape, p, d, steps
        )
    )(jnp.asarray(obstacle), jnp.asarray(pos, jnp.float32), jnp.asarray(dirs, jnp.float32))


def test_axis_aligned_rays():
    room = _room()
    pos = np.array([4.5, 8.5], np.float32)
    dirs = np.array(
        [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], np.float32
    )
    hit_tu, hit_dim, dist = map(np.asarray, _cast(room, pos, dirs))
    # +i ray: hits wall row 7 at distance 7.0 - 4.5 = 2.5
    np.testing.assert_array_equal(hit_tu[0], [7, 8])
    assert hit_dim[0] == 0
    np.testing.assert_allclose(dist[0], 2.5)
    # -i ray: wall row 0, boundary at 1.0, distance 3.5
    np.testing.assert_array_equal(hit_tu[1], [0, 8])
    assert hit_dim[1] == 0
    np.testing.assert_allclose(dist[1], 3.5)
    # +j ray: wall col 15, boundary at 15.0, distance 6.5
    np.testing.assert_array_equal(hit_tu[2], [4, 15])
    assert hit_dim[2] == 1
    np.testing.assert_allclose(dist[2], 6.5)
    # -j ray: wall col 0, boundary at 1.0, distance 7.5
    np.testing.assert_array_equal(hit_tu[3], [4, 0])
    assert hit_dim[3] == 1
    np.testing.assert_allclose(dist[3], 7.5)


def test_diagonal_ray():
    room = _room(8, 8)
    pos = np.array([4.5, 4.5], np.float32)
    s = 1 / np.sqrt(2, dtype=np.float32)
    dirs = np.array([[s, s]], np.float32)
    hit_tu, hit_dim, dist = map(np.asarray, _cast(room, pos, dirs))
    # marches diagonally; both sides tie -> steps j first (strict <),
    # crossings at 0.5*sqrt(2), ..., wall reached at tile (6,7) or (7,6)
    assert room[hit_tu[0, 0], hit_tu[0, 1]]
    # distance along ray to the hit face: boundary j=7 at t=2.5*sqrt(2)
    np.testing.assert_allclose(dist[0], 2.5 * np.sqrt(2), rtol=1e-6)


def test_interior_obstacle():
    room = _room(8, 8)
    room[4, 6] = True
    pos = np.array([4.5, 4.5], np.float32)
    dirs = np.array([[0.0, 1.0]], np.float32)
    hit_tu, hit_dim, dist = map(np.asarray, _cast(room, pos, dirs))
    np.testing.assert_array_equal(hit_tu[0], [4, 6])
    assert hit_dim[0] == 1
    np.testing.assert_allclose(dist[0], 1.5)


def test_hit_point_lies_on_tile_face():
    """Property: pos + dist*dir lands on the boundary of the hit tile, on a
    gridline perpendicular to hit_dim."""
    cfg = EnvConfig(num_rays=64)
    room = _room()
    rng = np.random.RandomState(3)
    pos = np.array([1.0 + 6.0 * rng.rand(), 1.0 + 14.0 * rng.rand()], np.float32)
    dirs_j = jax.jit(lambda d: raycast.ray_fan(cfg, d))(
        jnp.asarray([np.cos(0.7), np.sin(0.7)], jnp.float32)
    )
    hit_tu, hit_dim, dist = map(np.asarray, _cast(room, pos, dirs_j))
    dirs = np.asarray(dirs_j)
    p_hit = pos[None, :] + dist[:, None] * dirs
    for r in range(cfg.num_rays):
        axis = hit_dim[r]
        # the hit coordinate is an integer gridline adjacent to the hit tile
        coord = p_hit[r, axis]
        assert abs(coord - round(coord)) < 1e-4, (r, p_hit[r], hit_tu[r])
        gridline = round(coord)
        assert gridline in (hit_tu[r, axis], hit_tu[r, axis] + 1)
        # the hit tile is an obstacle
        assert room[hit_tu[r, 0], hit_tu[r, 1]]
        # distances are positive and bounded by map diagonal
        assert 0 < dist[r] < np.hypot(8, 16)


def test_ray_fan_geometry():
    cfg = EnvConfig(num_rays=512)
    d = jnp.asarray([1.0, 0.0], jnp.float32)
    dirs = np.asarray(jax.jit(lambda x: raycast.ray_fan(cfg, x))(d))
    # all normalized
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, rtol=1e-5)
    # first ray tilted toward -90 rotation of d = (0,-1): (1, -s)/|..|
    s = cfg.semi_field_of_view_wu
    exp_first = np.array([1.0, -s]) / np.hypot(1, s)
    np.testing.assert_allclose(dirs[0], exp_first, rtol=1e-5)
    exp_last = np.array([1.0, s]) / np.hypot(1, s)
    np.testing.assert_allclose(dirs[-1], exp_last, rtol=1e-5)
    # middle ray is the player direction
    np.testing.assert_allclose(dirs[cfg.num_rays // 2 - 1 + 1], [1, 0], atol=2e-3)
    # fan is symmetric: dirs[i,1] == -dirs[R-1-i,1]
    np.testing.assert_allclose(dirs[:, 1], -dirs[::-1, 1], atol=1e-6)


def test_analytic_backend_matches_dda():
    """SingleRoom closed-form raycaster vs the scan DDA: identical hit tiles
    and faces, distances to float32 rounding."""
    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.ops import raycast_analytic

    cfg = EnvConfig(num_rays=128, height_camera_view_pu=32)
    game = rcw.SingleRoom(cfg)
    cast_dda = jax.jit(game.cast_single)
    cast_an = jax.jit(
        lambda s: raycast_analytic.cast_rays_analytic(
            cfg, s.goal_tu, s.pos_wu, s.dir_au
        )
    )
    key = jax.random.PRNGKey(2)
    for i in range(6):
        key, k = jax.random.split(key)
        state = jax.jit(game.reset_single)(k)
        # also exercise off-center positions
        state = state.replace(
            pos_wu=state.pos_wu + jnp.float32(0.0625 * (i % 3))
        )
        a = cast_dda(state)
        b = cast_an(state)
        np.testing.assert_array_equal(np.asarray(a.hit_tu), np.asarray(b.hit_tu))
        np.testing.assert_array_equal(np.asarray(a.hit_dim), np.asarray(b.hit_dim))
        np.testing.assert_allclose(
            np.asarray(a.dist_wu), np.asarray(b.dist_wu), rtol=2e-6, atol=2e-6
        )


def test_flat_batched_scan_bit_exact_vs_vmapped():
    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.ops import bitmap

    cfg = EnvConfig(num_rays=48, height_camera_view_pu=32)
    game = rcw.SingleRoom(cfg)
    keys = jax.random.split(jax.random.PRNGKey(8), 16)
    state = jax.jit(jax.vmap(game.reset_single))(keys)
    a = jax.jit(jax.vmap(game.cast_single))(state)  # per-env scan
    b = jax.jit(game.cast_batch)(state)             # flat batched scan
    np.testing.assert_array_equal(np.asarray(a.hit_tu), np.asarray(b.hit_tu))
    np.testing.assert_array_equal(np.asarray(a.hit_dim), np.asarray(b.hit_dim))
    np.testing.assert_array_equal(np.asarray(a.dist_wu), np.asarray(b.dist_wu))

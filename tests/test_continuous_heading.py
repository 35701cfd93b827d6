"""Continuous-heading opt-in variant (no reference equivalent; the
reference's headings are integer angle units, single_room.jl:46)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.config import TURN_LEFT, MOVE_FORWARD


CFG = rcw.EnvConfig(
    num_rays=32, height_camera_view_pu=32, continuous_heading=True,
    turn_increment_au=0.7,
)


def test_requires_general_backend():
    with pytest.raises(ValueError, match="continuous_heading"):
        rcw.EnvConfig(continuous_heading=True, raycast_backend="analytic")
    with pytest.raises(ValueError, match="turn_increment_au"):
        rcw.EnvConfig(continuous_heading=True, turn_increment_au=0.0)


def test_float_heading_and_fractional_turns():
    game = rcw.SingleRoom(CFG)
    state = jax.jit(game.reset_single)(jax.random.PRNGKey(0))
    d0 = np.asarray(state.dir_au)
    assert d0.dtype == np.float32
    assert 0.0 <= float(d0) < CFG.num_directions

    step = jax.jit(game.step_single)
    turned = step(state, jnp.int32(TURN_LEFT))
    assert float(turned.dir_au) == pytest.approx(
        (float(d0) + 0.7) % CFG.num_directions, abs=1e-5
    )

    # moving forward translates along (cos, sin) of the heading angle
    moved = step(state, jnp.int32(MOVE_FORWARD))
    delta = np.asarray(moved.pos_wu) - np.asarray(state.pos_wu)
    ang = float(d0) * 2 * np.pi / CFG.num_directions
    expect = 0.125 * np.array([np.cos(ang), np.sin(ang)])
    blocked = np.allclose(delta, 0)  # wall/goal contact is legal
    assert blocked or np.allclose(delta, expect, atol=1e-6)


def test_env_rollout_and_determinism():
    env = rcw.Env(rcw.SingleRoom(CFG), num_envs=8)
    key = jax.random.PRNGKey(3)

    def run():
        state, obs = env.reset(key)
        for t in range(10):
            res = env.step(state, env.sample_action(jax.random.PRNGKey(t)))
            state = res.state
        return np.asarray(res.obs), np.asarray(state.dir_au)

    obs1, d1 = run()
    obs2, d2 = run()
    np.testing.assert_array_equal(obs1, obs2)
    np.testing.assert_array_equal(d1, d2)
    assert d1.dtype == np.float32
    # after random turns, headings are genuinely fractional
    assert np.any(np.abs(d1 - np.round(d1)) > 1e-3)


@pytest.mark.parametrize("backend", ["crossing", "scan"])
def test_continuous_obs_sane_on_maze(backend):
    cfg = rcw.MazeConfig(
        num_rays=24, height_camera_view_pu=24, continuous_heading=True,
        raycast_backend=backend,
    )
    env = rcw.Env(rcw.Maze(cfg), num_envs=4)
    state, obs = env.reset(jax.random.PRNGKey(1))
    res = env.step(state, jnp.full(4, TURN_LEFT, jnp.int32))
    img = np.asarray(res.obs)
    assert img.shape == (4, 24, 24)
    # frames contain ceiling, floor and at least one wall shade
    from raycastworlds_tpu import colors

    present = set(np.unique(img).tolist())
    assert colors.CEILING in present and colors.FLOOR in present
    assert present & {colors.WALL_DIM_I, colors.WALL_DIM_J}


@pytest.mark.parametrize("seed", [0, 6])
def test_continuous_parity_vs_scalar_oracle(seed):
    """Fixed-seed trajectory parity vs the scalar continuous-heading oracle
    (oracle/families.OracleContinuous): bit-exact positions, float headings,
    rewards, dones and camera frames — lifting the continuous mode to the
    same parity tier as the discrete families."""
    from raycastworlds_tpu.oracle import parity

    parity.continuous(seed).assert_exact()


def test_depth_obs_continuous():
    cfg = rcw.config.replace(CFG, obs_type="depth")
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=4)
    state, obs = env.reset(jax.random.PRNGKey(0))
    d = np.asarray(obs)
    assert d.shape == (4, 32)
    assert np.isfinite(d).all() and (d > 0).all()

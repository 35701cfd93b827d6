"""LockedRoom family: two-stage key-then-goal task (round 5).

Parity vs the scalar OracleLockedRoom (fixed-seed trajectories + camera
frames), reset invariants (goal/key/spawn placement relative to the door
line), and the door-unlock mechanics (doors block and render blue until the
key is collected, then vanish; the goal is unreachable before the key)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.oracle import parity
from raycastworlds_tpu.ops import bitmap


def _cfg(**kw):
    kw.setdefault("num_rays", 32)
    kw.setdefault("height_camera_view_pu", 24)
    return rcw.LockedRoomConfig(**kw)


def test_reset_invariants():
    cfg = _cfg()
    game = rcw.LockedRoom(cfg)
    dc = cfg.resolved_door_col
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    state = jax.jit(jax.vmap(game.reset_single))(keys)
    goal = np.asarray(state.goal_tu)
    keyt = np.asarray(state.key_tu)
    spawn = np.floor(np.asarray(state.pos_wu)).astype(int)
    assert (goal[:, 1] > dc).all(), "goal right of the door line"
    assert (keyt[:, 1] < dc).all(), "key left of the door line"
    assert (spawn[:, 1] < dc).all(), "spawn left of the door line"
    assert not (spawn == keyt).all(axis=1).any(), "spawn not on the key"
    assert (goal[:, 0] >= 1).all() and (goal[:, 0] <= cfg.H - 2).all()
    assert not np.asarray(state.key_held).any()


def test_key_unlocks_doors():
    cfg = _cfg()
    game = rcw.LockedRoom(cfg)
    env = rcw.Env(game, num_envs=1, auto_reset=False)
    state, _ = env.reset(jax.random.PRNGKey(1))
    dc = cfg.resolved_door_col
    qd = cfg.num_directions // 4  # heading +y (toward larger j)

    # place the player just left of the door line, facing it: blocked
    state = state.replace(
        pos_wu=jnp.asarray([[3.0 + 0.5, dc - 1 + 0.5]], jnp.float32),
        dir_au=jnp.full((1,), qd, jnp.int32),
        key_held=jnp.zeros((1,), bool),
        key_tu=jnp.asarray([[1, 1]], jnp.int32),
        goal_tu=jnp.asarray([[3, dc + 1]], jnp.int32),
    )
    pos0 = np.asarray(state.pos_wu).copy()
    for _ in range(4):
        res = env.step(state, jnp.zeros(1, jnp.int32))
        state = res.state
    # blocked at the door face: the circle (r = 0.125) never crosses into
    # the door column
    assert np.asarray(state.pos_wu)[0, 1] <= dc - 0.124, "door blocks"
    assert float(res.reward[0]) == 0.0 and not bool(res.done[0])

    # same pose with the key held: walks through the door column and
    # terminates on the goal behind it
    state = state.replace(
        pos_wu=jnp.asarray(pos0), key_held=jnp.ones((1,), bool)
    )
    got_reward = False
    for _ in range(16):
        res = env.step(state, jnp.zeros(1, jnp.int32))
        state = res.state
        if bool(res.done[0]):
            got_reward = float(res.reward[0]) == cfg.goal_reward
            break
    assert got_reward, "goal reached through the open door"


def test_key_collection_rule():
    """Key contact collects, pays 0, does not terminate, blocks the move
    that step (goal-blocks-entry applied to the key), and removes the key
    from the obstacle field."""
    cfg = _cfg()
    game = rcw.LockedRoom(cfg)
    env = rcw.Env(game, num_envs=1, auto_reset=False)
    state, _ = env.reset(jax.random.PRNGKey(2))
    qd = cfg.num_directions // 4
    state = state.replace(
        pos_wu=jnp.asarray([[2.5, 2.8]], jnp.float32),
        dir_au=jnp.full((1,), qd, jnp.int32),
        key_tu=jnp.asarray([[2, 4]], jnp.int32),
        key_held=jnp.zeros((1,), bool),
    )
    collected_at = None
    for t in range(12):
        pos_before = np.asarray(state.pos_wu).copy()
        res = env.step(state, jnp.zeros(1, jnp.int32))
        state = res.state
        assert float(res.reward[0]) == 0.0
        assert not bool(res.done[0])
        if bool(state.key_held[0]) and collected_at is None:
            collected_at = t
            # the collecting step did not move the player
            np.testing.assert_array_equal(
                np.asarray(state.pos_wu), pos_before
            )
    assert collected_at is not None, "key collected walking into it"
    # obstacle words no longer contain the key or door bits
    _, obst = game._packed_maps_batch(state)
    dense = np.asarray(bitmap.unpack_bits(obst[0], (cfg.H, cfg.W)))
    assert not dense[2, 4], "key bit gone"
    assert not dense[1:-1, cfg.resolved_door_col].any(), "door bits gone"


@pytest.mark.parametrize("seed", [0, 5])
def test_locked_room_parity(seed):
    """Fixed-seed trajectory + camera parity vs the scalar oracle, across
    key collection and door opening."""
    parity.locked_room(seed).assert_exact()


def test_locked_room_pal8_and_env_rollout():
    """pal8 decode losslessness + the batched Env rollout contract."""
    from raycastworlds_tpu import colors

    base = _cfg()
    g32 = rcw.LockedRoom(dataclasses.replace(base, obs_type="camera_u32"))
    gp8 = rcw.LockedRoom(dataclasses.replace(base, obs_type="camera_pal8"))
    st = jax.jit(jax.vmap(g32.reset_single))(
        jax.random.split(jax.random.PRNGKey(3), 8)
    )
    a = np.asarray(jax.jit(jax.vmap(g32.observe_single))(st))
    b = np.asarray(jax.jit(jax.vmap(gp8.observe_single))(st))
    np.testing.assert_array_equal(colors.pal8_to_u32_np(b), a)

    env = rcw.Env(rcw.LockedRoom(base), num_envs=8)
    state, obs = env.reset(jax.random.PRNGKey(4))
    for t in range(5):
        res = env.step(state, env.sample_action(jax.random.fold_in(
            jax.random.PRNGKey(9), t
        )))
        state = res.state
    assert np.isfinite(np.asarray(res.reward)).all()


def test_config_validation_locked():
    with pytest.raises(ValueError, match="door_col"):
        _cfg(door_col=1)
    with pytest.raises(ValueError, match="width"):
        rcw.LockedRoomConfig(width_tile_map_tu=4, num_rays=16)
    assert _cfg(width_tile_map_tu=9).resolved_door_col == 4

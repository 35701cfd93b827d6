"""EnvState as a registered frozen dataclass: pytree structure, ``replace``,
the static ``hw`` aux data, vmap/jit, and the optional per-family fields."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.state import EnvState


def _state(game=None):
    game = game or rcw.SingleRoom(
        rcw.EnvConfig(num_rays=16, height_camera_view_pu=16)
    )
    return jax.jit(game.reset_single)(jax.random.PRNGKey(0))


def test_flatten_round_trip():
    s = _state()
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 10  # the extension fields are None: no leaves
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, EnvState)
    assert back.hw == s.hw
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        assert a is b


def test_replace_returns_new_frozen_state():
    s = _state()
    s2 = s.replace(dir_au=jnp.int32(5), t=jnp.int32(3))
    assert int(s2.dir_au) == 5 and int(s2.t) == 3
    assert int(s.t) == 0  # original untouched
    assert s2.hw == s.hw
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.t = jnp.int32(1)


def test_hw_is_static_aux_data():
    s = _state()
    treedef = jax.tree_util.tree_structure(s)
    assert all(
        isinstance(x, jax.Array) for x in jax.tree_util.tree_leaves(s)
    )
    assert str(s.hw) in str(treedef)
    other = s.replace(hw=(s.hw[0], s.hw[1] + 1))
    assert jax.tree_util.tree_structure(other) != treedef

    @jax.jit
    def read_hw(st):
        # hw stays a Python tuple under tracing (usable as a static shape)
        assert isinstance(st.hw, tuple)
        return st.wall_map.shape

    assert read_hw(s) == s.hw


def test_vmap_over_batched_state():
    game = rcw.SingleRoom(rcw.EnvConfig(num_rays=16, height_camera_view_pu=16))
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    batch = jax.jit(jax.vmap(game.reset_single))(keys)
    assert batch.batch_shape == (6,)
    assert batch.hw == (8, 16)
    stepped = jax.jit(jax.vmap(game.step_single))(
        batch, jnp.zeros(6, jnp.int32)
    )
    assert isinstance(stepped, EnvState)
    np.testing.assert_array_equal(np.asarray(stepped.t), np.ones(6))


def test_optional_fields_none_or_arrays():
    s = _state()
    assert s.goal_words is None and s.blocks is None and s.key_tu is None
    locked = _state(rcw.LockedRoom(
        rcw.LockedRoomConfig(num_rays=16, height_camera_view_pu=16)
    ))
    assert locked.key_tu is not None and locked.key_held is not None
    n = len(jax.tree_util.tree_leaves(locked))
    assert n == len(jax.tree_util.tree_leaves(s)) + 2
    moved = jax.tree_util.tree_map(lambda x: x, locked)
    assert moved.key_tu.shape == (2,)

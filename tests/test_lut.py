"""Heading-LUT row lookup (ops/lut.take_rows): a plain gather, bit-equal to
NumPy indexing, with no matrix product anywhere in its program (a float32
matmul may run in TF32 on a GPU and round the table entries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.ops import lut


@pytest.mark.parametrize(
    "num_directions,num_rays",
    [(128, 64), (128, 512), (64, 256), (7, 2), (360, 33)],
)
def test_ray_fan_rows_bit_equal_numpy(num_directions, num_rays):
    cfg = rcw.EnvConfig(num_directions=num_directions, num_rays=num_rays)
    table = cfg.ray_fan_lut
    idx = np.random.RandomState(num_rays).randint(
        0, num_directions, size=(5, 3)
    ).astype(np.int32)
    got = jax.jit(lut.take_rows)(jnp.asarray(table), jnp.asarray(idx))
    assert got.shape == (5, 3, num_rays, 2)
    np.testing.assert_array_equal(np.asarray(got), table[idx])


def test_direction_rows_bit_equal_numpy_every_heading():
    cfg = rcw.EnvConfig()
    idx = np.arange(cfg.num_directions, dtype=np.int32)
    got = jax.jit(jax.vmap(lambda i: lut.take_rows(
        jnp.asarray(cfg.directions_wu), i
    )))(jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), cfg.directions_wu[idx])


def _primitives(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn.primitive.name
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _primitives(sub)


def test_take_rows_has_no_dot_general():
    cfg = rcw.EnvConfig(num_rays=64)
    table = jnp.asarray(cfg.ray_fan_lut)
    jaxpr = jax.make_jaxpr(jax.vmap(lambda i: lut.take_rows(table, i)))(
        jnp.zeros((8,), jnp.int32)
    ).jaxpr
    prims = set(_primitives(jaxpr))
    assert "dot_general" not in prims
    assert "gather" in prims


def test_env_step_has_no_dot_general_on_the_heading_path():
    """The whole SingleRoom step (move, collide, cast, render) runs without
    a matrix product: every float the parity depends on is exact."""
    game = rcw.SingleRoom(rcw.EnvConfig(num_rays=16, height_camera_view_pu=16))
    env = rcw.Env(game, num_envs=4, jit=False)
    state, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    jaxpr = jax.make_jaxpr(
        lambda s, a: jax.vmap(game.step_single)(s, a)
    )(state, jnp.zeros(4, jnp.int32)).jaxpr
    assert "dot_general" not in set(_primitives(jaxpr))
    jaxpr = jax.make_jaxpr(game.observe_batch)(state).jaxpr
    assert "dot_general" not in set(_primitives(jaxpr))

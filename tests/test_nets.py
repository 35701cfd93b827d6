"""Plain-JAX actor-critic networks (parallel/nets.py): parameter-tree names
per trunk (``ppo.param_shardings`` keys on them), shapes, the GRU carry,
float32 outputs under bfloat16 compute, and finite gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raycastworlds_tpu.parallel.nets import (
    ActorCritic,
    RecurrentActorCritic,
    gru,
    gru_init,
)
from raycastworlds_tpu.parallel.ppo import param_shardings
from raycastworlds_tpu.parallel import mesh as mesh_lib

IMG = jnp.ones((3, 16, 16, 1), jnp.float32)


@pytest.mark.parametrize(
    "trunk,names",
    [
        ("conv", {"Conv_0", "Conv_1", "trunk", "policy", "value"}),
        ("patch", {"patch", "trunk", "policy", "value"}),
        ("mlp", {"trunk", "trunk2", "policy", "value"}),
    ],
)
def test_param_tree_names(trunk, names):
    net = ActorCritic(num_actions=4, hidden=32, trunk=trunk)
    params = net.init(jax.random.PRNGKey(0), IMG)
    assert set(params["params"]) == names
    for layer in params["params"].values():
        assert set(layer) == {"kernel", "bias"}
    assert params["params"]["trunk"]["kernel"].shape[1] == 32
    assert params["params"]["policy"]["kernel"].shape == (32, 4)
    assert params["params"]["value"]["kernel"].shape == (32, 1)
    logits, value = net.apply(params, IMG)
    assert logits.shape == (3, 4) and value.shape == (3,)


def test_trunk_input_widths():
    """Each trunk's first dense layer sees the flattened feature map."""
    want = {"conv": 4 * 4 * 32, "patch": 2 * 2 * 64, "mlp": 16 * 16 * 1}
    for trunk, width in want.items():
        p = ActorCritic(hidden=8, trunk=trunk).init(jax.random.PRNGKey(0), IMG)
        assert p["params"]["trunk"]["kernel"].shape == (width, 8), trunk


def test_vector_observations_skip_the_pixel_trunk():
    x = jnp.ones((5, 24), jnp.float32)
    net = ActorCritic(hidden=16, trunk="conv")
    p = net.init(jax.random.PRNGKey(0), x)
    assert set(p["params"]) == {"trunk", "policy", "value"}
    assert p["params"]["trunk"]["kernel"].shape == (24, 16)


@pytest.mark.parametrize("trunk", ["conv", "patch", "mlp"])
def test_recurrent_param_tree_and_carry(trunk):
    net = RecurrentActorCritic(num_actions=4, hidden=32, trunk=trunk)
    h = jnp.zeros((3, 32), jnp.float32)
    params = net.init(jax.random.PRNGKey(0), IMG, h)
    p = params["params"]
    assert {"embed", "gru", "policy", "value"} <= set(p)
    assert set(p["gru"]) == {"ir", "iz", "in", "hr", "hz", "hn"}
    assert set(p["gru"]["hr"]) == {"kernel"}
    assert set(p["gru"]["hn"]) == {"kernel", "bias"}
    logits, value, h2 = net.apply(params, IMG, h)
    assert logits.shape == (3, 4) and value.shape == (3,)
    assert h2.shape == (3, 32) and h2.dtype == jnp.float32


def test_gru_cell_matches_hand_formula():
    p = gru_init(jax.random.PRNGKey(3), 5, 4)
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 5))
    h = jax.random.normal(jax.random.PRNGKey(5), (2, 4))
    hp = jax.tree_util.tree_map(np.asarray, p)
    xn, hn = np.asarray(x), np.asarray(h)

    def lin(q, v):
        return v @ q["kernel"] + q.get("bias", 0.0)

    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    r = sig(lin(hp["ir"], xn) + lin(hp["hr"], hn))
    z = sig(lin(hp["iz"], xn) + lin(hp["hz"], hn))
    n = np.tanh(lin(hp["in"], xn) + r * lin(hp["hn"], hn))
    want = (1 - z) * n + z * hn
    with jax.default_matmul_precision("highest"):
        got = gru(p, h, x, jnp.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("recurrent", [False, True])
def test_bf16_compute_returns_f32_with_f32_params(recurrent):
    if recurrent:
        net = RecurrentActorCritic(hidden=16, dtype=jnp.bfloat16, trunk="mlp")
        h = jnp.zeros((3, 16), jnp.float32)
        params = net.init(jax.random.PRNGKey(0), IMG, h)
        outs = net.apply(params, IMG, h)
    else:
        net = ActorCritic(hidden=16, dtype=jnp.bfloat16, trunk="patch")
        params = net.init(jax.random.PRNGKey(0), IMG)
        outs = net.apply(params, IMG)
    assert all(
        leaf.dtype == jnp.float32 for leaf in jax.tree_util.tree_leaves(params)
    )
    assert all(o.dtype == jnp.float32 for o in outs)


@pytest.mark.parametrize("recurrent", [False, True])
def test_gradients_finite_and_nonzero(recurrent):
    x = jax.random.uniform(jax.random.PRNGKey(1), IMG.shape)
    if recurrent:
        net = RecurrentActorCritic(hidden=16, trunk="conv")
        h = jnp.ones((3, 16), jnp.float32) * 0.1
        params = net.init(jax.random.PRNGKey(0), x, h)

        def loss(p):
            logits, value, h2 = net.apply(p, x, h)
            return jnp.sum(logits ** 2) + jnp.sum(value) + jnp.sum(h2)
    else:
        net = ActorCritic(hidden=16, trunk="conv")
        params = net.init(jax.random.PRNGKey(0), x)

        def loss(p):
            logits, value = net.apply(p, x)
            return jnp.sum(logits ** 2) + jnp.sum(value)

    grads = jax.grad(loss)(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in leaves)
    assert all(float(jnp.max(jnp.abs(g))) > 0 for g in leaves)


def test_param_shardings_follow_layer_names():
    mesh = mesh_lib.make_mesh(dp=4, mp=2)
    params = ActorCritic(hidden=32, trunk="mlp").init(
        jax.random.PRNGKey(0), IMG
    )
    sh = param_shardings(params, mesh)["params"]
    assert sh["trunk"]["kernel"].spec == jax.sharding.PartitionSpec(None, "mp")
    assert sh["trunk"]["bias"].spec == jax.sharding.PartitionSpec("mp")
    assert sh["policy"]["kernel"].spec == jax.sharding.PartitionSpec("mp", None)
    assert sh["value"]["kernel"].spec == jax.sharding.PartitionSpec("mp", None)
    assert sh["trunk2"]["kernel"].spec == jax.sharding.PartitionSpec()

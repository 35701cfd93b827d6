"""PPO learner tests: GAE math, single-device smoke, full SPMD train step on
the virtual 8-device mesh (dp x mp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.parallel import mesh as mesh_lib
from raycastworlds_tpu.parallel.ppo import (
    PPOConfig,
    PPOTrainer,
    compute_gae,
    preprocess_obs,
)


def test_gae_hand_computed():
    # T=3, B=1, no terminations
    reward = jnp.array([[1.0], [0.0], [2.0]])
    value = jnp.array([[0.5], [0.25], [1.0]])
    done = jnp.zeros((3, 1), bool)
    last_value = jnp.array([2.0])
    gamma, lam = 0.9, 0.8
    adv, target = compute_gae(reward, value, done, last_value, gamma, lam)
    # manual backward recursion
    d2 = 2.0 + 0.9 * 2.0 - 1.0          # 2.8
    a2 = d2
    d1 = 0.0 + 0.9 * 1.0 - 0.25         # 0.65
    a1 = d1 + 0.9 * 0.8 * a2            # 0.65 + .72*2.8
    d0 = 1.0 + 0.9 * 0.25 - 0.5         # 0.725
    a0 = d0 + 0.9 * 0.8 * a1
    np.testing.assert_allclose(
        np.asarray(adv)[:, 0], [a0, a1, a2], rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(target), np.asarray(adv + value), rtol=1e-6
    )


def test_gae_respects_termination():
    reward = jnp.array([[1.0], [1.0]])
    value = jnp.array([[0.0], [0.0]])
    done = jnp.array([[True], [False]])
    last_value = jnp.array([5.0])
    adv, _ = compute_gae(reward, value, done, last_value, 0.9, 0.8)
    # step0 is terminal: no bootstrap from step1's value or beyond
    a1 = 1.0 + 0.9 * 5.0
    a0 = 1.0  # delta only, next value masked
    np.testing.assert_allclose(np.asarray(adv)[:, 0], [a0, a1], rtol=1e-6)


def test_preprocess_shapes():
    cfg = rcw.EnvConfig(num_rays=16, height_camera_view_pu=16)
    obs = jnp.zeros((2, 16, 16), jnp.uint32)
    assert preprocess_obs(cfg, obs).shape == (2, 16, 16, 3)
    cfg_d = rcw.EnvConfig(num_rays=16, obs_type="depth")
    assert preprocess_obs(cfg_d, jnp.zeros((2, 16))).shape == (2, 16)


def test_train_step_single_device():
    cfg = rcw.EnvConfig(num_rays=16, height_camera_view_pu=16, obs_type="camera_gray")
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8, jit=False)
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=8, num_epochs=1, num_minibatches=2),
        hidden=32,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    ts2, metrics = trainer.train_step(ts)
    assert int(ts2.update_count) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # params actually changed
    leaves0 = jax.tree_util.tree_leaves(ts.params)
    leaves1 = jax.tree_util.tree_leaves(ts2.params)
    assert any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(leaves0, leaves1)
    )


def test_train_step_patch_trunk_bf16():
    """The throughput trunk (8x8 patch embed) in bf16 compute: train step
    runs, metrics finite, params move, logits come back f32."""
    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8, jit=False)
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=8, num_epochs=1, num_minibatches=2),
        hidden=32,
        dtype=jnp.bfloat16,
        trunk="patch",
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    # params are created f32 (mixed precision: bf16 compute only)
    assert all(
        leaf.dtype == jnp.float32
        for leaf in jax.tree_util.tree_leaves(ts.params)
    )
    assert any(
        "patch" in jax.tree_util.keystr(path)
        for path, _ in jax.tree_util.tree_leaves_with_path(ts.params)
    )
    ts2, metrics = trainer.train_step(ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    leaves0 = jax.tree_util.tree_leaves(ts.params)
    leaves1 = jax.tree_util.tree_leaves(ts2.params)
    assert any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(leaves0, leaves1)
    )


def test_train_step_sharded_dp_mp():
    """Full SPMD train step over a (dp=4, mp=2) mesh: envs sharded over dp,
    trunk tensor-parallel over mp."""
    cfg = rcw.EnvConfig(num_rays=16, height_camera_view_pu=16, obs_type="camera_gray")
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8, jit=False)
    m = mesh_lib.make_mesh(dp=4, mp=2)
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2),
        mesh=m,
        hidden=64,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    # trunk kernel is sharded over mp
    trunk_kernel = ts.params["params"]["trunk"]["kernel"]
    assert len(trunk_kernel.sharding.device_set) >= 2
    ts2, metrics = trainer.train_step(ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # env state remains dp-sharded after the step
    assert len(ts2.env_state.pos_wu.sharding.device_set) >= 4


def test_train_step_hlo_has_no_data_collectives():
    """The dp-local minibatch shuffle must not move rollout data across
    devices: the compiled train step may contain all-reduces (gradient and
    metric psums) but NO all-to-all / all-gather / collective-permute."""
    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=16, jit=False)
    m = mesh_lib.make_mesh(dp=8, mp=1)
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2),
        mesh=m,
        hidden=32,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    txt = jax.jit(trainer._train_step_impl).lower(ts).compile().as_text()
    for coll in ("all-to-all", "all-gather", "collective-permute"):
        assert coll not in txt, f"unexpected {coll} in compiled train step"


def test_multi_agent_train_step():
    """MultiPlayerRoom trains first-class: one parameter-shared policy over
    the folded [B*P] batch, per-player GAE with the episode-level done
    broadcast, finite losses, and per-player actions driving the env."""
    cfg = rcw.MultiPlayerConfig(
        num_players=2, num_rays=16, height_camera_view_pu=16,
        obs_type="camera_gray",
    )
    env = rcw.Env(rcw.MultiPlayerRoom(cfg), num_envs=8)
    trainer = PPOTrainer(env, PPOConfig(rollout_steps=4, num_minibatches=2))
    assert trainer.num_players == 2
    ts = trainer.init(jax.random.PRNGKey(0))
    for _ in range(2):
        ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["entropy"]))
    # the policy net is single-agent shaped: folding, not a P-headed net
    x = jnp.zeros((3, 16, 16, 1), jnp.float32)
    logits, value = trainer.net.apply(ts.params, x)
    assert logits.shape == (3, 4) and value.shape == (3,)


def test_multi_agent_train_step_sharded():
    """Same, under the virtual 8-device dp mesh."""
    mesh = mesh_lib.make_mesh()
    cfg = rcw.MultiPlayerConfig(
        num_players=2, num_rays=16, height_camera_view_pu=16,
        obs_type="camera_gray",
    )
    env = rcw.Env(rcw.MultiPlayerRoom(cfg), num_envs=16)
    trainer = PPOTrainer(
        env, PPOConfig(rollout_steps=4, num_minibatches=2), mesh=mesh
    )
    ts = trainer.init(jax.random.PRNGKey(1))
    ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_recurrent_ppo_train_step():
    """GRU actor-critic: rollout carries hidden state (reset on done), the
    update replays sequences per env-axis minibatch, losses finite, and the
    hidden state actually changes the policy output."""
    from raycastworlds_tpu.parallel.ppo_rnn import (
        RecurrentActorCritic,
        RecurrentPPOTrainer,
    )

    cfg = rcw.MazeConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
        height_tile_map_tu=9, width_tile_map_tu=9,
    )
    env = rcw.Env(rcw.Maze(cfg), num_envs=8)
    trainer = RecurrentPPOTrainer(
        env, PPOConfig(rollout_steps=6, num_minibatches=2), hidden=32
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    assert ts.hidden.shape == (8, 32)
    for _ in range(2):
        ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))
    assert int(ts.update_count) == 2
    # memory matters: same frame, different hidden -> different logits
    net = trainer.net
    x = jnp.ones((1, 16, 16, 1), jnp.float32)
    h0 = jnp.zeros((1, 32), jnp.float32)
    h1 = jnp.ones((1, 32), jnp.float32)
    l0, v0, _ = net.apply(ts.params, x, h0)
    l1, v1, _ = net.apply(ts.params, x, h1)
    assert not np.allclose(np.asarray(l0), np.asarray(l1))


def test_recurrent_ppo_rejects_multi_player():
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.MultiPlayerConfig(
        num_players=2, num_rays=16, height_camera_view_pu=16,
        obs_type="camera_gray",
    )
    env = rcw.Env(rcw.MultiPlayerRoom(cfg), num_envs=4)
    import pytest

    with pytest.raises(ValueError, match="single-agent"):
        RecurrentPPOTrainer(env)


def test_recurrent_train_step_sharded_dp():
    """GRU trainer over the virtual 8-device dp mesh: env state + hidden
    carry sharded, params replicated, finite metrics, shardings preserved
    across the step."""
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.MazeConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
        height_tile_map_tu=9, width_tile_map_tu=9,
    )
    env = rcw.Env(rcw.Maze(cfg), num_envs=16, jit=False)
    m = mesh_lib.make_mesh(dp=8, mp=1)
    trainer = RecurrentPPOTrainer(
        env, PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2),
        hidden=32, mesh=m,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    assert len(ts.env_state.pos_wu.sharding.device_set) == 8
    assert len(ts.hidden.sharding.device_set) == 8
    ts2, metrics = trainer.train_step(ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert len(ts2.env_state.pos_wu.sharding.device_set) == 8
    assert len(ts2.hidden.sharding.device_set) == 8
    assert int(ts2.update_count) == 1


def test_recurrent_train_step_hlo_has_no_data_collectives():
    """The recurrent dp-local shuffle must keep rollout data shard-local:
    gradient/metric all-reduces only, no all-to-all / all-gather /
    collective-permute in the compiled train step."""
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=16, jit=False)
    m = mesh_lib.make_mesh(dp=8, mp=1)
    trainer = RecurrentPPOTrainer(
        env, PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2),
        hidden=32, mesh=m,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    txt = jax.jit(trainer._train_step_impl).lower(ts).compile().as_text()
    for coll in ("all-to-all", "all-gather", "collective-permute"):
        assert coll not in txt, f"unexpected {coll} in compiled train step"


def test_recurrent_mesh_divisibility_checks():
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    m = mesh_lib.make_mesh(dp=8, mp=1)
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=12, jit=False)
    with pytest.raises(ValueError, match="dp"):
        RecurrentPPOTrainer(env, mesh=m)
    # divides by dp but the per-shard batch (1) not by num_minibatches (4)
    env2 = rcw.Env(rcw.SingleRoom(cfg), num_envs=8, jit=False)
    with pytest.raises(ValueError, match="num_minibatches"):
        RecurrentPPOTrainer(env2, mesh=m)


def test_mlp_trunk_trains():
    """The flat-pixel mlp trunk (the max-throughput trunk)
    trains with finite losses and has the expected two hidden layers."""
    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8)
    trainer = PPOTrainer(
        env, PPOConfig(rollout_steps=4, num_minibatches=2), trunk="mlp",
        hidden=32,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    assert "trunk2" in ts.params["params"]
    assert ts.params["params"]["trunk"]["kernel"].shape == (16 * 16, 32)
    ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_mlp_trunk_recurrent_trains():
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8)
    trainer = RecurrentPPOTrainer(
        env, PPOConfig(rollout_steps=4, num_minibatches=2), trunk="mlp",
        hidden=32,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    ts, metrics = trainer.train_step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_trainer_success_rate_metric():
    """Both trainers report a [0, 1] goal-reach rate among finished
    episodes (0 when nothing finished)."""
    from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
        max_episode_steps=2,  # force truncations -> episodes finish
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=8)
    for make in (
        lambda: PPOTrainer(
            env, PPOConfig(rollout_steps=4, num_minibatches=2), hidden=32
        ),
        lambda: RecurrentPPOTrainer(
            env, PPOConfig(rollout_steps=4, num_minibatches=2), hidden=32
        ),
    ):
        trainer = make()
        ts = trainer.init(jax.random.PRNGKey(0))
        ts, metrics = trainer.train_step(ts)
        sr = float(metrics["success_rate"])
        assert 0.0 <= sr <= 1.0
        assert float(metrics["episodes_finished"]) > 0  # truncations fired

"""Worker process for the real multi-process distributed test.

Launched by tests/test_distributed.py as N separate OS processes, each with
its own 2-device virtual CPU backend, joined through
``jax.distributed.initialize`` (localhost coordinator, Gloo CPU collectives) —
the standard way to exercise the multi-host code path
(parallel/mesh.py:initialize_distributed) without a GPU cluster.  The reference
has no distributed layer at all (SURVEY.md §2); this validates the greenfield
one end-to-end: global (dp, mp) mesh spanning processes, env batch sharded
over dp, a rollout stepping SPMD, and one tensor-parallel PPO update whose
gradient psums ride the cross-process collectives.

Each worker writes its addressable shards of the final env state plus scalar
training metrics to an .npz; the pytest driver assembles the shards and
compares them against a single-process run of the identical program —
bit-exact for env state (the env step has no cross-env collectives, so
reduction order cannot perturb it), tolerance-checked for the PPO metrics
(Gloo vs local psum may reorder float sums).
"""

from __future__ import annotations

import os
import sys


def main() -> None:
    proc_id = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]
    devs_per_proc = int(sys.argv[5])

    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs_per_proc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np
    import jax.numpy as jnp

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel import mesh as mesh_lib
    from raycastworlds_tpu.parallel.ppo import (
        ActorCritic,
        PPOConfig,
        PPOTrainer,
        param_shardings,
        preprocess_obs,
    )

    if nproc > 1:
        mesh_lib.initialize_distributed(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc,
            process_id=proc_id,
        )

    n_global = nproc * devs_per_proc
    mp = 2 if n_global % 2 == 0 and n_global >= 4 else 1
    mesh = mesh_lib.make_mesh(dp=n_global // mp, mp=mp)
    repl = mesh_lib.replicated(mesh)
    dp_sh = mesh_lib.env_sharding(mesh)

    cfg = rcw.EnvConfig(
        num_rays=16, height_camera_view_pu=16, obs_type="camera_gray"
    )
    num_envs = 4 * n_global
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=num_envs, jit=False)

    # Replicated global key (identical host value on every process).
    key = jax.device_put(jax.random.PRNGKey(0), repl)

    reset = jax.jit(env._reset_impl, out_shardings=dp_sh)
    state, obs = reset(key)

    # --- sharded rollout: T random steps SPMD over the global mesh --------
    def rollout(state, key):
        def body(carry, _):
            st, k = carry
            k, ka = jax.random.split(k)
            a = jax.random.randint(
                ka, (num_envs,), 0, 4, dtype=jnp.int32
            )
            res = env._step_impl(st, a)
            return (res.state, k), jnp.sum(res.reward)

        (st, _), rews = jax.lax.scan(body, (state, key), None, length=8)
        return st, jnp.sum(rews)

    roll = jax.jit(
        rollout, out_shardings=(dp_sh, repl), donate_argnums=(0,)
    )
    state, total_reward = roll(state, jax.device_put(jax.random.PRNGKey(7), repl))

    # --- one PPO train step with tensor-parallel trunk over mp ------------
    trainer = PPOTrainer(
        env,
        PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2),
        mesh=mesh,
        hidden=32,
    )
    # Multiprocess-safe init: params built from a host-side sample (identical
    # on every process), placed onto the global mesh explicitly.
    sample = np.zeros((1,) + cfg.obs_shape, np.float32)
    params = trainer.net.init(
        jax.random.PRNGKey(1), preprocess_obs(cfg, jnp.asarray(sample))
    )
    p_sh = param_shardings(params, mesh)
    params = jax.tree_util.tree_map(jax.device_put, params, p_sh)
    opt_state = jax.jit(
        trainer.tx.init,
        out_shardings=jax.tree_util.tree_map(lambda _: repl, jax.eval_shape(trainer.tx.init, params)),
    )(params)

    from raycastworlds_tpu.parallel.ppo import TrainState

    ts = TrainState(
        params=params,
        opt_state=opt_state,
        env_state=state,
        key=jax.device_put(jax.random.PRNGKey(2), repl),
        update_count=jax.device_put(jnp.int32(0), repl),
    )
    ts, metrics = jax.jit(trainer._train_step_impl)(ts)
    metrics = {k: float(np.asarray(v)) for k, v in metrics.items()}
    metrics["total_reward"] = float(np.asarray(total_reward))

    # --- dump this process's addressable shards of the final env state ----
    out = {}
    for name in ("pos_wu", "dir_au", "goal_tu", "rng_key", "t", "wall_words"):
        leaf = getattr(ts.env_state, name)
        for s in leaf.addressable_shards:
            start = s.index[0].start or 0
            out[f"{name}/{start}"] = np.asarray(s.data)
    for k, v in metrics.items():
        out[f"metric/{k}"] = np.float64(v)
    np.savez(os.path.join(outdir, f"worker{proc_id}.npz"), **out)
    print(f"worker {proc_id}/{nproc} ok: devices={n_global}")


if __name__ == "__main__":
    main()

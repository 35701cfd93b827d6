"""Phase-level profile of the PPO train step.

The env alone does tens of M steps/s; what an RL user sustains is the FULL
train step.  This driver decomposes one bench_ppo configuration into
independently-jitted phases and ablations so the time goes somewhere
nameable:

  full          — the production one-program train step
  rollout       — _rollout_phase alone (env + inference + GAE)
  update        — _update_phase alone (epochs x minibatches on a captured
                  rollout)
  env_only      — the rollout scan with a constant action (no network)
  infer_only    — T policy inferences on a fixed obs batch (no env)
  update_1ep    — update with num_epochs=1 (epoch-count scaling)
  update_noshuf — update with the permutation replaced by identity
                  (isolates the [T*B]-row gather cost)
  grad_mb       — one jitted grad step on one minibatch (loss fwd+bwd only)

Usage: python examples/profile_ppo.py [--num-envs 2048 ...] (bench_ppo flags)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from raycastworlds_tpu.utils.compile_cache import enable_compile_cache


def timeit(fn, *args, reps=4):
    """Median wall time of fn(*args); each rep ends with a host read of one
    result, which waits for the whole program."""
    import numpy as np

    out = fn(*args)
    jax.block_until_ready(out)
    _ = float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
    times = []
    for _r in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_gray")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--trunk", type=str, default="patch")
    p.add_argument("--backend", type=str, default="")
    args = p.parse_args()
    if args.backend:
        jax.config.update("jax_platforms", args.backend)
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel.ppo import PPOConfig, PPOTrainer
    from raycastworlds_tpu.parallel.rollout import rollout_policy

    cfg = rcw.EnvConfig(
        num_rays=args.num_rays, height_camera_view_pu=args.height_px,
        obs_type=args.obs,
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=args.num_envs, jit=False)
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    trainer = PPOTrainer(
        env, PPOConfig(rollout_steps=args.rollout_steps),
        hidden=args.hidden, dtype=dtype, trunk=args.trunk,
    )
    ts = trainer.init(jax.random.PRNGKey(0))
    steps = args.num_envs * args.rollout_steps
    res = {}

    # full train step
    t = timeit(lambda s: trainer.train_step(s)[1]["loss"], ts)
    res["full"] = t

    # rollout phase
    k = jax.random.PRNGKey(1)
    roll = jax.jit(
        lambda s, k: trainer._rollout_phase(s, k)[4]["reward_per_step"]
    )
    res["rollout"] = timeit(roll, ts, k)

    # captured rollout for update-phase timing
    env_state, traj, adv, target, _aux = jax.jit(trainer._rollout_phase)(
        ts, k
    )
    upd = jax.jit(
        lambda p, o, k, tr, a, tg: trainer._update_phase(p, o, k, tr, a, tg)[
            2
        ]["loss"]
    )
    res["update"] = timeit(upd, ts.params, ts.opt_state, k, traj, adv, target)

    # env-only rollout: constant action, no network
    def const_policy(obs, key):
        b = obs.shape[0]
        return (
            jnp.zeros((b,), jnp.int32),
            jnp.zeros((b,), jnp.float32),
            jnp.zeros((b,), jnp.float32),
        )

    env_only = jax.jit(
        lambda s, k: rollout_policy(
            env, const_policy, s, k, args.rollout_steps
        )[1].reward.sum()
    )
    res["env_only"] = timeit(env_only, ts.env_state, k)

    # inference-only: T chained policy evals on a fixed batch (carry the
    # value so the chain can't collapse)
    from raycastworlds_tpu.parallel.ppo import make_policy_fn, preprocess_obs

    obs0 = jax.jit(env.game.observe_batch)(ts.env_state)
    policy = make_policy_fn(trainer.net, cfg, ts.params)

    def infer_loop(obs, key):
        def body(carry, k):
            a, lp, v = policy(obs, k)
            return carry + v.sum(), None

        acc, _ = jax.lax.scan(
            body, jnp.float32(0),
            jax.random.split(key, args.rollout_steps),
        )
        return acc

    res["infer_only"] = timeit(jax.jit(infer_loop), obs0, k)

    # update scaling ablations
    tr1 = PPOTrainer(
        env, PPOConfig(rollout_steps=args.rollout_steps, num_epochs=1),
        hidden=args.hidden, dtype=dtype, trunk=args.trunk,
    )
    upd1 = jax.jit(
        lambda p, o, k, tr, a, tg: tr1._update_phase(p, o, k, tr, a, tg)[2][
            "loss"
        ]
    )
    res["update_1ep"] = timeit(
        upd1, ts.params, ts.opt_state, k, traj, adv, target
    )

    trainer._identity_shuffle = True
    upd_ns = jax.jit(
        lambda p, o, k, tr, a, tg: trainer._update_phase(p, o, k, tr, a, tg)[
            2
        ]["loss"]
    )
    res["update_noshuf"] = timeit(
        upd_ns, ts.params, ts.opt_state, k, traj, adv, target
    )
    trainer._identity_shuffle = False

    # one minibatch grad step
    import optax
    from raycastworlds_tpu.parallel.ppo import ppo_loss

    n = args.rollout_steps * args.num_envs
    mb = n // trainer.cfg.num_minibatches

    def flatten(x):
        return x.reshape((n,) + x.shape[2:])[:mb]

    batch = {
        "obs": flatten(traj.obs),
        "action": flatten(traj.action),
        "log_prob": flatten(traj.log_prob),
        "advantage": flatten(adv),
        "target": flatten(target),
    }

    def grad_mb(params, batch):
        g, m = jax.grad(
            lambda p: ppo_loss(trainer.net, cfg, trainer.cfg, p, batch),
            has_aux=True,
        )(params)
        return m["loss"]

    res["grad_mb"] = timeit(jax.jit(grad_mb), ts.params, batch)

    n_grad_steps = trainer.cfg.num_epochs * trainer.cfg.num_minibatches
    out = {
        "config": vars(args),
        "env_steps_per_update": steps,
        "times_ms": {k: round(v * 1e3, 2) for k, v in res.items()},
        "sps": {
            k: round(steps / v) for k, v in res.items()
            if k in ("full", "rollout", "update", "env_only")
        },
        "derived_ms": {
            "inference_in_rollout": round(
                1e3 * (res["rollout"] - res["env_only"]), 2
            ),
            "shuffle_gather": round(
                1e3 * (res["update"] - res["update_noshuf"]), 2
            ),
            "grad_steps_total_est": round(1e3 * n_grad_steps * res["grad_mb"], 2),
            "phase_sum_vs_full": round(
                1e3 * (res["rollout"] + res["update"] - res["full"]), 2
            ),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""End-to-end training throughput: PPO learner in the loop (BASELINE
config 5 shape, single host).

Measures env-steps/s through the FULL train step — on-device rollout with
policy inference per step, GAE, clipped PPO epochs — i.e. what an RL user
actually sustains, not just the env.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

from raycastworlds_tpu.utils.compile_cache import enable_compile_cache


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--updates", type=int, default=8, help="timed updates")
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_gray")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="network compute dtype (params stay float32)")
    p.add_argument("--trunk", type=str, default="conv",
                   choices=["conv", "patch", "mlp"],
                   help="image trunk: overlapping convs, 8x8 patch embed, "
                        "or flat pixel MLP (max throughput)")
    p.add_argument("--game", type=str, default="single_room",
                   choices=["single_room", "multi_player", "maze"])
    p.add_argument("--num-players", type=int, default=2,
                   help="players per env (multi_player; one shared policy)")
    p.add_argument("--recurrent", action="store_true",
                   help="GRU actor-critic (parallel/ppo_rnn.py)")
    p.add_argument("--epochs", type=int, default=0,
                   help="override PPO epochs (0 = PPOConfig default)")
    p.add_argument("--phases", action="store_true",
                   help="additionally time rollout/update phases separately "
                        "(feedforward trainer only)")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--backend", type=str, default="")
    args = p.parse_args()
    enable_compile_cache()

    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel import mesh as mesh_lib
    from raycastworlds_tpu.parallel.ppo import PPOConfig, PPOTrainer

    kw = dict(
        num_rays=args.num_rays,
        height_camera_view_pu=args.height_px,
        obs_type=args.obs,
    )
    if args.game == "multi_player":
        game = rcw.MultiPlayerRoom(
            rcw.MultiPlayerConfig(num_players=args.num_players, **kw)
        )
    elif args.game == "maze":
        game = rcw.Maze(
            rcw.MazeConfig(
                height_tile_map_tu=17, width_tile_map_tu=17, **kw
            )
        )
    else:
        game = rcw.SingleRoom(rcw.EnvConfig(**kw))
    env = rcw.Env(game, num_envs=args.num_envs, jit=False)
    import jax.numpy as jnp

    ppo_cfg = PPOConfig(rollout_steps=args.rollout_steps)
    if args.epochs:
        ppo_cfg = ppo_cfg._replace(num_epochs=args.epochs)
    net_dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    if args.recurrent:
        from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

        trainer = RecurrentPPOTrainer(
            env, ppo_cfg,
            mesh=mesh_lib.make_mesh() if args.mesh else None,
            hidden=args.hidden, dtype=net_dtype, trunk=args.trunk,
        )
    else:
        trainer = PPOTrainer(
            env, ppo_cfg,
            mesh=mesh_lib.make_mesh() if args.mesh else None,
            hidden=args.hidden,
            dtype=net_dtype,
            trunk=args.trunk,
        )
    ts = trainer.init(jax.random.PRNGKey(0))
    ts, metrics = trainer.train_step(ts)  # compile
    float(metrics["loss"])

    t0 = time.perf_counter()
    for _ in range(args.updates):
        ts, metrics = trainer.train_step(ts)
    float(metrics["loss"])
    dt = time.perf_counter() - t0

    steps = args.num_envs * args.rollout_steps * args.updates
    sps = steps / dt

    phases = None
    if args.phases and not args.recurrent:
        k = jax.random.PRNGKey(1)
        roll = jax.jit(
            lambda s, k: trainer._rollout_phase(s, k)[4]["reward_per_step"]
        )
        upd = jax.jit(
            lambda p, o, k, tr, a, tg: trainer._update_phase(
                p, o, k, tr, a, tg
            )[2]["loss"]
        )
        _, traj, adv, target, _ = jax.jit(trainer._rollout_phase)(ts, k)

        def t_of(fn, *a, reps=3):
            float(jax.numpy.asarray(fn(*a)))
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                float(jax.numpy.asarray(fn(*a)))
                times.append(time.perf_counter() - t0)
            return sorted(times)[len(times) // 2]

        per = args.num_envs * args.rollout_steps
        phases = {
            "rollout_ms": round(1e3 * t_of(roll, ts, k), 2),
            "update_ms": round(
                1e3 * t_of(
                    upd, ts.params, ts.opt_state, k, traj, adv, target
                ), 2,
            ),
        }
        phases["rollout_sps"] = round(per / (phases["rollout_ms"] / 1e3))
        phases["update_sps"] = round(per / (phases["update_ms"] / 1e3))

    out = {
        "metric": "ppo_env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s (through full PPO train step)",
        "vs_baseline": round(sps / 1e7, 4),
        "config": {
            "game": args.game,
            "num_players": (
                args.num_players if args.game == "multi_player" else 1
            ),
            "num_envs": args.num_envs,
            "rollout_steps": args.rollout_steps,
            "obs": args.obs,
            "hidden": args.hidden,
            "dtype": args.dtype,
            "trunk": args.trunk,
            "recurrent": args.recurrent,
            "num_epochs": ppo_cfg.num_epochs,
            "device": str(jax.devices()[0]),
            "n_devices": len(jax.devices()) if args.mesh else 1,
        },
        "seconds": round(dt, 3),
    }
    if phases:
        out["phases"] = phases
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Scaling-efficiency benchmark: fixed per-device env count, 1 device vs N.

BASELINE target: >= 80% scaling efficiency from 1 host to N hosts.  On a
multi-host slice, run this once per host under ``jax.distributed`` (see
raycastworlds_tpu.parallel.mesh.initialize_distributed); on a single machine
it measures weak scaling over the local devices (or a virtual CPU mesh with
``--backend cpu`` + XLA_FLAGS=--xla_force_host_platform_device_count=N).

Prints one JSON line: per-device and aggregate steps/s for 1 device and for
all N, plus the weak-scaling efficiency.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

from raycastworlds_tpu.utils.compile_cache import enable_compile_cache


def measure(env, state, steps, reps=3):
    from raycastworlds_tpu.parallel.rollout import steps_per_second_program

    run = jax.jit(steps_per_second_program(env, steps))
    key = jax.random.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)  # sync
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        state, acc = run(state, jax.random.fold_in(key, r))
        float(acc)
        best = min(best, time.perf_counter() - t0)
    return env.num_envs * steps / best


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs-per-device", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--game", type=str, default="single_room")
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--reset-budget", type=int, default=0,
                   help="budgeted auto-reset PER DEVICE SHARD scale (scaled "
                        "by N for the N-device env)")
    p.add_argument("--map-h", type=int, default=0)
    p.add_argument("--map-w", type=int, default=0)
    p.add_argument("--backend", type=str, default="")
    args = p.parse_args()
    enable_compile_cache()

    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from bench import build_env
    from raycastworlds_tpu.parallel import mesh as mesh_lib

    n = len(jax.devices())

    def make(num_envs, budget):
        return build_env(
            game=args.game, num_envs=num_envs, num_rays=args.num_rays,
            height_px=args.height_px, obs=args.obs, map_h=args.map_h,
            map_w=args.map_w, reset_budget=budget,
        )

    # 1 device
    env1 = make(args.envs_per_device, args.reset_budget)
    state1, _ = jax.jit(env1._reset_impl)(jax.random.PRNGKey(0))
    state1 = jax.device_put(state1, jax.devices()[0])
    sps1 = measure(env1, state1, args.steps)

    result = {
        "metric": "scaling_efficiency",
        "devices": n,
        "config": {
            "game": args.game,
            "obs": args.obs,
            "envs_per_device": args.envs_per_device,
            "num_rays": args.num_rays,
            "height_px": args.height_px,
            "backend": str(jax.devices()[0].platform),
        },
        "steps_per_sec_1dev": round(sps1, 1),
    }

    if n > 1:
        envN = make(args.envs_per_device * n, args.reset_budget * n)
        stateN, _ = jax.jit(envN._reset_impl)(jax.random.PRNGKey(0))
        mesh = mesh_lib.make_mesh()
        stateN = mesh_lib.shard_env_state(stateN, mesh)
        spsN = measure(envN, stateN, args.steps)
        eff = spsN / (sps1 * n)
        result.update(
            {
                "steps_per_sec_Ndev": round(spsN, 1),
                "value": round(eff, 4),
                "unit": "weak-scaling efficiency (1.0 = linear)",
                "vs_baseline": round(eff / 0.8, 4),
            }
        )
    else:
        result.update(
            {
                "value": 1.0,
                "unit": "single device (no scaling measured)",
                "vs_baseline": 1.0,
            }
        )
    print(json.dumps(result))


if __name__ == "__main__":
    main()

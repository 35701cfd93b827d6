"""Throughput benchmark: batched env-steps/s with camera-view observations.

Run with NO arguments it benches the whole BASELINE table — one row per
BASELINE.json config plus per-family rows — and prints ONE JSON line whose
headline ``value`` is the flagship row (SingleRoom 4096 envs, 64 rays x 64
px) with every other row under ``rows``.  With any CLI flag present it
benches just that configuration (the diagnostic mode).

The reference publishes no numbers (BASELINE.md), so ``vs_baseline`` is
measured against the BASELINE.json north-star target of 10M env-steps/s
aggregate.

Prints ONE JSON line:
  {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
   "vs_baseline": N / 1e7, "rows": [...], ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

from raycastworlds_tpu.utils.compile_cache import enable_compile_cache


def build_env(
    game: str = "single_room",
    num_envs: int = 4096,
    num_rays: int = 64,
    height_px: int = 64,
    obs: str = "camera_u32",
    texture: str = "none",
    map_h: int = 0,
    map_w: int = 0,
    flood_iters: int = -1,
    reset_budget: int = 0,
    raycast: str = "auto",
):
    """Construct the benchmark Env for one workload row (shared with
    bench_scaling.py and chip_smoke.py).  ``raycast`` defaults to "auto",
    the dispatch users get with no flags."""
    import raycastworlds_tpu as rcw

    kw = dict(
        num_rays=num_rays,
        height_camera_view_pu=height_px,
        obs_type=obs,
        raycast_backend=raycast,
        wall_texture=texture,
    )
    if game == "single_room":
        if map_h:
            kw.update(height_tile_map_tu=map_h)
        if map_w:
            kw.update(width_tile_map_tu=map_w)
        cfg = rcw.EnvConfig(**kw)
        env_game = rcw.SingleRoom(cfg)
    elif game == "random_room":
        cfg = rcw.RandomRoomConfig(
            height_tile_map_tu=map_h or 16,
            width_tile_map_tu=map_w or 16,
            flood_iters=flood_iters,
            **kw,
        )
        env_game = rcw.RandomRoom(cfg)
    elif game == "multi_goal":
        if map_h:
            kw.update(height_tile_map_tu=map_h)
        if map_w:
            kw.update(width_tile_map_tu=map_w)
        cfg = rcw.MultiGoalConfig(**kw)
        env_game = rcw.MultiGoalRoom(cfg)
    elif game == "locked_room":
        if map_h:
            kw.update(height_tile_map_tu=map_h)
        if map_w:
            kw.update(width_tile_map_tu=map_w)
        cfg = rcw.LockedRoomConfig(**kw)
        env_game = rcw.LockedRoom(cfg)
    elif game == "dynamic_room":
        if map_h:
            kw.update(height_tile_map_tu=map_h)
        if map_w:
            kw.update(width_tile_map_tu=map_w)
        cfg = rcw.DynamicRoomConfig(**kw)
        env_game = rcw.DynamicRoom(cfg)
    elif game == "multi_player":
        if map_h:
            kw.update(height_tile_map_tu=map_h)
        if map_w:
            kw.update(width_tile_map_tu=map_w)
        cfg = rcw.MultiPlayerConfig(**kw)
        env_game = rcw.MultiPlayerRoom(cfg)
    elif game == "maze":
        cfg = rcw.MazeConfig(
            height_tile_map_tu=map_h or 17,
            width_tile_map_tu=map_w or 17,
            **kw,
        )
        env_game = rcw.Maze(cfg)
    else:
        raise ValueError(f"unknown game {game}")
    return rcw.Env(
        env_game, num_envs=num_envs, jit=False, reset_budget=reset_budget
    )


def run_one(
    game: str = "single_room",
    num_envs: int = 4096,
    num_rays: int = 64,
    height_px: int = 64,
    steps: int = 512,
    reps: int = 4,
    obs: str = "camera_u32",
    texture: str = "none",
    map_h: int = 0,
    map_w: int = 0,
    flood_iters: int = -1,
    reset_budget: int = 0,
    raycast: str = "auto",
) -> dict:
    """Benchmark one configuration; returns the result row dict."""
    from raycastworlds_tpu.parallel.rollout import steps_per_second_program

    env = build_env(
        game=game, num_envs=num_envs, num_rays=num_rays,
        height_px=height_px, obs=obs, texture=texture, map_h=map_h,
        map_w=map_w, flood_iters=flood_iters, reset_budget=reset_budget,
        raycast=raycast,
    )
    cfg = env.cfg

    state, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    run = jax.jit(steps_per_second_program(env, steps), donate_argnums=(0,))

    # warmup / compile.  The timed region ends with a host transfer of the
    # checksum scalar, which waits for the whole program.
    key = jax.random.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)

    times = []
    for r in range(reps):
        key = jax.random.fold_in(key, r)
        t0 = time.perf_counter()
        state, acc = run(state, key)
        float(acc)
        times.append(time.perf_counter() - t0)

    # Median rep, not best: with a handful of reps the minimum flatters one
    # lucky scheduling window; the median is stable.
    med = sorted(times)[len(times) // 2]
    sps = num_envs * steps / med

    return {
        "metric": "env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(sps / 1e7, 4),
        "config": {
            "game": game,
            "num_envs": num_envs,
            "num_rays": num_rays,
            "height_px": height_px,
            "obs": obs,
            "scan_steps": steps,
            "reset_budget": reset_budget,
            "device": str(jax.devices()[0]),
            "raycast_backend": cfg.raycast_backend,
            "resolved_backend": cfg.resolved_raycast_backend,
        },
        "times_s": [round(t, 4) for t in times],
        "checksum": float(acc),
    }


# The standing benchmark table: every BASELINE.json config that runs on one
# card, plus per-family rows.  (BASELINE configs 1 and 5 are not throughput
# rows: config 1 is the parity harness — tests/test_parity.py and
# chip_smoke.py's parity phase — and config 5 is the multi-card mesh path,
# chip_smoke.py --four-cards and bench_scaling.py.)
SUITE = [
    # name, kwargs
    ("flagship_single_room_4096", dict()),
    ("config2_single_room_1024", dict(num_envs=1024)),
    ("config3_random_16x16_rgb128", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_rgb", reset_budget=256, steps=128, reps=3)),
    ("config3_u32_variant", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_u32", reset_budget=256, steps=128, reps=3)),
    ("config4_maze_32k", dict(
        game="maze", num_envs=32768, reset_budget=512, steps=256, reps=3)),
    ("multi_goal_8192", dict(game="multi_goal", num_envs=8192, reps=3)),
    ("dynamic_room_8192", dict(game="dynamic_room", num_envs=8192, reps=3)),
    ("locked_room_8192", dict(game="locked_room", num_envs=8192, reps=3)),
    ("ref_default_res_512x256", dict(
        num_envs=1024, num_rays=512, height_px=256, steps=128, reps=3)),
    ("single_room_48x48_map", dict(
        map_h=48, map_w=48, reps=3)),
    ("single_room_32k", dict(num_envs=32768, reps=3)),
    ("multi_player_2p_4096", dict(
        game="multi_player", num_envs=4096, reps=3)),
    # 1-byte lossless palette-index observations: 1/4 the obs bytes of
    # camera_u32 on the three headline shapes.
    ("flagship_pal8_4096", dict(obs="camera_pal8")),
    ("config3_pal8", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_pal8", reset_budget=256, steps=128, reps=3)),
    ("ref_default_res_pal8", dict(
        num_envs=1024, num_rays=512, height_px=256, obs="camera_pal8",
        steps=128, reps=3)),
]


def run_ppo_row(
    name: str = "ppo_train_step_mlp_bf16",
    trunk: str = "mlp",
    obs: str = "camera_gray",
    num_envs: int = 2048,
    num_epochs: int = 0,
    recurrent: bool = False,
) -> dict:
    """Learner-in-the-loop row: env-steps/s through the FULL PPO train step
    (rollout + GAE + clipped update, one SPMD program).  The default is the
    throughput trunk (flat pixel mlp, bf16 compute)."""
    import time as _time

    import jax.numpy as jnp

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel.ppo import PPOConfig, PPOTrainer

    rollout_steps, updates = 64, 6
    cfg = rcw.EnvConfig(
        num_rays=64, height_camera_view_pu=64, obs_type=obs
    )
    env = rcw.Env(rcw.SingleRoom(cfg), num_envs=num_envs, jit=False)
    ppo_cfg = PPOConfig(rollout_steps=rollout_steps)
    if num_epochs:
        ppo_cfg = ppo_cfg._replace(num_epochs=num_epochs)
    if recurrent:
        from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer

        trainer = RecurrentPPOTrainer(
            env, ppo_cfg, hidden=256, dtype=jnp.bfloat16, trunk=trunk
        )
    else:
        trainer = PPOTrainer(
            env, ppo_cfg, hidden=256, dtype=jnp.bfloat16, trunk=trunk,
        )
    ts = trainer.init(jax.random.PRNGKey(0))
    ts, metrics = trainer.train_step(ts)  # compile
    float(metrics["loss"])
    t0 = _time.perf_counter()
    for _ in range(updates):
        ts, metrics = trainer.train_step(ts)
    float(metrics["loss"])
    dt = _time.perf_counter() - t0
    sps = num_envs * rollout_steps * updates / dt
    return {
        "name": name,
        "metric": "ppo_env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s (through full PPO train step)",
        "config": {
            "num_envs": num_envs, "rollout_steps": rollout_steps,
            "obs": obs, "hidden": 256, "dtype": "bfloat16",
            "trunk": trunk, "recurrent": recurrent,
            "num_epochs": ppo_cfg.num_epochs,
            "device": str(jax.devices()[0]),
        },
        "seconds": round(dt, 3),
    }


def run_suite() -> None:
    rows = []
    for name, kw in SUITE:
        try:
            row = run_one(**kw)
            row["name"] = name
            rows.append(row)
        except Exception as e:  # record the failure, keep the table
            rows.append({"name": name, "error": f"{type(e).__name__}: {e}"})
        print(
            f"# {name}: "
            + (
                f"{rows[-1]['value']:.0f} steps/s"
                if "value" in rows[-1]
                else rows[-1].get("error", "?")
            ),
            file=sys.stderr,
        )
    ppo_rows = [
        # default learner config (mlp trunk, bf16, 2 epochs)
        dict(name="ppo_train_step_mlp_bf16"),
        # max-throughput preset (1-byte luma obs, 1 epoch, 4096 envs)
        dict(
            name="ppo_train_step_throughput", obs="camera_gray_u8",
            num_envs=4096, num_epochs=1,
        ),
        # recurrent GRU trainer (first-class since round 4; benched round 5)
        dict(name="ppo_train_step_recurrent_gru", recurrent=True),
    ]
    for kw in ppo_rows:
        try:
            rows.append(run_ppo_row(**kw))
        except Exception as e:
            rows.append({
                "name": kw["name"],
                "error": f"{type(e).__name__}: {e}",
            })
        print(
            f"# {kw['name']}: "
            + (
                f"{rows[-1]['value']:.0f} steps/s"
                if "value" in rows[-1]
                else rows[-1].get("error", "?")
            ),
            file=sys.stderr,
        )
    head = rows[0] if rows and "value" in rows[0] else {}
    # `summary` is deliberately the LAST key: json.dumps preserves insertion
    # order, so a tail-capture of this line (the driver records the final
    # ~2000 chars) always keeps every row's headline number even when the
    # full per-row detail above it is truncated.
    summary = {}
    for row in rows:
        if "value" in row:
            summary[row["name"]] = [row["value"]]
        else:
            summary[row["name"]] = row.get("error", "?")[:60]
    result = {
        "metric": "env_steps_per_sec",
        "value": head.get("value"),
        "unit": "steps/s",
        "vs_baseline": head.get("vs_baseline"),
        "config": head.get("config"),
        "times_s": head.get("times_s"),
        "checksum": head.get("checksum"),
        "rows": rows,
        "summary": summary,
    }
    print(json.dumps(result))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--steps", type=int, default=512, help="scan length per program run")
    p.add_argument("--reps", type=int, default=4, help="timed program executions")
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--game", type=str, default="single_room",
                   choices=["single_room", "random_room", "maze",
                            "multi_goal", "dynamic_room", "multi_player",
                            "locked_room"])
    p.add_argument("--texture", type=str, default="none",
                   help="wall texture: none|checker|brick|xor")
    p.add_argument("--map-h", type=int, default=0, help="override map height")
    p.add_argument("--map-w", type=int, default=0, help="override map width")
    p.add_argument("--flood-iters", type=int, default=-1, help="random_room reachability budget")
    p.add_argument("--reset-budget", type=int, default=0, help="budgeted auto-reset (0 = dense)")
    p.add_argument("--raycast", type=str, default="auto",
                   help="auto|crossing|scan|scan_flat|analytic")
    p.add_argument("--backend", type=str, default="", help="override jax_platforms")
    args = p.parse_args()

    if args.backend:
        jax.config.update("jax_platforms", args.backend)
    enable_compile_cache()

    if len(sys.argv) == 1:
        run_suite()
        return

    result = run_one(
        game=args.game,
        num_envs=args.num_envs,
        num_rays=args.num_rays,
        height_px=args.height_px,
        steps=args.steps,
        reps=args.reps,
        obs=args.obs,
        texture=args.texture,
        map_h=args.map_h,
        map_w=args.map_w,
        flood_iters=args.flood_iters,
        reset_budget=args.reset_budget,
        raycast=args.raycast,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()

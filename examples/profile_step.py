"""Named per-op device-time breakdown of one bench.py env workload.

Runs the bench.py rollout program (default: the flagship, 4096 envs x 64
rays x 64 px, dense auto-reset, random actions) under ``jax.profiler``, then
aggregates the GPU-side trace events by op name and prints the top offenders
with per-env-step costs.  The scan body repeats every op ``steps`` times, so
one program execution yields a stable per-op sample.

It also compiles one env step alone and prints its ``memory_analysis()``
and every buffer of at least one crossing-candidate array's size
(B x min(H, W) x R elements) that the compiled step materialises outside
a fusion: an empty list means the raycaster's [B, H+W, R] candidate
pipeline stays inside fusions.

Usage: python examples/profile_step.py [--num-envs 4096 --steps 64 ...]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import math
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from raycastworlds_tpu.utils.compile_cache import enable_compile_cache


def aggregate_trace(log_dir: str):
    """Sum device-side complete events by name from the Perfetto JSON the
    profiler writes (no tensorboard dependency)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**/*trace.json.gz"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(paths[-1]) as f:
        d = json.load(f)
    ev = d.get("traceEvents", [])
    pids = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
    agg, cnt = collections.Counter(), collections.Counter()
    for e in ev:
        if e.get("ph") == "X" and "/device:GPU" in pids.get(e["pid"], ""):
            agg[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    return agg, cnt


def large_buffers(hlo_text: str, min_elems: int):
    """(computation, instruction, shape) of every array of at least
    ``min_elems`` elements produced outside a fused computation, i.e. every
    such array the compiled program writes to device memory."""
    fused = set(re.findall(r"calls=%?([\w.\-]+)", hlo_text))
    out, comp = [], None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head:
            comp = head.group(1)
            continue
        if comp is None or comp in fused:
            continue
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = (\w+)\[([\d,]*)\]", line)
        if m and m.group(3):
            dims = [int(d) for d in m.group(3).split(",")]
            if math.prod(dims) >= min_elems:
                out.append((comp, m.group(1), f"{m.group(2)}{dims}"))
    return out


def step_memory(env):
    """Memory analysis of one compiled env step, and its large buffers."""
    import jax.numpy as jnp

    cfg = env.cfg
    state, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    action = jnp.zeros(
        (env.num_envs,) + getattr(env.game, "action_shape", ()), jnp.int32
    )
    compiled = jax.jit(env._step_impl).lower(state, action).compile()
    mem = compiled.memory_analysis()
    cand = env.num_envs * min(cfg.H, cfg.W) * cfg.num_rays
    return {
        "temp_bytes": mem.temp_size_in_bytes,
        "argument_bytes": mem.argument_size_in_bytes,
        "output_bytes": mem.output_size_in_bytes,
        "candidate_array_elems": cand,
        "buffers_at_least_candidate_size": [
            list(b) for b in large_buffers(compiled.as_text(), cand)
        ],
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--game", type=str, default="single_room")
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--raycast", type=str, default="auto")
    p.add_argument("--reset-budget", type=int, default=0)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace-dir", type=str, default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "traces", "step"))
    args = p.parse_args()
    enable_compile_cache()

    sys.path.insert(0, os.getcwd())
    from bench import build_env
    from raycastworlds_tpu.parallel.rollout import steps_per_second_program

    env = build_env(
        game=args.game, num_envs=args.num_envs, num_rays=args.num_rays,
        height_px=args.height_px, obs=args.obs, raycast=args.raycast,
        reset_budget=args.reset_budget,
    )
    state, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    run = jax.jit(steps_per_second_program(env, args.steps))
    key = jax.random.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)  # compile + settle

    shutil.rmtree(args.trace_dir, ignore_errors=True)
    jax.profiler.start_trace(args.trace_dir, create_perfetto_trace=True)
    state, acc = run(state, key)
    float(acc)
    jax.profiler.stop_trace()

    agg, cnt = aggregate_trace(args.trace_dir)
    # the outermost jit/while events double-count their children; drop them
    inner = {
        n: us for n, us in agg.items()
        if not (n.startswith("jit_") or n.startswith("while")
                or n in ("0", "1"))
    }
    tot_inner = sum(inner.values())
    denom = args.num_envs * args.steps
    rows = []
    for name, us in sorted(inner.items(), key=lambda kv: -kv[1])[: args.top]:
        rows.append({
            "op": name,
            "ms": round(us / 1e3, 3),
            "calls": cnt[name],
            "ns_per_env_step": round(us * 1e3 / denom, 3),
            "pct": round(100 * us / tot_inner, 1),
        })
    print(json.dumps({
        "device": jax.devices()[0].device_kind,
        "config": vars(args),
        "step_memory": step_memory(env),
        "total_inner_ms": round(tot_inner / 1e3, 2),
        "ns_per_env_step_total": round(tot_inner * 1e3 / denom, 2),
        "ops": rows,
    }, indent=1))


if __name__ == "__main__":
    main()

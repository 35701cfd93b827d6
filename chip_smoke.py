"""On-device smoke check of the main path on one NVIDIA GPU.

Runs, through the entry points users call:

* ``env``     — the bench.py workloads users run, through ``rcw.Env`` and
                the on-device rollout program: compile time, median
                env-steps/s, device memory, and sanity of what comes out;
* ``parity``  — the scalar-oracle comparisons and golden frames of the CPU
                test suite (oracle/parity.py), recomputed on the device;
* ``learner`` — three train steps of the PPO and recurrent PPO trainers.

With ``--four-cards`` it runs only the mesh path instead: the flagship and
config-3 rollouts dp-sharded over four cards against the single-card run
(bit-equal per env), and one PPO train step on dp=4 and dp=2 x mp=2 against
the single-card step.

It refuses to run (non-zero exit, no result line) when JAX finds no GPU.
The last line of its output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage:  python chip_smoke.py  |  python chip_smoke.py --four-cards
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import raycastworlds_tpu as rcw
from bench import SUITE, build_env
from raycastworlds_tpu.oracle import parity
from raycastworlds_tpu.parallel import mesh as mesh_lib
from raycastworlds_tpu.parallel.ppo import PPOConfig, PPOTrainer
from raycastworlds_tpu.parallel.ppo_rnn import RecurrentPPOTrainer
from raycastworlds_tpu.parallel.rollout import steps_per_second_program
from raycastworlds_tpu.utils.compile_cache import enable_compile_cache

# bench.py suite rows the env phase runs, at the suite's sizes.
ENV_WORKLOADS = (
    "flagship_single_room_4096",
    "config3_random_16x16_rgb128",
    "config4_maze_32k",
    "ref_default_res_pal8",
    "multi_player_2p_4096",
    "locked_room_8192",
)

# name -> (trainer kwargs and sizes) for the learner phase.
LEARNER_WORKLOADS = {
    "ppo_mlp_bf16": dict(obs="camera_gray", num_envs=2048),
    "ppo_throughput_gray_u8": dict(
        obs="camera_gray_u8", num_envs=4096, num_epochs=1
    ),
    "ppo_gru_maze": dict(obs="camera_gray", num_envs=2048, game="maze",
                         recurrent=True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes(device=None):
    """``peak_bytes_in_use`` of a device since the process started, or None
    where the backend keeps no statistics."""
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _suite_row(name: str):
    """(build_env kwargs, steps, reps) of a bench.py suite row."""
    kw = dict(dict(SUITE)[name])
    return kw, kw.pop("steps", 512), kw.pop("reps", 4)


def check(ok: bool, what) -> None:
    """Fail the run (unlike ``assert``, also under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


# -- phase env ---------------------------------------------------------------


def env_workload(name: str, *, num_envs=None, steps=None, reps=None,
                 **overrides) -> dict:
    """Compile and time the bench rollout program of one suite row, and
    check its output.  ``num_envs``/``steps``/``reps``/``overrides`` shrink
    the row (tests); by default it runs at the suite's size."""
    kw, row_steps, row_reps = _suite_row(name)
    steps = steps or row_steps
    reps = max(reps or row_reps, 3)
    if num_envs:
        kw["num_envs"] = num_envs
    kw.update(overrides)
    env = build_env(**kw)
    b = env.num_envs

    state, obs0 = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    want_shape = (b,) + tuple(env.observation_space.shape)
    check(obs0.shape == want_shape, (name, obs0.shape, want_shape))
    check(obs0.dtype == env.observation_space.dtype, (name, obs0.dtype))
    flat = obs0.reshape(obs0.shape[0], -1)
    nonconst = float(jnp.mean(jnp.any(flat != flat[:, :1], axis=1)))
    check(nonconst > 0.5,
          f"{name}: {nonconst:.3f} of reset frames non-constant")

    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    run = jax.jit(steps_per_second_program(env, steps), donate_argnums=(0,))
    compiled = run.lower(state, key).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()

    state, acc = compiled(state, key)
    float(acc)
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        state, acc = compiled(state, jax.random.fold_in(key, r))
        checksum = float(acc)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    check(math.isfinite(checksum), (name, checksum))
    # t counts steps since each env's last reset: below the steps run, the
    # env finished at least one episode.
    ended = float(jnp.mean(state.t < steps * (reps + 1)))
    check(ended > 0, f"{name}: no episode ended")
    return {
        "name": name,
        "num_envs": b,
        "steps": steps,
        "compile_s": compile_s,
        "times_s": times,
        "env_steps_per_s": b * steps / med,
        "checksum": checksum,
        "envs_with_ended_episode": ended,
        "nonconstant_frames": nonconst,
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "peak_bytes_in_use": peak_bytes(),
    }


def phase_env(workloads=ENV_WORKLOADS, **shrink) -> list:
    rows = []
    for name in workloads:
        row = env_workload(name, **shrink)
        log(f"env {name}: {json.dumps(row)}")
        rows.append(row)
    return rows


# -- phase parity ------------------------------------------------------------


def phase_parity(trajectories=None, golden=None) -> dict:
    """Every oracle comparison and golden frame.  The mismatch count of each
    check is printed; the phase fails unless every check is exact, the
    crossing distances excepted, which may differ by the GPU division's
    stated ulp bound (docs/PARITY.md)."""
    trajectories = list(parity.TRAJECTORIES) if trajectories is None else trajectories
    golden = sorted(parity.golden_games()) if golden is None else golden
    bounds = {"dist": parity.GPU_DIVIDE_ULP}
    results = {name: parity.TRAJECTORIES[name] for name in trajectories}
    results.update({
        f"golden[{name}]": (lambda name=name: parity.golden(name))
        for name in golden
    })
    counts, bad = {}, []
    for name, run in results.items():
        res = run()
        counts[name] = res.mismatches
        log(f"parity {name}: {json.dumps(res.mismatches)} "
            f"first={json.dumps(res.first_step)} "
            f"max_ulp={json.dumps(res.max_ulp)}")
        if not res.within(bounds):
            bad.append(name)
    check(not bad, f"parity beyond the stated bounds {bounds}: {bad}")
    return counts


# -- phase learner -----------------------------------------------------------


def _trainer(obs, num_envs, game="single_room", recurrent=False,
             num_epochs=0, num_minibatches=0, rollout_steps=64, hidden=256,
             dtype=jnp.bfloat16, trunk="mlp", size=64, mesh=None):
    kw = dict(num_rays=size, height_camera_view_pu=size, obs_type=obs)
    if game == "maze":
        env_game = rcw.Maze(rcw.MazeConfig(**kw))
    else:
        env_game = rcw.SingleRoom(rcw.EnvConfig(**kw))
    env = rcw.Env(env_game, num_envs=num_envs, jit=False)
    cfg = PPOConfig(rollout_steps=rollout_steps)
    if num_epochs:
        cfg = cfg._replace(num_epochs=num_epochs)
    if num_minibatches:
        cfg = cfg._replace(num_minibatches=num_minibatches)
    cls = RecurrentPPOTrainer if recurrent else PPOTrainer
    return cls(env, cfg, hidden=hidden, dtype=dtype, trunk=trunk, mesh=mesh)


def learner_workload(name: str, **kw) -> dict:
    """Three train steps: finite losses, params that move, env-steps/s over
    the two steps after the compiling one."""
    trainer = _trainer(**kw)
    ts0 = trainer.init(jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    ts, metrics = trainer.train_step(ts0)
    losses = [float(metrics["loss"])]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(2):
        ts, metrics = trainer.train_step(ts)
        losses.append(float(metrics["loss"]))
    dt = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses), (name, losses))
    moved = sum(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(ts0.params),
                        jax.tree_util.tree_leaves(ts.params))
    )
    check(moved > 0, f"{name}: params unchanged")
    env = trainer.env
    return {
        "name": name,
        "num_envs": env.num_envs,
        "rollout_steps": trainer.cfg.rollout_steps,
        "num_epochs": trainer.cfg.num_epochs,
        "first_step_s": first_s,
        "env_steps_per_s": 2 * env.num_envs * trainer.cfg.rollout_steps / dt,
        "losses": losses,
        "param_leaves_moved": moved,
        "peak_bytes_in_use": peak_bytes(),
    }


def phase_learner(workloads=None, **shrink) -> list:
    rows = []
    for name, kw in (workloads or LEARNER_WORKLOADS).items():
        row = learner_workload(name, **dict(kw, **shrink))
        log(f"learner {name}: {json.dumps(row)}")
        rows.append(row)
    return rows


# -- four cards --------------------------------------------------------------


def _final_state(env, state, steps, mesh=None):
    """The rollout program's final state on host, and its median time over
    three runs from the same start."""
    run = jax.jit(steps_per_second_program(env, steps))
    key = jax.random.PRNGKey(1)
    if mesh is not None:
        state = mesh_lib.shard_env_state(state, mesh)
        key = jax.device_put(key, mesh_lib.replicated(mesh))
    out, acc = run(state, key)
    float(acc)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, acc = run(state, key)
        float(acc)
        times.append(time.perf_counter() - t0)
    host = jax.tree_util.tree_map(np.asarray, out)
    return host, sorted(times)[1]


def _mesh(dp: int, mp: int = 1):
    return mesh_lib.make_mesh(dp=dp, mp=mp, devices=jax.devices()[: dp * mp])


def sharded_rollout(name: str, dp: int, per_card_envs=None, steps=64,
                    **overrides) -> dict:
    """The suite row at ``dp`` x its per-card batch: one card against a
    dp-sharded mesh, compared leaf by leaf per env."""
    kw, _, _ = _suite_row(name)
    kw["num_envs"] = dp * (per_card_envs or kw.get("num_envs", 4096))
    kw.update(overrides)
    env = build_env(**kw)
    state, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
    one, t_one = _final_state(env, state, steps)
    mesh = _mesh(dp)
    many, t_many = _final_state(env, state, steps, mesh)
    diff = {
        jax.tree_util.keystr(path): int(np.count_nonzero(a != b))
        for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(one),
            jax.tree_util.tree_leaves(many),
        )
    }
    check(not sum(diff.values()), f"{name}: sharded != single card {diff}")
    total = env.num_envs * steps
    return {
        "name": name,
        "num_envs": env.num_envs,
        "dp": dp,
        "mismatching_elements": sum(diff.values()),
        "one_card_env_steps_per_s": total / t_one,
        "mesh_env_steps_per_s": total / t_many,
        "mesh_env_steps_per_s_per_card": total / t_many / dp,
    }


# A train step on a mesh matches one card up to float summation order: the
# gradient and metric psums add the shards in another order.  Compared in
# float32 at "highest" matmul precision, with one epoch of one minibatch
# (the dp-local shuffle permutes within each shard, so smaller minibatches
# would differ by construction), so only that order differs.
# Losses within LOSS_ATOL + LOSS_RTOL * |loss| (the policy loss of the first
# minibatch is ~0 by construction, hence the absolute term).  Params: Adam's
# first update is lr * g / (|g| + eps) per element, so an element whose
# gradient lies within a few eps of zero turns summation-order noise into an
# update difference of up to lr, and no element moves by more than lr.
# Hence: all elements within 2 * lr, and all but PARAM_FRAC of them within
# 0.1 * lr.
LOSS_RTOL = 1e-4
LOSS_ATOL = 1e-5
PARAM_ATOL_LR = 0.1
PARAM_FRAC = 1e-3


def sharded_ppo(dp: int, mp: int, num_envs=1024, rollout_steps=16,
                size=64, hidden=256) -> dict:
    """One PPO train step on a (dp, mp) mesh against the single-card step."""
    kw = dict(obs="camera_gray", num_envs=num_envs, rollout_steps=rollout_steps,
              dtype=jnp.float32, hidden=hidden, size=size, num_epochs=1,
              num_minibatches=1)
    out = {}
    with jax.default_matmul_precision("highest"):
        for label, mesh in (("one", None), ("mesh", _mesh(dp, mp))):
            trainer = _trainer(mesh=mesh, **kw)
            ts = trainer.init(jax.random.PRNGKey(0))
            ts2, metrics = trainer.train_step(ts)
            # the second call may compile again for the output shardings
            ts3, _ = trainer.train_step(ts2)
            jax.block_until_ready(ts3.params)
            t0 = time.perf_counter()
            ts4, _ = trainer.train_step(ts3)
            jax.block_until_ready(ts4.params)
            dt = time.perf_counter() - t0
            out[label] = (
                {k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, ts2.params),
                num_envs * rollout_steps / dt,
            )
            lr = trainer.cfg.lr
    (m1, p1, sps1), (m2, p2, sps2) = out["one"], out["mesh"]
    losses = ("loss", "policy_loss", "value_loss", "entropy")
    loss_diff = {k: abs(m1[k] - m2[k]) for k in losses}
    loss_ok = all(
        loss_diff[k] <= LOSS_ATOL + LOSS_RTOL * abs(m1[k]) for k in losses
    )
    diffs = np.concatenate([
        np.abs(a - b).ravel()
        for a, b in zip(jax.tree_util.tree_leaves(p1),
                        jax.tree_util.tree_leaves(p2))
    ])
    param_diff = float(diffs.max())
    param_frac = float(np.mean(diffs > PARAM_ATOL_LR * lr))
    row = {
        "dp": dp, "mp": mp, "num_envs": num_envs,
        "losses": {k: m1[k] for k in losses},
        "loss_abs_diff": loss_diff,
        "param_max_abs_diff": param_diff,
        "param_frac_beyond_0.1lr": param_frac,
        "param_elements": int(diffs.size),
        "one_card_env_steps_per_s": sps1,
        "mesh_env_steps_per_s": sps2,
    }
    check(loss_ok and param_diff <= 2 * lr and param_frac <= PARAM_FRAC,
          row)
    return row


def phase_four_cards(dp=4, env_kw=None, ppo_kw=None) -> dict:
    rows, ppo = [], []
    for name in ("flagship_single_room_4096", "config3_random_16x16_rgb128"):
        rows.append(sharded_rollout(name, dp, **(env_kw or {})))
        log(f"four_cards rollout {name}: {json.dumps(rows[-1])}")
    for d, m in ((dp, 1), (dp // 2, 2)):
        ppo.append(sharded_ppo(d, m, **(ppo_kw or {})))
        log(f"four_cards ppo dp={d} mp={m}: {json.dumps(ppo[-1])}")
    peaks = [peak_bytes(d) for d in jax.devices()[:dp]]
    log(f"four_cards peak_bytes_in_use per card: {peaks}")
    return {"rollouts": rows, "ppo": ppo, "peak_bytes_in_use": peaks}


# -- main --------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the dp / dp x mp mesh path on four cards")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform "
              f"{dev.platform!r}; refusing to run", file=sys.stderr)
        return 2
    if args.four_cards and len(jax.devices()) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip())
    log(f"device_kind: {dev.device_kind}  jax: {jax.__version__}  "
        f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}  "
        f"compile cache: {enable_compile_cache()}")

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for phase in (phase_env, phase_parity, phase_learner):
            t = time.perf_counter()
            phase()
            log(f"phase {phase.__name__[6:]} done in "
                f"{time.perf_counter() - t:.1f} s")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

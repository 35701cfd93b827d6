"""Real multi-process distributed execution test (SURVEY §4 implication 5).

Launches the SAME program (tests/distributed_worker.py) twice:
  * once as a single process with 4 virtual CPU devices;
  * once as TWO OS processes with 2 virtual CPU devices each, joined via
    ``jax.distributed.initialize`` over a localhost coordinator with Gloo
    CPU collectives — a faithful stand-in for a multi-host GPU cluster.

Asserts the assembled dp-sharded env states are BIT-IDENTICAL between the
two topologies (env stepping has no cross-env collectives, so distribution
must not perturb it at all), and that the tensor-parallel PPO update's
metrics agree to float tolerance (its gradient psums cross processes).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env() -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_topology(nproc: int, devs_per_proc: int, outdir: str) -> dict:
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(nproc), str(port),
             outdir, str(devs_per_proc)],
            env=_clean_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"

    # Assemble shards: key "leaf/start" -> place at batch offset `start`.
    leaves: dict = {}
    metrics: dict = {}
    for i in range(nproc):
        with np.load(os.path.join(outdir, f"worker{i}.npz")) as z:
            for k in z.files:
                if k.startswith("metric/"):
                    metrics[k.split("/", 1)[1]] = float(z[k])
                    continue
                name, start = k.rsplit("/", 1)
                leaves.setdefault(name, {})[int(start)] = z[k]
    assembled = {}
    for name, parts in leaves.items():
        assembled[name] = np.concatenate(
            [parts[s] for s in sorted(parts)], axis=0
        )
    assembled["__metrics__"] = metrics
    return assembled


@pytest.mark.slow
def test_two_process_matches_single_process(tmp_path):
    os.makedirs(tmp_path / "sp", exist_ok=True)
    os.makedirs(tmp_path / "mp2", exist_ok=True)
    single = _run_topology(1, 4, str(tmp_path / "sp"))
    multi = _run_topology(2, 2, str(tmp_path / "mp2"))

    sm = single.pop("__metrics__")
    mm = multi.pop("__metrics__")
    assert set(single) == set(multi)
    for name in single:
        np.testing.assert_array_equal(
            single[name], multi[name], err_msg=f"env-state leaf {name}"
        )
    # Rollout rewards are per-env sums reduced once — must match exactly.
    assert sm["total_reward"] == mm["total_reward"]
    # PPO losses cross the process boundary through gradient psums; allow
    # reduction-order float noise only.
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        assert np.isfinite(mm[k])
        assert abs(sm[k] - mm[k]) <= 1e-4 * max(1.0, abs(sm[k])), (
            k, sm[k], mm[k]
        )

"""Profiling / tracing / metrics helpers.

The reference's observability is ``println`` in the play callback
(SURVEY.md section 5).  Equivalents here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  Perfetto/XProf trace directory;
* :func:`annotate` — ``jax.named_scope`` wrapper so step/cast/render kernels
  are labeled in traces;
* :class:`Meter` — host-side steps/s + episode-stat meter fed by the small
  per-step metric pytree (device scalars, one transfer per log interval);
* :func:`device_metrics` — on-device accumulator reduction for sharded
  rollouts (sums stay device-resident; one psum-reduced pytree out).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace viewable in XProf/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Decorator adding a named scope visible in profiler traces."""

    def deco(fn):
        def wrapped(*a, **k):
            with jax.named_scope(name):
                return fn(*a, **k)

        return wrapped

    return deco


def device_metrics(traj_done: jax.Array, traj_reward: jax.Array) -> Dict[str, jax.Array]:
    """Reduce a [T, B] rollout to scalar metrics on device (works under
    sharding — XLA inserts the cross-device reductions)."""
    episodes = jnp.sum(traj_done.astype(jnp.int32))
    return {
        "env_steps": jnp.asarray(traj_done.size, jnp.int32),
        "episodes": episodes,
        "return_sum": jnp.sum(traj_reward),
        "success_rate": jnp.where(
            episodes > 0,
            jnp.sum(jnp.where(traj_done, traj_reward, 0.0)) / episodes,
            0.0,
        ),
    }


class Meter:
    """Steps/s + running episode stats, fed once per log interval."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.steps = 0
        self.episodes = 0
        self.return_sum = 0.0

    def update(self, m: Dict[str, Any]) -> None:
        self.steps += int(np.asarray(m["env_steps"]))
        self.episodes += int(np.asarray(m["episodes"]))
        self.return_sum += float(np.asarray(m["return_sum"]))

    def snapshot(self) -> Dict[str, float]:
        dt = time.perf_counter() - self.t0
        return {
            "steps_per_sec": self.steps / dt if dt > 0 else 0.0,
            "env_steps": float(self.steps),
            "episodes": float(self.episodes),
            "mean_return": (
                self.return_sum / self.episodes if self.episodes else 0.0
            ),
            "elapsed_s": dt,
        }

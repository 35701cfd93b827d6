"""On-device rollout drivers.

The reference's "rollout" is its test loop: host-side
``state -> rand action -> act! -> reward`` one env at a time
(/root/reference/test/runtests.jl:26-40).  Here the whole T-step
rollout is one jitted ``lax.scan`` — actions sampled on device from folded
PRNG keys (or a policy), observations stay device-resident, nothing touches
the host inside the loop.  Under a sharded EnvState the same program runs
SPMD over the mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..env import Env
from ..state import EnvState


class Trajectory(NamedTuple):
    """Time-major [T, B, ...] rollout record."""

    obs: jax.Array
    action: jax.Array
    reward: jax.Array
    done: jax.Array
    log_prob: Optional[jax.Array] = None
    value: Optional[jax.Array] = None


def rollout_random(
    env: Env, state: EnvState, key: jax.Array, num_steps: int
) -> tuple[EnvState, Trajectory]:
    """T uniform-random steps; returns (final_state, trajectory)."""

    def body(carry, _):
        state, key = carry
        key, k_act = jax.random.split(key)
        a = jax.random.randint(
            k_act,
            (env.num_envs,) + getattr(env.game, "action_shape", ()),
            0, env.game.num_actions, dtype=jnp.int32,
        )
        res = env._step_impl(state, a)
        return (res.state, key), Trajectory(
            obs=res.obs, action=a, reward=res.reward, done=res.done
        )

    (state, _), traj = jax.lax.scan(body, (state, key), None, length=num_steps)
    return state, traj


def rollout_policy(
    env: Env,
    policy_fn: Callable[[jax.Array, jax.Array], tuple],
    state: EnvState,
    key: jax.Array,
    num_steps: int,
) -> tuple[EnvState, Trajectory]:
    """T policy steps.  ``policy_fn(obs, key) -> (action, log_prob, value)``
    (already closed over params)."""

    def body(carry, _):
        state, obs, key = carry
        key, k_act = jax.random.split(key)
        action, log_prob, value = policy_fn(obs, k_act)
        res = env._step_impl(state, action)
        rec = Trajectory(
            obs=obs,
            action=action,
            reward=res.reward,
            done=res.done,
            log_prob=log_prob,
            value=value,
        )
        return (res.state, res.obs, key), rec

    obs0 = env.game.observe_batch(state)
    (state, _, _), traj = jax.lax.scan(
        body, (state, obs0, key), None, length=num_steps
    )
    return state, traj


def steps_per_second_program(env: Env, num_steps: int):
    """Build a jittable throughput program: runs ``num_steps`` random steps
    and reduces every observation to one checksum scalar so the images are
    produced (not DCE'd) but never leave the device."""

    def run(state: EnvState, key: jax.Array):
        # All T*B actions drawn in ONE threefry call and fed as scan inputs —
        # per-step key splitting/sampling inside the loop adds small kernels
        # to every iteration for no benefit (uniform policy).
        actions = jax.random.randint(
            key,
            (num_steps, env.num_envs)
            + getattr(env.game, "action_shape", ()),
            0,
            env.game.num_actions,
            dtype=jnp.int32,
        )

        def body(carry, a):
            state, acc = carry
            res = env._step_impl(state, a)
            obs = res.obs
            if obs.dtype == jnp.uint32:
                chk = jnp.sum(obs.astype(jnp.float32) * (1.0 / 2**24))
            else:
                chk = jnp.sum(obs.astype(jnp.float32))
            acc = acc + chk + jnp.sum(res.reward)
            return (res.state, acc), None

        (state, acc), _ = jax.lax.scan(
            body, (state, jnp.float32(0)), actions
        )
        return state, acc

    return run

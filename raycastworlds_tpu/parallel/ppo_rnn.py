"""Recurrent PPO (GRU actor-critic) for partially observable worlds.

The feedforward learner (parallel/ppo.py) sees one frame at a time; in Maze
worlds the camera view rarely identifies the player's location, so the
feedforward policy plateaus (docs/FAMILIES.md).  This trainer carries a GRU
hidden state through the rollout — reset at episode boundaries — and
replays the recurrence during the update, the standard recurrent-PPO
recipe:

* rollout: one jitted ``lax.scan``; the hidden state is zeroed AFTER a done
  transition so each episode starts from h=0;
* update: minibatches are drawn over the ENV axis only (time order must be
  preserved to replay the GRU); each minibatch replays its sequences from
  the stored rollout-start hidden under the CURRENT parameters, then takes
  the usual clipped-PPO step.  Hidden states pass between train steps
  detached (truncated BPTT at the rollout boundary).

No reference equivalent — the reference stops at the RL env adapter
(/root/reference/src/single_room.jl:570-584).  Single-agent; ``mesh``
dp-shards the trainer exactly like the feedforward one: env state, hidden
carry and rollout tensors sharded along ``dp``, params/optimizer replicated
(gradients psum-reduced by XLA), and the env-axis minibatch shuffle made
shard-LOCAL — the env axis splits into [d, B/d], a replicated permutation
acts on the unsharded local axis, and minibatch slices stay zero-collective
(same recipe as parallel/ppo.py's dp-local shuffle, minus the T fold —
sequence replay needs time order intact).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..env import Env
from ..state import EnvState
from . import mesh as mesh_lib
from .nets import RecurrentActorCritic
from .ppo import PPOConfig, compute_gae, preprocess_obs


class RnnTrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: EnvState
    hidden: jax.Array       # f32[B, hidden] — carried across train steps
    key: jax.Array
    update_count: jax.Array


class RecurrentPPOTrainer:
    """Owns the GRU network/optimizer and builds one jitted train step."""

    def __init__(
        self,
        env: Env,
        ppo_cfg: PPOConfig = PPOConfig(),
        hidden: int = 256,
        dtype: Any = jnp.float32,
        trunk: str = "conv",
        mesh: Optional[Mesh] = None,
    ):
        if getattr(env.game, "action_shape", ()) != ():
            raise ValueError(
                "RecurrentPPOTrainer is single-agent; fold the player axis "
                "with the feedforward PPOTrainer for MultiPlayerRoom"
            )
        self.mesh = mesh
        self._dp = 1 if mesh is None else mesh.shape[mesh_lib.DATA_AXIS]
        if env.num_envs % self._dp:
            raise ValueError("num_envs must divide by the dp mesh size")
        if (env.num_envs // self._dp) % ppo_cfg.num_minibatches:
            raise ValueError(
                "per-shard env count (num_envs / dp) must divide by "
                "num_minibatches"
            )
        self.env = env
        self.cfg = ppo_cfg
        self.hidden = hidden
        self.net = RecurrentActorCritic(
            num_actions=env.game.num_actions, hidden=hidden, dtype=dtype,
            trunk=trunk,
        )
        self.tx = optax.chain(
            optax.clip_by_global_norm(ppo_cfg.max_grad_norm),
            optax.adam(ppo_cfg.lr),
        )
        self._train_step = jax.jit(self._train_step_impl)

    def init(self, key: jax.Array) -> RnnTrainState:
        k_env, k_net, k_run = jax.random.split(key, 3)
        env_state, obs = self.env.reset(k_env)
        h0 = jnp.zeros((self.env.num_envs, self.hidden), jnp.float32)
        sample = preprocess_obs(self.env.cfg, obs[:1])
        params = self.net.init(k_net, sample, h0[:1])
        ts = RnnTrainState(
            params=params,
            opt_state=self.tx.init(params),
            env_state=env_state,
            hidden=h0,
            key=k_run,
            update_count=jnp.int32(0),
        )
        if self.mesh is not None:
            ts = self.shard(ts)
        return ts

    def shard(self, ts: RnnTrainState) -> RnnTrainState:
        """dp placement: env state + hidden carry batch-sharded, params and
        optimizer replicated (XLA psums the minibatch gradients)."""
        mesh = self.mesh
        rep = mesh_lib.replicated(mesh)
        return RnnTrainState(
            params=jax.tree_util.tree_map(
                lambda x: jax.device_put(x, rep), ts.params
            ),
            opt_state=jax.tree_util.tree_map(
                lambda x: jax.device_put(x, rep), ts.opt_state
            ),
            env_state=mesh_lib.shard_env_state(ts.env_state, mesh),
            hidden=jax.device_put(ts.hidden, mesh_lib.env_sharding(mesh)),
            key=jax.device_put(ts.key, rep),
            update_count=jax.device_put(ts.update_count, rep),
        )

    # -- the jitted train step ------------------------------------------

    def _train_step_impl(self, ts: RnnTrainState):
        env, cfg, net = self.env, self.cfg, self.net
        key, k_roll, k_perm = jax.random.split(ts.key, 3)

        # --- rollout with hidden carry ---------------------------------
        def body(carry, k):
            state, obs, h = carry
            x = preprocess_obs(env.cfg, obs)
            logits, value, h2 = net.apply(ts.params, x, h)
            action = jax.random.categorical(k, logits).astype(jnp.int32)
            log_prob = jnp.sum(
                jax.nn.log_softmax(logits)
                * jax.nn.one_hot(action, logits.shape[-1]),
                axis=-1,
            )
            res = env._step_impl(state, action)
            # episode boundary: next step starts a fresh episode -> h = 0
            h_next = jnp.where(res.done[:, None], 0.0, h2)
            rec = (obs, action, log_prob, value, res.reward, res.done)
            return (res.state, res.obs, h_next), rec

        obs0 = env.game.observe_batch(ts.env_state)
        keys = jax.random.split(k_roll, cfg.rollout_steps)
        (env_state, last_obs, h_last), (
            obs_t, act_t, lp_t, val_t, rew_t, done_t
        ) = jax.lax.scan(body, (ts.env_state, obs0, ts.hidden), keys)

        _, last_value, _ = net.apply(
            ts.params, preprocess_obs(env.cfg, last_obs), h_last
        )
        adv, target = compute_gae(
            rew_t, val_t, done_t, last_value, cfg.gamma, cfg.gae_lambda,
        )

        # --- update: env-axis minibatches, sequence replay --------------
        # dp-LOCAL shuffle (same rationale as parallel/ppo.py): the env
        # axis splits into [d, B/d]; a REPLICATED permutation acts on the
        # unsharded local axis, so shuffling and minibatch slicing compile
        # to pure local ops — zero collectives.  Time stays a leading
        # un-permuted axis because the GRU replay needs sequence order.
        d = self._dp
        b = env.num_envs
        bl = b // d
        mbl = bl // cfg.num_minibatches

        def replay_loss(params, batch):
            """Replay the GRU over [T, mb] sequences under ``params``."""

            def step(h, inp):
                o, d = inp
                logits, value, h2 = net.apply(
                    params, preprocess_obs(env.cfg, o), h
                )
                return jnp.where(d[:, None], 0.0, h2), (logits, value)

            _, (logits, value) = jax.lax.scan(
                step, batch["h0"], (batch["obs"], batch["done"])
            )
            log_probs = jax.nn.log_softmax(logits)          # [T, mb, A]
            lp = jnp.sum(
                log_probs * jax.nn.one_hot(batch["action"], logits.shape[-1]),
                axis=-1,
            )
            ratio = jnp.exp(lp - batch["log_prob"])
            a = batch["advantage"]
            a = (a - a.mean()) / (a.std() + 1e-8)
            unclipped = ratio * a
            clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * a
            policy_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
            value_loss = 0.5 * jnp.mean((value - batch["target"]) ** 2)
            entropy = -jnp.mean(
                jnp.sum(jnp.exp(log_probs) * log_probs, axis=-1)
            )
            loss = (
                policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
            )
            return loss, {
                "loss": loss,
                "policy_loss": policy_loss,
                "value_loss": value_loss,
                "entropy": entropy,
            }

        def to_local(x):  # [T, B, ...] -> [T, d, B/d, ...]
            return x.reshape(x.shape[:1] + (d, bl) + x.shape[2:])

        data = {
            "obs": to_local(obs_t), "action": to_local(act_t),
            "log_prob": to_local(lp_t), "advantage": to_local(adv),
            "target": to_local(target), "done": to_local(done_t),
        }
        h0_local = ts.hidden.reshape((d, bl, self.hidden))
        if self.mesh is not None:
            sh = NamedSharding(self.mesh, P(None, mesh_lib.DATA_AXIS))
            data = {
                k: jax.lax.with_sharding_constraint(v, sh)
                for k, v in data.items()
            }
            h0_local = jax.lax.with_sharding_constraint(
                h0_local, NamedSharding(self.mesh, P(mesh_lib.DATA_AXIS))
            )

        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, bl)
            shuf = {k: v[:, :, perm] for k, v in data.items()}
            h0s = h0_local[:, perm]

            def minibatch(carry, i):
                params, opt_state = carry
                batch = {
                    k: jax.lax.dynamic_slice_in_dim(
                        v, i * mbl, mbl, axis=2
                    ).reshape(v.shape[:1] + (d * mbl,) + v.shape[3:])
                    for k, v in shuf.items()
                }
                batch["h0"] = jax.lax.dynamic_slice_in_dim(
                    h0s, i * mbl, mbl, axis=1
                ).reshape((d * mbl, self.hidden))
                grads, metrics = jax.grad(
                    lambda p: replay_loss(p, batch), has_aux=True
                )(params)
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                minibatch, (params, opt_state),
                jnp.arange(cfg.num_minibatches),
            )
            return (params, opt_state, key), metrics

        (params, opt_state, _), metrics = jax.lax.scan(
            epoch, (ts.params, ts.opt_state, k_perm), None,
            length=cfg.num_epochs,
        )

        metrics = jax.tree_util.tree_map(jnp.mean, metrics)
        metrics["reward_per_step"] = jnp.mean(rew_t)
        n_ep = jnp.sum(done_t.astype(jnp.int32))
        metrics["episodes_finished"] = n_ep
        n_succ = jnp.sum((done_t & (rew_t > 0)).astype(jnp.int32))
        metrics["success_rate"] = jnp.where(
            n_ep > 0, n_succ / jnp.maximum(n_ep, 1), 0.0
        )

        return RnnTrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            hidden=h_last,
            key=key,
            update_count=ts.update_count + 1,
        ), metrics

    def train_step(self, ts: RnnTrainState):
        return self._train_step(ts)

    def train(self, key: jax.Array, num_updates: int, log_every: int = 10):
        import time as _time

        ts = self.init(key)
        history = []
        t0 = _time.perf_counter()
        for u in range(num_updates):
            ts, metrics = self.train_step(ts)
            if (u + 1) % log_every == 0 or u == num_updates - 1:
                m = {k: float(np.asarray(v)) for k, v in metrics.items()}
                m["update"] = u + 1
                m["elapsed_s"] = round(_time.perf_counter() - t0, 2)
                history.append(m)
        return ts, history

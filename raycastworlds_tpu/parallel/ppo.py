"""PPO learner co-located with the env batch — BASELINE config 5.

The reference exposes envs to an external Julia RL stack and stops there
(/root/reference/src/single_room.jl:570-584).  This framework ships
the other half: an actor-critic learner whose train step (rollout + GAE +
clipped-PPO update) is ONE jitted SPMD program over the device mesh — envs and
observations sharded along ``dp`` and never leaving the devices, gradients
reduced by XLA-inserted psums, the actor-critic's hidden layer optionally
tensor-parallel along ``mp``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EnvConfig
from ..env import Env
from ..state import EnvState
from . import mesh as mesh_lib
from .nets import ActorCritic
from .rollout import rollout_policy


# ---------------------------------------------------------------------------
# Observation preprocessing
# ---------------------------------------------------------------------------


def preprocess_obs(cfg: EnvConfig, obs: jax.Array) -> jax.Array:
    """Map any obs_type to float32 features with a trailing channel axis
    (images) or a flat vector (depth / tile_grid)."""
    if cfg.obs_type == "camera_u32":
        r = ((obs >> 16) & 0xFF).astype(jnp.float32)
        g = ((obs >> 8) & 0xFF).astype(jnp.float32)
        b = (obs & 0xFF).astype(jnp.float32)
        return jnp.stack([r, g, b], axis=-1) / 255.0
    if cfg.obs_type == "camera_rgb":
        return obs.astype(jnp.float32) / 255.0
    if cfg.obs_type == "camera_gray":
        return obs[..., None].astype(jnp.float32)
    if cfg.obs_type == "camera_pal8":
        # Identical features to the camera_u32 path (exact palette decode
        # / 255) without a gather.  Small palettes decode by PACKED-BYTE
        # SELECT: the N channel bytes live in ceil(N/4) u32 compile-time
        # constants; each pixel picks its word with a short select chain
        # and extracts its byte with a variable shift — ~6 integer ops per
        # channel, fully fused elementwise.  The alternatives cost more
        # memory traffic: a one-hot contraction materializes a [.., N] f32
        # intermediate and a broadcast where-chain re-materializes the
        # [.., 3] output per entry.  Extended textured palettes (> 64
        # entries) decode with a row gather, exact like the select.
        pal_u32 = cfg.palette_np  # host np uint32 [N]
        n = int(pal_u32.shape[0])
        if n <= 64:
            x = obs.astype(jnp.uint32)
            slot = (x & 3) * 8

            def channel(shift):
                vals = [(int(v) >> shift) & 0xFF for v in pal_u32]
                vals += [0] * (-len(vals) % 4)
                words = [
                    vals[i] | vals[i + 1] << 8 | vals[i + 2] << 16
                    | vals[i + 3] << 24
                    for i in range(0, len(vals), 4)
                ]
                w = jnp.uint32(words[-1])
                for i in range(len(words) - 2, -1, -1):
                    w = jnp.where(x < 4 * (i + 1), jnp.uint32(words[i]), w)
                return ((w >> slot) & 0xFF).astype(jnp.float32)

            return (
                jnp.stack([channel(16), channel(8), channel(0)], axis=-1)
                / 255.0
            )
        pal = jnp.asarray(cfg.palette_rgb_f32)  # [N, 3]
        return jnp.take(pal, obs.astype(jnp.int32), axis=0, mode="clip")
    if cfg.obs_type == "camera_gray_u8":
        return obs[..., None].astype(jnp.float32) / 255.0
    if cfg.obs_type == "depth":
        return obs.astype(jnp.float32)
    if cfg.obs_type == "tile_grid":
        return obs.reshape(obs.shape[:-2] + (-1,)).astype(jnp.float32)
    if cfg.obs_type in ("top_u32", "top_rgb"):
        raise ValueError(
            "top views are debug renders; train on a camera_* / depth / "
            "tile_grid observation instead"
        )
    raise ValueError(cfg.obs_type)


# ---------------------------------------------------------------------------
# Tensor-parallel placement of the actor-critic (parallel/nets.py)
# ---------------------------------------------------------------------------


def param_shardings(params, mesh: Mesh):
    """Tensor-parallel placement: trunk kernel column-sharded over mp, the
    consuming heads row-sharded; everything else replicated.  XLA inserts the
    all-gather/psum at the boundaries."""

    def place(path, x):
        names = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
        if x.ndim == 2 and "trunk" in names and "kernel" in names:
            return NamedSharding(mesh, P(None, mesh_lib.MODEL_AXIS))
        if x.ndim == 1 and "trunk" in names and "bias" in names:
            return NamedSharding(mesh, P(mesh_lib.MODEL_AXIS))
        if x.ndim == 2 and ("policy" in names or "value" in names) and "kernel" in names:
            return NamedSharding(mesh, P(mesh_lib.MODEL_AXIS, None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(place, params)


# ---------------------------------------------------------------------------
# PPO machinery
# ---------------------------------------------------------------------------


class PPOConfig(NamedTuple):
    rollout_steps: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 2
    num_minibatches: int = 4


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: EnvState
    key: jax.Array
    update_count: jax.Array


def compute_gae(
    reward: jax.Array,      # [T, B]
    value: jax.Array,       # [T, B]
    done: jax.Array,        # [T, B]
    last_value: jax.Array,  # [B]
    gamma: float,
    lam: float,
) -> Tuple[jax.Array, jax.Array]:
    """Generalized advantage estimation over a time-major rollout.  ``done``
    marks the transition as terminal (value bootstrap masked)."""

    def body(carry, inp):
        gae, next_value = carry
        r, v, d = inp
        nonterm = 1.0 - d.astype(jnp.float32)
        delta = r + gamma * next_value * nonterm - v
        gae = delta + gamma * lam * nonterm * gae
        return (gae, v), gae

    (_, _), adv = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (reward, value, done),
        reverse=True,
    )
    return adv, adv + value


def make_policy_fn(net: ActorCritic, cfg: EnvConfig, params, num_players=0):
    """Policy closure for rollouts.  ``num_players > 0`` (MultiPlayerRoom)
    runs ONE parameter-shared network over the folded [B*P] batch and
    returns per-player actions int32[B, P] — multi-agent self-play with a
    single set of weights, the standard parameter-sharing baseline."""

    def policy(obs, key):
        x = preprocess_obs(cfg, obs)
        if num_players:
            b = x.shape[0]
            x = x.reshape((b * num_players,) + x.shape[2:])
        logits, value = net.apply(params, x)
        if num_players:
            logits = logits.reshape(b, num_players, -1)
            value = value.reshape(b, num_players)
        action = jax.random.categorical(key, logits)
        # one-hot contraction instead of fancy indexing: under dp sharding
        # the row-gather compiles to (small but needless) index all-gathers
        # plus a scatter-add in the backward pass; the one-hot form is pure
        # local elementwise+reduce.
        log_prob = jnp.sum(
            jax.nn.log_softmax(logits)
            * jax.nn.one_hot(action, logits.shape[-1]),
            axis=-1,
        )
        return action.astype(jnp.int32), log_prob, value

    return policy


def ppo_loss(
    net: ActorCritic,
    env_cfg: EnvConfig,
    cfg: PPOConfig,
    params,
    batch: Dict[str, jax.Array],
):
    x = preprocess_obs(env_cfg, batch["obs"])
    logits, value = net.apply(params, x)
    log_probs = jax.nn.log_softmax(logits)
    lp = jnp.sum(
        log_probs * jax.nn.one_hot(batch["action"], logits.shape[-1]),
        axis=-1,
    )
    ratio = jnp.exp(lp - batch["log_prob"])
    adv = batch["advantage"]
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    unclipped = ratio * adv
    clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
    value_loss = 0.5 * jnp.mean((value - batch["target"]) ** 2)
    entropy = -jnp.mean(
        jnp.sum(jnp.exp(log_probs) * log_probs, axis=-1)
    )
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    return loss, {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
    }


class PPOTrainer:
    """Owns network/optimizer and builds the single jitted SPMD train step."""

    def __init__(
        self,
        env: Env,
        ppo_cfg: PPOConfig = PPOConfig(),
        mesh: Optional[Mesh] = None,
        hidden: int = 256,
        dtype: Any = jnp.float32,
        trunk: str = "conv",
    ):
        self.env = env
        self.cfg = ppo_cfg
        self.mesh = mesh
        # MultiPlayerRoom: per-env action shape (P,) — train ONE
        # parameter-shared policy by folding the player axis into the batch
        # (obs [B, P, ...] -> [B*P, ...]; episode-level done broadcast per
        # player for GAE).
        ashape = getattr(env.game, "action_shape", ())
        self.num_players = ashape[0] if ashape else 0
        self.net = ActorCritic(
            num_actions=env.game.num_actions, hidden=hidden, dtype=dtype,
            trunk=trunk,
        )
        self.tx = optax.chain(
            optax.clip_by_global_norm(ppo_cfg.max_grad_norm),
            optax.adam(ppo_cfg.lr),
        )
        self._train_step = jax.jit(self._train_step_impl)

    def init(self, key: jax.Array) -> TrainState:
        k_env, k_net, k_run = jax.random.split(key, 3)
        env_state, obs = self.env.reset(k_env)
        sample = preprocess_obs(self.env.cfg, obs[:1])
        if self.num_players:
            sample = sample.reshape((-1,) + sample.shape[2:])
        params = self.net.init(k_net, sample)
        opt_state = self.tx.init(params)
        ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            key=k_run,
            update_count=jnp.int32(0),
        )
        if self.mesh is not None:
            ts = self.shard(ts)
        return ts

    def shard(self, ts: TrainState) -> TrainState:
        mesh = self.mesh
        p_sh = param_shardings(ts.params, mesh)
        params = jax.tree_util.tree_map(jax.device_put, ts.params, p_sh)
        opt_state = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())),
            ts.opt_state,
        )
        env_state = mesh_lib.shard_env_state(ts.env_state, mesh)
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            key=jax.device_put(ts.key, mesh_lib.replicated(mesh)),
            update_count=jax.device_put(
                ts.update_count, mesh_lib.replicated(mesh)
            ),
        )

    # -- the jitted train step ------------------------------------------
    # Split into two pure phases so each can be jitted/timed in isolation
    # (examples/profile_ppo.py) while the production train step still
    # compiles them as ONE program.

    def _rollout_phase(self, ts: TrainState, k_roll: jax.Array):
        """Rollout + last-value bootstrap + GAE.  Returns
        (env_state, traj [player axis folded], adv, target, aux metrics)."""
        env, cfg, net = self.env, self.cfg, self.net
        policy = make_policy_fn(net, env.cfg, ts.params, self.num_players)
        env_state, traj = rollout_policy(
            env, policy, ts.env_state, k_roll, cfg.rollout_steps
        )

        aux: Dict[str, jax.Array] = {}
        # goal-reach rate among finished episodes (truncations score 0) —
        # the on-device analog of utils/profiling.device_metrics
        ep_reward = (
            jnp.sum(traj.reward, axis=-1) if self.num_players else traj.reward
        )
        n_ep = jnp.sum(traj.done.astype(jnp.int32))
        n_succ = jnp.sum((traj.done & (ep_reward > 0)).astype(jnp.int32))
        aux["success_rate"] = jnp.where(
            n_ep > 0, n_succ / jnp.maximum(n_ep, 1), 0.0
        )
        if self.num_players:
            # Fold the player axis into the env axis ([T, B, P, ...] ->
            # [T, B*P, ...]; B-major, so dp shard boundaries are preserved)
            # and broadcast the episode-level done to every player — from
            # here on the update is exactly the single-agent path over B*P
            # "environments" sharing one set of weights.
            p = self.num_players
            for k in range(p):
                aux[f"reward_p{k}"] = jnp.mean(traj.reward[:, :, k])
            # episode count from the PRE-fold done so it keeps the
            # single-agent meaning (the per-player broadcast below would
            # count each finished episode num_players times)
            aux["episodes_finished"] = jnp.sum(traj.done.astype(jnp.int32))

            def fold(x):
                return x.reshape(x.shape[:1] + (-1,) + x.shape[3:])

            traj = traj._replace(
                obs=fold(traj.obs),
                action=fold(traj.action),
                reward=fold(traj.reward),
                log_prob=fold(traj.log_prob),
                value=fold(traj.value),
                done=fold(jnp.broadcast_to(
                    traj.done[:, :, None], traj.done.shape + (p,)
                )),
            )
        else:
            aux["episodes_finished"] = jnp.sum(traj.done.astype(jnp.int32))

        last_obs = env.game.observe_batch(env_state)
        last_x = preprocess_obs(env.cfg, last_obs)
        if self.num_players:
            last_x = last_x.reshape((-1,) + last_x.shape[2:])
        _, last_value = net.apply(ts.params, last_x)
        adv, target = compute_gae(
            traj.reward, traj.value, traj.done, last_value,
            self.cfg.gamma, self.cfg.gae_lambda,
        )
        aux["reward_per_step"] = jnp.mean(traj.reward)
        return env_state, traj, adv, target, aux

    def _update_phase(
        self, params, opt_state, k_perm, traj, adv, target
    ):
        """Epochs x minibatches of clipped-PPO updates over one rollout.
        Returns (params, opt_state, metrics)."""
        env, cfg, net = self.env, self.cfg, self.net
        # --- dp-LOCAL minibatch shuffle -------------------------------
        # A global [T*B] permutation would compile to cross-device gathers
        # every minibatch under dp sharding (all the rollout data shuffling
        # over ICI/DCN for nothing).  Instead: split the dp-sharded env axis
        # into [d, B/d] (shard-local), fold T into the local axis, and
        # permute along the UNSHARDED local axis with a replicated
        # permutation — a pure local gather, zero collectives.  Every shard
        # applies the same permutation to its own (i.i.d.) slice, which is
        # statistically equivalent to independent per-shard shuffles.
        d = 1 if self.mesh is None else self.mesh.shape[mesh_lib.DATA_AXIS]
        t_len, b = traj.action.shape
        bl = b // d

        def to_local(x):
            x = x.reshape((t_len, d, bl) + x.shape[2:])
            x = jnp.moveaxis(x, 1, 0)  # [d, T, bl, ...] — shard-local
            return x.reshape((d, t_len * bl) + x.shape[3:])

        flat = {
            "obs": to_local(traj.obs),
            "action": to_local(traj.action),
            "log_prob": to_local(traj.log_prob),
            "advantage": to_local(adv),
            "target": to_local(target),
        }
        if self.mesh is not None:
            sh = NamedSharding(self.mesh, P(mesh_lib.DATA_AXIS))
            flat = {
                k: jax.lax.with_sharding_constraint(v, sh)
                for k, v in flat.items()
            }
        n = t_len * bl  # per-shard sample count
        mb = n // cfg.num_minibatches

        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            # _identity_shuffle is a profiling hook (examples/profile_ppo.py)
            # that isolates the shuffle-gather cost; never set in training.
            if getattr(self, "_identity_shuffle", False):
                perm = jnp.arange(n)
            else:
                perm = jax.random.permutation(kp, n)
            shuf = {k: v[:, perm] for k, v in flat.items()}

            def minibatch(carry, i):
                params, opt_state = carry
                batch = {
                    k: jax.lax.dynamic_slice_in_dim(
                        v, i * mb, mb, axis=1
                    ).reshape((d * mb,) + v.shape[2:])
                    for k, v in shuf.items()
                }
                grads, metrics = jax.grad(
                    lambda p: ppo_loss(net, env.cfg, cfg, p, batch),
                    has_aux=True,
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
            epoch, (params, opt_state, k_perm), None,
            length=cfg.num_epochs,
        )
        metrics = jax.tree_util.tree_map(jnp.mean, metrics)
        return params, opt_state, metrics

    def _train_step_impl(self, ts: TrainState):
        key, k_roll, k_perm = jax.random.split(ts.key, 3)
        env_state, traj, adv, target, aux = self._rollout_phase(ts, k_roll)
        params, opt_state, metrics = self._update_phase(
            ts.params, ts.opt_state, k_perm, traj, adv, target
        )
        metrics.update(aux)
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            key=key,
            update_count=ts.update_count + 1,
        ), metrics

    def train_step(self, ts: TrainState):
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
                # wall-clock since train start (update 1 includes compile):
                # the honest x-axis for throughput-vs-quality comparisons
                m["elapsed_s"] = round(_time.perf_counter() - t0, 2)
                history.append(m)
        return ts, history

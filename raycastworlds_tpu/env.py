"""Batched environment API — the RLBase-adapter analog.

The reference adapts its game to ReinforcementLearningBase with a thin
wrapper (/root/reference/src/rlbase.jl:1-7,
/root/reference/src/single_room.jl:570-584): ``state`` is the raw camera
view, ``action_space`` is 4 discrete actions, ``reward``/``is_terminated``
forward world fields.

Here the adapter is a Gymnasium/gymnax-style batched functional API:

    env = Env(SingleRoom(cfg), num_envs=1024)
    state, obs = env.reset(jax.random.PRNGKey(0))
    state, obs, reward, done, info = env.step(state, actions)

Everything is jitted with donated state buffers; with ``auto_reset=True``
(default) terminated envs are re-initialized inside the same step — the
returned ``reward``/``done`` describe the terminating transition while
``obs``/``state`` already belong to the next episode (the standard batched-RL
convention; the reference leaves resetting to the caller,
/root/reference/src/single_room.jl:139-191 ``done`` non-sticky).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .models.base import Game
from .state import EnvState


class StepResult(NamedTuple):
    state: EnvState
    obs: jax.Array
    reward: jax.Array
    done: jax.Array
    info: Dict[str, jax.Array]


class Space(NamedTuple):
    """Minimal space descriptor (no gym dependency)."""

    shape: Tuple[int, ...]
    dtype: Any
    n: Optional[int] = None  # discrete cardinality, None for boxes


def _select(pred, on_true, on_false):
    """Per-env tree select; pred is bool[B], leaves have leading B."""

    def one(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return jnp.where(p, a, b)

    return jax.tree_util.tree_map(one, on_true, on_false)


class Env:
    """Batched, jitted, auto-resetting environment."""

    def __init__(
        self,
        game: Game,
        num_envs: int = 1,
        auto_reset: bool = True,
        jit: bool = True,
        donate: bool = False,
        reset_budget: int = 0,
        final_obs_in_info: bool = False,
    ):
        """``reset_budget > 0`` enables *budgeted* auto-reset: at most that
        many envs are re-initialized per step (a gather/reset-K/scatter
        instead of computing a fresh reset for the whole batch — the dense
        reset dominates step cost for families with expensive generators
        like RandomRoom).  Envs that finish beyond the budget freeze (state
        unchanged, reward 0, done False) until a later step's budget reaches
        them; their episode end was already reported, so consumers see
        padding frames, not duplicated episodes.  Size the budget at a few
        times the expected terminations per step (B / typical episode
        length) and the overflow probability is negligible.
        """
        self.game = game
        self.cfg = game.cfg
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.reset_budget = min(reset_budget, num_envs)
        # With auto_reset, the obs returned for a finished env already
        # belongs to the next episode.  final_obs_in_info=True additionally
        # renders the PRE-reset state into info["final_observation"] (the
        # gymnasium terminal-observation convention, needed to bootstrap
        # truncated episodes) at the cost of a second batch render per step.
        self.final_obs_in_info = final_obs_in_info
        self._reset = jax.jit(self._reset_impl) if jit else self._reset_impl
        # donate=True reuses the state buffers across steps (use in step-wise
        # drivers; leave off if the previous state is read after stepping).
        self._step = (
            jax.jit(self._step_impl, donate_argnums=(0,) if donate else ())
            if jit
            else self._step_impl
        )

    # -- spaces ---------------------------------------------------------

    @property
    def action_space(self) -> Space:
        # Per-env action shape: () for single-player families, (P,) for
        # MultiPlayerRoom — matches what sample_action returns per env.
        return Space(
            shape=getattr(self.game, "action_shape", ()),
            dtype=jnp.int32,
            n=self.game.num_actions,
        )

    @property
    def observation_space(self) -> Space:
        cfg = self.cfg
        dtypes = {
            "camera_u32": jnp.uint32,
            "camera_rgb": jnp.uint8,
            "camera_gray": jnp.float32,
            "camera_pal8": jnp.uint8,
            "camera_gray_u8": jnp.uint8,
            "depth": cfg.float_dtype,  # follows EnvConfig.dtype
            "tile_grid": jnp.int32,
            "top_u32": jnp.uint32,
            "top_rgb": jnp.uint8,
        }
        return Space(shape=cfg.obs_shape, dtype=dtypes[cfg.obs_type])

    # -- impl -----------------------------------------------------------

    def _reset_impl(self, key: jax.Array):
        keys = jax.random.split(key, self.num_envs)
        state = jax.vmap(self.game.reset_single)(keys)
        obs = self.game.observe_batch(state)
        return state, obs

    def _step_impl(self, state: EnvState, action: jax.Array) -> StepResult:
        stepped = jax.vmap(self.game.step_single)(state, action)
        if self.reset_budget > 0:
            # Envs awaiting a budgeted reset are frozen: their step is
            # discarded.  (Dense mode skips all of this — pending_reset is
            # constant-false there, and the per-leaf select was pure dead
            # work XLA cannot eliminate from a traced bool.)
            frozen = state.pending_reset
            stepped = _select(frozen, state, stepped)
            # reward may carry a trailing per-player axis (MultiPlayerRoom),
            # so the frozen mask is broadcast rank-aware.
            fz = frozen.reshape(
                frozen.shape + (1,) * (stepped.reward.ndim - frozen.ndim)
            )
            stepped = stepped.replace(
                reward=jnp.where(fz, 0.0, stepped.reward),
                done=jnp.where(frozen, False, stepped.done),
            )
        else:
            frozen = None
        terminated = stepped.done
        if self.cfg.max_episode_steps > 0:
            truncated = ~terminated & (
                stepped.t >= self.cfg.max_episode_steps
            )
            if frozen is not None:
                truncated = truncated & ~frozen
        else:
            truncated = jnp.zeros_like(terminated)
        ep_end = terminated | truncated
        info = {
            "terminal_t": stepped.t,
            "episode_return": stepped.episode_return,
            "terminated": terminated,
            "truncated": truncated,
        }
        if self.auto_reset and self.final_obs_in_info:
            # obs of the post-step, pre-reset state: for envs where
            # terminated|truncated this is the terminal observation the
            # auto-reset otherwise discards; elsewhere it equals `obs`.
            info["final_observation"] = self.game.observe_batch(stepped)
        if not self.auto_reset:
            nxt = stepped.replace(done=ep_end)
        elif self.reset_budget > 0:
            nxt = self._budgeted_reset(stepped, frozen | ep_end)
            nxt = nxt.replace(reward=stepped.reward, done=ep_end)
        else:
            fresh = jax.vmap(self.game.reset_single)(stepped.rng_key)
            nxt = _select(ep_end, fresh, stepped)
            # reward/done of the ending transition survive the reset;
            # StepResult.done marks the episode boundary (terminated OR
            # truncated) so GAE-style consumers never bootstrap across
            # episodes.
            nxt = nxt.replace(reward=stepped.reward, done=ep_end)
        obs = self.game.observe_batch(nxt)
        return StepResult(nxt, obs, stepped.reward, ep_end, info)

    def _budgeted_reset(self, stepped: EnvState, needs: jax.Array) -> EnvState:
        """Reset at most ``reset_budget`` of the envs flagged in ``needs``
        (the first K needy envs in index order); the rest keep
        ``pending_reset`` set and stay frozen.

        Selection is prefix-count compaction, not ``top_k``: an inclusive
        prefix over the needy mask (two small matvecs, ops/sampling
        ``_prefix_count``) gives each needy env its compacted slot directly,
        where ``top_k`` lowers to a full [B] sort every step.  Same envs
        selected (stable-top-k over a 0/1 score = first K needy by index).
        """
        from .ops.sampling import _prefix_count

        k = self.reset_budget
        b = needs.shape[0]
        cnt = _prefix_count(needs.astype(jnp.float32))
        slot = cnt.astype(jnp.int32) - 1            # needy env -> its slot
        sel = needs & (slot < k)
        env_ids = jnp.arange(b, dtype=jnp.int32)
        # idx[slot] = env index for selected envs; unfilled slots (fewer than
        # k needy) stay 0 and are masked by ``valid``.
        idx = (
            jnp.zeros((k,), jnp.int32)
            .at[jnp.where(sel, slot, k)]
            .set(env_ids, mode="drop")
        )
        n_needy = cnt[-1].astype(jnp.int32)
        valid = jnp.arange(k, dtype=jnp.int32) < jnp.minimum(n_needy, k)

        keys = stepped.rng_key[idx]  # [k, 2]
        fresh = jax.vmap(self.game.reset_single)(keys)

        # Scatter fresh rows back; invalid slots write out-of-bounds and drop
        # (no per-leaf gather of current values needed).
        idx_sc = jnp.where(valid, idx, b)

        def scatter(leaf, fresh_leaf):
            return leaf.at[idx_sc].set(fresh_leaf, mode="drop")

        nxt = jax.tree_util.tree_map(scatter, stepped, fresh)
        return nxt.replace(pending_reset=needs & ~sel)

    # -- public ---------------------------------------------------------

    def reset(self, key: jax.Array) -> Tuple[EnvState, jax.Array]:
        return self._reset(key)

    def step(self, state: EnvState, action: jax.Array) -> StepResult:
        return self._step(state, action)

    def sample_action(self, key: jax.Array) -> jax.Array:
        shape = (self.num_envs,) + getattr(self.game, "action_shape", ())
        return jax.random.randint(
            key, shape, 0, self.game.num_actions, dtype=jnp.int32
        )

    @functools.cached_property
    def _top_view_fn(self):
        return jax.jit(jax.vmap(self.game.top_view_single))

    @functools.cached_property
    def _camera_view_fn(self):
        return jax.jit(jax.vmap(self.game.camera_view_single))

    def top_view(self, state: EnvState) -> jax.Array:
        """Batched uint32 top views (debug rendering; reference
        ``update_top_view!``)."""
        return self._top_view_fn(state)

    def camera_view(self, state: EnvState) -> jax.Array:
        """Batched uint32 camera views regardless of obs_type."""
        return self._camera_view_fn(state)

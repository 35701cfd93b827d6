"""Environment state as an immutable pytree.

The reference keeps a single mutable struct stepped in place
(``SingleRoomWorld``, /root/reference/src/single_room.jl:21-40).  Here it is
an immutable struct-of-arrays pytree with *no* ray buffers —
ray results are recomputed functionally each step and fused into the render by
XLA, never stored as state.  Add a leading batch axis with ``vmap``; shard the
batch axis over a device mesh with ``NamedSharding``.

A per-env PRNG key replaces the reference's single shared ``rng``
(/root/reference/src/single_room.jl:33,49), which is what makes trajectories
reproducible per-env and independent of batch size / sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-env state; all fields unbatched here, batched via vmap.

    Reference field mapping (/root/reference/src/single_room.jl:21-40):
      wall_words <- tile_map[WALL]      uint32[ceil(H*W/32)] bit-packed
                    (the dense bool[H, W] map is available as the
                    ``wall_map`` property; the hot path — collision, DDA,
                    render — consumes only the packed words, so packing
                    happens exactly once, at reset)
      goal_tu   <- goal_position        int32[2]   (0-indexed tile)
      pos_wu    <- player_position_wu   float32[2]
      dir_au    <- player_direction_au  int32      in [0, num_directions)
      reward    <- reward               float32
      done      <- done                 bool
      rng_key   <- rng (per-env key here, not a shared global RNG)
    Extra (for metrics / auto-reset; no reference equivalent):
      t               int32    steps taken in the current episode
      episode_return  float32  accumulated reward this episode
      pending_reset   bool     episode ended but the env awaits its reset
                               slot (only used under Env(reset_budget=K);
                               always False in dense-reset mode)
    """

    wall_words: jax.Array
    goal_tu: jax.Array
    pos_wu: jax.Array
    dir_au: jax.Array
    reward: jax.Array
    done: jax.Array
    rng_key: jax.Array
    t: jax.Array
    episode_return: jax.Array
    pending_reset: jax.Array
    # Static map dims (aux data, not a leaf) so the packed words can be
    # unpacked without an EnvConfig in hand.
    hw: Tuple[int, int] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # Optional per-family extensions (None for families that don't use them;
    # None is an empty pytree node so tree ops stay uniform within a game):
    #   goal_words  uint32[nw]  bit-packed multi-goal mask (MultiGoalRoom;
    #               generalizes the single goal_tu tile)
    #   blocks      int32[K, 3] moving obstacles as (i_tu, j_tu, dir in 0..3)
    #               (DynamicRoom)
    goal_words: Any = None
    blocks: Any = None
    #   goal_tiles  int32[K, 2] the goal tiles behind goal_words, with
    #               collected slots at (-1, -1) (kept in sync so the
    #               closed-form box raycaster needs no unpack/top-k)
    goal_tiles: Any = None
    #   key_tu      int32[2] collectable key tile (LockedRoom)
    #   key_held    bool     key collected -> door tiles vanish
    key_tu: Any = None
    key_held: Any = None

    def replace(self, **changes) -> "EnvState":
        """Copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)

    @property
    def batch_shape(self):
        return self.dir_au.shape

    @property
    def wall_map(self) -> jax.Array:
        """Dense bool[..., H, W] wall map, unpacked on demand (debug /
        top-view / tile-grid consumers only — never on the step hot path)."""
        from .ops import bitmap

        return bitmap.unpack_bits(self.wall_words, self.hw)

    def replace_walls(self, wall_map: jax.Array) -> "EnvState":
        """Return a state with a new dense wall map (re-packed)."""
        from .ops import bitmap

        return self.replace(wall_words=bitmap.pack_bits(wall_map))


def tile_map(state: EnvState) -> jax.Array:
    """Rebuild the reference's [2, H, W] bool tile map (wall, goal channels)."""
    from .ops import bitmap

    h, w = state.hw
    if state.goal_words is not None:
        goal_map = bitmap.unpack_bits(state.goal_words, (h, w))
    else:
        gi, gj = state.goal_tu[..., 0], state.goal_tu[..., 1]
        ii = jnp.arange(h)[:, None]
        jj = jnp.arange(w)[None, :]
        goal_map = (ii == gi[..., None, None]) & (jj == gj[..., None, None])
    return jnp.stack([state.wall_map, goal_map], axis=-3)


def metrics(state: EnvState) -> Dict[str, Any]:
    return {
        "reward": state.reward,
        "done": state.done,
        "t": state.t,
        "episode_return": state.episode_return,
    }

"""RandomRoom: per-env randomized obstacle maps (BASELINE config 3).

No reference equivalent — the reference's map is always an empty walled room
(/root/reference/src/single_room.jl:55-60).  This family keeps SingleRoom's
dynamics (shared ``Game`` core) but regenerates the wall map from the per-env
PRNG key at every reset: border walls plus Bernoulli interior obstacles,
goal placed on an empty interior tile, and the player spawn drawn only from
tiles *reachable from the goal* (on-device flood fill, ops/flood.py) so every
episode is winnable.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from ..ops import bitmap, flood, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class RandomRoomConfig(EnvConfig):
    """EnvConfig + obstacle density (fraction of interior tiles walled)."""

    wall_density: float = 0.2
    # Flood-fill iteration budget for the reachability mask.  <=0 means the
    # worst-case bound H*W/2 (any path).  A budget of ~2*(H+W) covers all
    # but serpentine paths, and under-iteration only SHRINKS the spawn set
    # (spawns stay reachable) — it never breaks the reachability guarantee.
    # The default stays at the exact H*W/2 bound, which keeps the exact
    # guarantee; throughput-tuned workloads opt in to fewer iterations via
    # this knob.
    flood_iters: int = -1
    # Disable the reachability mask entirely (spawn on any empty tile;
    # unreachable goals become possible — episodes then only end by caller
    # truncation).  For maximum-throughput workloads.
    ensure_reachable: bool = True

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 <= self.wall_density < 1.0):
            raise ValueError("wall_density must be in [0, 1)")
        if self.height_tile_map_tu < 5 or self.width_tile_map_tu < 5:
            raise ValueError(
                "RandomRoom needs at least a 5x5 map (enclosed-goal spawn "
                "fallback requires a 3x3+ interior)"
            )


class RandomRoom(Game):
    def __init__(self, cfg: RandomRoomConfig):
        if not isinstance(cfg, RandomRoomConfig):
            cfg = RandomRoomConfig(**dataclasses.asdict(cfg))
        super().__init__(cfg)

    def reset_single(self, key: jax.Array) -> EnvState:
        cfg: RandomRoomConfig = self.cfg
        h, w = cfg.H, cfg.W
        next_key, k_map, k_goal, k_spawn, k_dir = jax.random.split(key, 5)

        border = jnp.asarray(cfg.border_wall_map)
        interior_noise = (
            jax.random.uniform(k_map, (h, w), dtype=jnp.float32) < cfg.wall_density
        )
        wall_map = border | (interior_noise & ~border)

        # goal on an empty interior tile
        ii = jnp.arange(h)[:, None]
        jj = jnp.arange(w)[None, :]
        interior = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
        goal_tu = sampling.sample_empty_tile(
            k_goal, wall_map | ~interior
        )
        # ensure the goal tile itself is clear even in degenerate densities
        wall_map = wall_map.at[goal_tu[0], goal_tu[1]].set(False)

        # spawn only where the goal is reachable (and not on the goal)
        if cfg.ensure_reachable:
            iters = cfg.flood_iters if cfg.flood_iters > 0 else None
            reachable = flood.flood_fill(~wall_map, goal_tu, iters)
        else:
            reachable = ~wall_map
        goal_mask = (ii == goal_tu[0]) & (jj == goal_tu[1])
        valid = reachable & ~goal_mask
        sampled = sampling.sample_empty_tile(k_spawn, ~valid)
        # Degenerate map: the goal is fully walled in (no reachable tile
        # besides itself).  Carve a spawn tile adjacent to the goal instead —
        # interior is guaranteed since H, W >= 5 and the goal is interior.
        fallback = jnp.stack(
            [
                jnp.where(goal_tu[0] > 1, goal_tu[0] - 1, goal_tu[0] + 1),
                goal_tu[1],
            ]
        ).astype(jnp.int32)
        has_valid = jnp.any(valid)
        spawn_tu = jnp.where(has_valid, sampled, fallback)
        wall_map = wall_map.at[spawn_tu[0], spawn_tu[1]].set(False)
        pos_wu = spawn_tu.astype(cfg.float_dtype) + 0.5
        dir_au = sampling.sample_heading(
            k_dir, cfg.num_directions, cfg.continuous_heading
        )

        zero = jnp.float32(0)
        return EnvState(
            wall_words=bitmap.pack_bits(wall_map),
            hw=(h, w),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zero,
            done=jnp.asarray(False),
            rng_key=next_key,
            t=jnp.int32(0),
            episode_return=zero,
            pending_reset=jnp.asarray(False),
        )


def make(cfg: RandomRoomConfig | None = None, **kw) -> RandomRoom:
    return RandomRoom(cfg if cfg is not None else RandomRoomConfig(**kw))

"""Parity drivers: the jitted env against the scalar oracles.

Each driver runs one fixed-seed comparison and returns a :class:`Parity`
record of mismatching elements per checked quantity.  The CPU test suite
asserts every count is zero (tests/test_parity*.py, test_golden_images.py,
test_locked_room.py, test_continuous_heading.py); ``chip_smoke.py`` runs the
same drivers on the accelerator and prints the counts.  The expected result
is bit-exact on every backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig
from ..models.dynamic_room import DynamicRoom, DynamicRoomConfig
from ..models.locked_room import LockedRoom, LockedRoomConfig
from ..models.maze import Maze, MazeConfig
from ..models.multi_goal import MultiGoalConfig, MultiGoalRoom
from ..models.multi_player import MultiPlayerConfig, MultiPlayerRoom
from ..models.random_room import RandomRoom, RandomRoomConfig
from ..models.single_room import SingleRoom
from ..ops import bitmap
from . import families
from .single_room import OracleSingleRoom

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "data", "golden_frames.npz",
)

# SingleRoom at the flagship camera resolution (tests/test_parity.py).
SINGLE_ROOM_CFG = EnvConfig(num_rays=64, height_camera_view_pu=64)


# f32 division on the GPU, as XLA compiles it, is ``div.full.f32``: at most
# 2 ulp from the IEEE quotient the oracles compute (docs/PARITY.md).  Only
# the crossing distances ``(frac + k) / |d|`` carry a quotient straight into
# a checked value.
GPU_DIVIDE_ULP = 2


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 ulps (0 where equal)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude float order onto one integer line
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@dataclasses.dataclass
class Parity:
    """Mismatching elements per checked quantity, the first step at which
    each quantity differed (absent when it never did), and for float32
    quantities the largest distance in ulps."""

    mismatches: Dict[str, int] = dataclasses.field(default_factory=dict)
    first_step: Dict[str, int] = dataclasses.field(default_factory=dict)
    max_ulp: Dict[str, int] = dataclasses.field(default_factory=dict)

    def check(self, name: str, got, want, step: int = -1) -> None:
        a, b = np.asarray(got), np.asarray(want)
        if a.shape != b.shape:
            n = max(a.size, b.size, 1)
        else:
            n = int(np.count_nonzero(a != b))
            if n and a.dtype == b.dtype == np.float32:
                ulp = int(ulp_distance(a, b).max())
                self.max_ulp[name] = max(self.max_ulp.get(name, 0), ulp)
        self.mismatches[name] = self.mismatches.get(name, 0) + n
        if n and name not in self.first_step:
            self.first_step[name] = step

    @property
    def total(self) -> int:
        return sum(self.mismatches.values())

    def assert_exact(self) -> None:
        assert self.total == 0, (
            f"parity mismatches {self.mismatches}, first at steps "
            f"{self.first_step}"
        )

    def within(self, ulp_bounds: Dict[str, int]) -> bool:
        """Exact, except the named float32 quantities, which may differ by
        at most their bound in ulps."""
        for name, n in self.mismatches.items():
            if n and (
                name not in ulp_bounds
                or name not in self.max_ulp
                or self.max_ulp[name] > ulp_bounds[name]
            ):
                return False
        return True


# Each fields function maps (jax state, oracle) to {name: (got, want)}.
Fields = Callable[[object, object], Dict[str, Tuple[object, object]]]


def _pose(state, o):
    return {
        "pos": (state.pos_wu, o.pos_wu),
        "dir": (state.dir_au, o.dir_au),
        "reward": (state.reward, o.reward),
        "done": (state.done, o.done),
    }


def _pose_goal(state, o):
    return dict(_pose(state, o), goal=(state.goal_tu, list(o.goal_tu)))


def _continuous_pose(state, o):
    return dict(_pose(state, o), dir=(np.float32(state.dir_au), o.dir_au))


def _players(state, o):
    return {
        "pos": (state.pos_wu, o.ppos),
        "dir": (state.dir_au, o.pdir),
        "reward": (state.reward, o.rewards),
        "done": (state.done, o.done),
        "goal": (state.goal_tu, list(o.goal_tu)),
    }


def _continuous_players(state, o):
    return dict(
        _players(state, o),
        dir=(np.asarray(state.dir_au, np.float32), np.float32(o.pdir)),
    )


def _multi_goal(state, o):
    tiles = np.asarray(state.goal_tiles)
    alive = sorted((int(i), int(j)) for i, j in tiles if i >= 0)
    return dict(_pose(state, o), goals=(alive, sorted(o.goal_tiles)))


def _dynamic(state, o):
    return dict(_pose_goal(state, o), blocks=(state.blocks, o.blocks))


def _locked(state, o):
    return dict(
        _pose(state, o),
        key_held=(state.key_held, o.key_held),
        key_tu=(state.key_tu, list(o.key_tu)),
    )


def _no_fields(state, o):
    return {}


def trajectory(
    game,
    oracle,
    key: jax.Array,
    *,
    steps: int,
    frame_every: int,
    probs,
    action_seed: int,
    fields: Fields = _pose,
    on_done: str = "reset",
    players: int = 0,
    from_state: bool = False,
) -> Parity:
    """Drive the jitted game and the oracle with the same seeded actions.

    State fields are compared before every step and once after the last;
    camera frames every ``frame_every`` steps.  ``on_done`` is "reset"
    (both reset from the env's next key), "stop" (generated maps: one map is
    the fixture) or "step" (keep acting).  ``from_state`` seeds the oracle
    with the env's generated map and pose instead of resetting it.
    """
    reset = jax.jit(game.reset_single)
    step = jax.jit(game.step_single)
    observe = jax.jit(game.observe_single)
    frames = oracle.camera_views if players else oracle.camera_view

    state = reset(key)
    if from_state:
        cfg = game.cfg
        oracle = oracle.from_map(
            cfg, np.asarray(bitmap.unpack_bits(state.wall_words, (cfg.H, cfg.W))),
            np.asarray(state.goal_tu), np.asarray(state.pos_wu),
            int(state.dir_au),
        )
        frames = oracle.camera_view
    else:
        oracle.reset(key)
    rng = np.random.RandomState(action_seed)
    out = Parity()

    def compare(t):
        for name, (got, want) in fields(state, oracle).items():
            out.check(name, got, want, t)

    for t in range(steps):
        compare(t)
        if t % frame_every == 0:
            out.check("frame", observe(state), frames(), t)
        if bool(state.done) and on_done == "stop":
            return out
        if bool(state.done) and on_done == "reset":
            k = state.rng_key
            state = reset(k)
            oracle.reset(k)
        elif players:
            a = rng.choice(4, size=players, p=probs)
            state = step(state, jnp.asarray(a, jnp.int32))
            oracle.step([int(x) for x in a])
        else:
            a = int(rng.choice(4, p=probs))
            state = step(state, jnp.int32(a))
            oracle.step(a)
    compare(steps)
    return out


FORWARD = (0.55, 0.05, 0.2, 0.2)
FORWARD_HEAVY = (0.6, 0.05, 0.175, 0.175)


def single_room(seed: int, cfg: EnvConfig = SINGLE_ROOM_CFG) -> Parity:
    """SingleRoom vs OracleSingleRoom: 250 steps, frames every 25."""
    return trajectory(
        SingleRoom(cfg), OracleSingleRoom(cfg), jax.random.PRNGKey(seed),
        steps=250, frame_every=25, probs=FORWARD, action_seed=seed,
        fields=_pose_goal,
    )


def exhaustive_headings(cfg: EnvConfig = SINGLE_ROOM_CFG) -> Parity:
    """Every 7th heading's full ray cast (directions, hit tiles, hit faces,
    distances) vs the oracle, from one fixed spawn."""
    game = SingleRoom(cfg)
    cast = jax.jit(game.cast_single)
    oracle = OracleSingleRoom(cfg)
    key = jax.random.PRNGKey(9)
    state = jax.jit(game.reset_single)(key)
    oracle.reset(key)
    out = Parity()
    for au in range(0, cfg.num_directions, 7):
        state = state.replace(dir_au=jnp.int32(au))
        oracle.dir_au = au
        hits = cast(state)
        dirs_o, hit_tu_o, hit_dim_o, dist_o = oracle.cast_rays()
        out.check("ray_dirs", hits.ray_dirs, dirs_o, au)
        out.check("hit_tu", hits.hit_tu, hit_tu_o, au)
        out.check("hit_dim", hits.hit_dim, hit_dim_o, au)
        out.check("dist", hits.dist_wu, dist_o, au)
    return out


def multi_goal(seed: int, collect_all: bool) -> Parity:
    cfg = MultiGoalConfig(
        num_rays=48, height_camera_view_pu=32, num_goals=4,
        collect_all=collect_all,
    )
    return trajectory(
        MultiGoalRoom(cfg), families.OracleMultiGoal(cfg),
        jax.random.PRNGKey(seed), steps=220, frame_every=20, probs=FORWARD,
        action_seed=seed, fields=_multi_goal,
    )


def dynamic_room(seed: int) -> Parity:
    cfg = DynamicRoomConfig(
        num_rays=48, height_camera_view_pu=32, num_blocks=3, block_period=3,
    )
    return trajectory(
        DynamicRoom(cfg), families.OracleDynamicRoom(cfg),
        jax.random.PRNGKey(seed), steps=220, frame_every=20, probs=FORWARD,
        action_seed=seed, fields=_dynamic,
    )


def generated_map(family: str, raycast_backend: str = "auto") -> Parity:
    """Maze / RandomRoom: the oracle takes the generated map and pose, and
    pins dynamics + rendering until the first episode end."""
    if family == "maze":
        cfg = MazeConfig(
            height_tile_map_tu=9, width_tile_map_tu=9, num_rays=48,
            height_camera_view_pu=32, raycast_backend=raycast_backend,
        )
        game = Maze(cfg)
    else:
        cfg = RandomRoomConfig(
            height_tile_map_tu=10, width_tile_map_tu=10, num_rays=48,
            height_camera_view_pu=32, raycast_backend=raycast_backend,
        )
        game = RandomRoom(cfg)
    return trajectory(
        game, families.OracleWorld, jax.random.PRNGKey(7), steps=150,
        frame_every=15, probs=FORWARD, action_seed=11, on_done="stop",
        from_state=True,
    )


def multi_player(seed: int, num_players: int) -> Parity:
    cfg = MultiPlayerConfig(
        num_rays=48, height_camera_view_pu=32, num_players=num_players,
    )
    return trajectory(
        MultiPlayerRoom(cfg), families.OracleMultiPlayer(cfg),
        jax.random.PRNGKey(seed), steps=180, frame_every=18,
        probs=FORWARD_HEAVY, action_seed=seed, fields=_players,
        players=num_players,
    )


def multi_player_continuous() -> Parity:
    cfg = MultiPlayerConfig(
        num_rays=48, height_camera_view_pu=32, num_players=2,
        continuous_heading=True, turn_increment_au=0.7,
    )
    return trajectory(
        MultiPlayerRoom(cfg), families.OracleMultiPlayerContinuous(cfg),
        jax.random.PRNGKey(8), steps=120, frame_every=15,
        probs=FORWARD_HEAVY, action_seed=8, fields=_continuous_players,
        players=2,
    )


def multi_player_invisible() -> Parity:
    """players_visible=False: cameras show no other players."""
    cfg = MultiPlayerConfig(
        num_rays=32, height_camera_view_pu=24, num_players=2,
        players_visible=False,
    )
    return trajectory(
        MultiPlayerRoom(cfg), families.OracleMultiPlayer(cfg),
        jax.random.PRNGKey(9), steps=60, frame_every=10,
        probs=FORWARD_HEAVY, action_seed=9,
        fields=lambda s, o: {"pos": (s.pos_wu, o.ppos)},
        on_done="step", players=2,
    )


def texture(texture_name: str) -> Parity:
    cfg = EnvConfig(
        num_rays=48, height_camera_view_pu=32, wall_texture=texture_name,
        texture_cells=8,
    )
    return trajectory(
        SingleRoom(cfg), families.OracleWorld(cfg), jax.random.PRNGKey(13),
        steps=60, frame_every=6, probs=(0.5, 0.1, 0.2, 0.2), action_seed=13,
        fields=_no_fields, on_done="step",
    )


def locked_room(seed: int) -> Parity:
    cfg = LockedRoomConfig(num_rays=48, height_camera_view_pu=32)
    return trajectory(
        LockedRoom(cfg), families.OracleLockedRoom(cfg),
        jax.random.PRNGKey(seed), steps=260, frame_every=20,
        probs=FORWARD_HEAVY, action_seed=seed, fields=_locked,
    )


def continuous(seed: int) -> Parity:
    cfg = EnvConfig(
        num_rays=48, height_camera_view_pu=32, continuous_heading=True,
        turn_increment_au=0.7,
    )
    return trajectory(
        SingleRoom(cfg), families.OracleContinuous(cfg),
        jax.random.PRNGKey(seed), steps=160, frame_every=16, probs=FORWARD,
        action_seed=seed, fields=_continuous_pose,
    )


# Every comparison above with the arguments the CPU suite uses, by name.
TRAJECTORIES: Dict[str, Callable[[], Parity]] = {
    **{f"single_room[{s}]": (lambda s=s: single_room(s)) for s in (0, 1, 2)},
    "exhaustive_headings": exhaustive_headings,
    **{
        f"multi_goal[{s}-{c}]": (lambda s=s, c=c: multi_goal(s, c))
        for c in (True, False) for s in (0, 3)
    },
    **{f"dynamic_room[{s}]": (lambda s=s: dynamic_room(s)) for s in (1, 4)},
    "maze": lambda: generated_map("maze"),
    "random_room": lambda: generated_map("random_room"),
    **{
        f"multi_player[{p}-{s}]": (lambda s=s, p=p: multi_player(s, p))
        for p in (2, 3) for s in (2, 5)
    },
    "multi_player_continuous": multi_player_continuous,
    "multi_player_invisible": multi_player_invisible,
    **{f"texture[{t}]": (lambda t=t: texture(t))
       for t in ("checker", "brick", "xor")},
    **{f"locked_room[{s}]": (lambda s=s: locked_room(s)) for s in (0, 5)},
    **{f"continuous[{s}]": (lambda s=s: continuous(s)) for s in (0, 6)},
}


# -- golden frames ----------------------------------------------------------


def golden_games() -> Dict[str, object]:
    """One fixed configuration per family/texture, pinned byte for byte in
    tests/data/golden_frames.npz."""
    cam = dict(num_rays=64, height_camera_view_pu=48)
    return {
        "single_room": SingleRoom(EnvConfig(**cam)),
        "single_room_checker": SingleRoom(
            EnvConfig(**cam, wall_texture="checker", texture_cells=8)
        ),
        "single_room_brick": SingleRoom(
            EnvConfig(**cam, wall_texture="brick", texture_cells=8)
        ),
        "single_room_xor": SingleRoom(
            EnvConfig(**cam, wall_texture="xor", texture_cells=8)
        ),
        "maze": Maze(
            MazeConfig(height_tile_map_tu=11, width_tile_map_tu=11, **cam)
        ),
        "random_room": RandomRoom(
            RandomRoomConfig(height_tile_map_tu=12, width_tile_map_tu=12, **cam)
        ),
        "multi_goal": MultiGoalRoom(MultiGoalConfig(num_goals=3, **cam)),
        "locked_room": LockedRoom(LockedRoomConfig(**cam)),
        "dynamic_room": DynamicRoom(DynamicRoomConfig(num_blocks=3, **cam)),
        "top_view": SingleRoom(
            EnvConfig(num_rays=32, pu_per_tu=8, obs_type="top_u32")
        ),
        "multi_player": MultiPlayerRoom(
            MultiPlayerConfig(num_players=2, **cam)
        ),
    }


def golden_frame(game) -> np.ndarray:
    """A few deterministic steps past a fresh spawn, kept short so the frame
    keeps scene structure (a long scripted walk tends to end nose-against-a-
    wall in a uniform frame, which pins nothing).  The first seed whose
    frame has >= 3 distinct colors wins."""
    reset = jax.jit(game.reset_single)
    step = jax.jit(game.step_single)
    observe = jax.jit(game.observe_single)
    ashape = getattr(game, "action_shape", ())
    for seed in (1234, 7, 42, 99):
        state = reset(jax.random.PRNGKey(seed))
        for a in (2, 0, 3):
            act = jnp.full(ashape, a, jnp.int32) if ashape else jnp.int32(a)
            state = step(state, act)
        frame = np.asarray(observe(state))
        if len(np.unique(frame)) >= 3:
            return frame
    raise AssertionError("no structural snapshot found — adjust seeds/steps")


def golden(name: str, path: str = GOLDEN_PATH) -> Parity:
    """Recompute one golden frame and compare it with the pinned bytes."""
    with np.load(path) as pinned:
        want = pinned[name]
    out = Parity()
    out.check("frame", golden_frame(golden_games()[name]), want)
    return out


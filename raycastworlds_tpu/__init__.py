"""raycastworlds_tpu — a batched, device-resident raycast world engine.

A from-scratch JAX/XLA re-conception of the capability surface of
RayCastWorlds.jl (first-person grid-world RL environments with Wolfenstein
style raycast rendering), designed batched, functional and device-resident:

* ``EnvConfig`` — static config (the reference's constructor kwargs)
* ``EnvState`` — immutable struct-of-arrays env state pytree
* ``models``   — world families: SingleRoom (reference parity), RandomRoom,
  Maze (procedural multi-room), MultiGoalRoom (K collectable goals),
  DynamicRoom (moving obstacle blocks), LockedRoom (key unlocks the
  door line to the goal — two-stage sparse reward)
* ``ops``      — raycast (crossing + scan DDA), collision, render, sampling
* ``parallel`` — mesh sharding, on-device rollouts, PPO learner
* ``oracle``   — NumPy scalar reference implementation for parity tests
* ``Env``      — batched jitted auto-resetting environment API
"""

from .config import (
    EnvConfig,
    NUM_ACTIONS,
    MOVE_FORWARD,
    MOVE_BACKWARD,
    TURN_LEFT,
    TURN_RIGHT,
    ACTION_NAMES,
)
from .env import Env, Space, StepResult
from .state import EnvState, tile_map
from .models.single_room import SingleRoom
from .models.random_room import RandomRoom, RandomRoomConfig
from .models.maze import Maze, MazeConfig
from .models.multi_goal import MultiGoalRoom, MultiGoalConfig
from .models.dynamic_room import DynamicRoom, DynamicRoomConfig
from .models.locked_room import LockedRoom, LockedRoomConfig
from .models.multi_player import MultiPlayerRoom, MultiPlayerConfig
from .gym_compat import GymAdapter, GymVectorAdapter
from .wrappers import FrameStack, ObsTransform
from . import colors

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "Env",
    "Space",
    "StepResult",
    "SingleRoom",
    "RandomRoom",
    "RandomRoomConfig",
    "Maze",
    "MazeConfig",
    "MultiGoalRoom",
    "MultiGoalConfig",
    "DynamicRoom",
    "DynamicRoomConfig",
    "LockedRoom",
    "LockedRoomConfig",
    "MultiPlayerRoom",
    "MultiPlayerConfig",
    "GymAdapter",
    "GymVectorAdapter",
    "FrameStack",
    "ObsTransform",
    "tile_map",
    "colors",
    "NUM_ACTIONS",
    "MOVE_FORWARD",
    "MOVE_BACKWARD",
    "TURN_LEFT",
    "TURN_RIGHT",
    "ACTION_NAMES",
]

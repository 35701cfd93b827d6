"""Fixed-seed trajectory parity for the extended families and textures.

Closes the round-1 gap (VERDICT "what's weak" #5): MultiGoal / Dynamic /
Maze / RandomRoom and the texture paths were tested only by invariants and
backend-vs-backend agreement; these tests pin each against an independent
scalar NumPy oracle (oracle/families.py) the same way tests/test_parity.py
pins SingleRoom — bit-exact positions, headings, rewards, dones, goal sets,
block states, and camera images over trajectories with wall hits, goal hits,
collections and block bounces.  The drivers live in oracle/parity.py, shared
with the on-device check in chip_smoke.py.
"""

import pytest

from raycastworlds_tpu.oracle import parity


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("collect_all", [True, False])
def test_multi_goal_parity(seed, collect_all):
    parity.multi_goal(seed, collect_all).assert_exact()


@pytest.mark.parametrize("seed", [1, 4])
def test_dynamic_room_parity(seed):
    parity.dynamic_room(seed).assert_exact()


@pytest.mark.parametrize("family", ["maze", "random_room"])
def test_generated_map_parity(family):
    """Maze / RandomRoom: inject the generated map into the oracle and pin
    the dynamics + renderer on arbitrary maps (the generator itself is
    invariant-tested in tests/test_worlds.py)."""
    parity.generated_map(family).assert_exact()


@pytest.mark.parametrize("seed", [2, 5])
@pytest.mark.parametrize("num_players", [2, 3])
def test_multi_player_parity(seed, num_players):
    """MultiPlayerRoom vs the scalar P-player oracle: bit-exact spawns,
    simultaneous moves (incl. the circle-circle blocking and lower-index
    candidate tie-break), per-player rewards, episode-level done, and all P
    camera views (others occluding as blocks)."""
    parity.multi_player(seed, num_players).assert_exact()


def test_multi_player_continuous_parity():
    """Continuous headings x multi-player (the last oracle-less combination):
    bit-exact float headings, positions, rewards and all P camera frames vs
    the scalar OracleMultiPlayerContinuous."""
    parity.multi_player_continuous().assert_exact()


def test_multi_player_parity_invisible_players():
    """players_visible=False: cameras show no blocks; dynamics unchanged."""
    parity.multi_player_invisible().assert_exact()


@pytest.mark.parametrize("texture", ["checker", "brick", "xor"])
def test_texture_parity(texture):
    """Procedural wall texturing: per-pixel parity vs the scalar oracle."""
    parity.texture(texture).assert_exact()

"""Fixed-seed trajectory parity: jitted batched env vs NumPy scalar oracle.

This is BASELINE config 1 ("CPU ref parity"): same seed, same action
sequence, bit-exact positions / headings / rewards / dones, and identical
camera-view images, for hundreds of steps including wall hits, goal hits and
resets.  The two implementations share nothing but the PRNG stream and the
direction LUT (see oracle/single_room.py docstring).  The drivers live in
oracle/parity.py, shared with the on-device check in chip_smoke.py.
"""

import jax
import numpy as np
import pytest

import raycastworlds_tpu as rcw
from raycastworlds_tpu.oracle import parity
from raycastworlds_tpu.oracle.single_room import OracleSingleRoom


CFG = parity.SINGLE_ROOM_CFG


def _jit_fns(game):
    reset = jax.jit(game.reset_single)
    step = jax.jit(game.step_single)
    observe = jax.jit(game.observe_single)
    cast = jax.jit(lambda s: game.cast_single(s))
    return reset, step, observe, cast


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_parity(seed):
    parity.single_room(seed, CFG).assert_exact()


def test_ray_parity_exhaustive_headings():
    """Every 7th heading's full ray cast must match the oracle exactly."""
    parity.exhaustive_headings(CFG).assert_exact()


def test_tile_grid_parity():
    cfg = rcw.EnvConfig(
        height_tile_map_tu=8, width_tile_map_tu=8,
        num_rays=16, height_camera_view_pu=16, obs_type="tile_grid",
    )
    game = rcw.SingleRoom(cfg)
    reset, step, observe, _ = _jit_fns(game)
    oracle = OracleSingleRoom(cfg)
    key = jax.random.PRNGKey(5)
    state = reset(key)
    oracle.reset(key)
    np.testing.assert_array_equal(np.asarray(observe(state)), oracle.tile_grid())

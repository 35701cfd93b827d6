"""Empty-tile sampler: blocked prefix-count exactness and large-map scaling.

The reference rejection-samples empty tiles host-side
(/root/reference/src/utils.jl:23-58); the batched design replaces it with a
masked categorical via cumsum inversion (ops/sampling.py).  These tests pin
(a) the blocked O(n)-memory prefix count to the mathematically exact cumsum
on every size class (below / at / above / non-multiple of the block), and
(b) that 64x64+ maps — where the round-1 [n, n] triangle would have embedded
a 67 MB constant — reset and sample correctly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raycastworlds_tpu.ops import sampling


@pytest.mark.parametrize(
    "n", [1, 7, 255, 256, 257, 289, 1024, 4096, 5000]
)
def test_prefix_count_matches_cumsum(n):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2, size=n).astype(np.float32)
    got = jax.jit(sampling._prefix_count)(jnp.asarray(v))
    want = np.cumsum(v, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_blocked_prefix_bit_identical_to_single_triangle():
    # The parity suite depends on draws being bit-identical whichever
    # formulation runs; assert the counts agree exactly on a size that
    # exercises the blocked path (17*17 = 289 > block size 256).
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2, size=289).astype(np.float32)
    triu = np.triu(np.ones((289, 289), np.float32))
    want = v @ triu
    got = np.asarray(jax.jit(sampling._prefix_count)(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


def test_sample_empty_tile_large_map():
    # 64x64 = 4096 tiles: compiles with O(n) memory and returns empty tiles.
    occ = np.zeros((64, 64), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    occ[10:50, 20] = True
    occ_j = jnp.asarray(occ)
    draw = jax.jit(sampling.sample_empty_tile)
    for s in range(16):
        ij = np.asarray(draw(jax.random.PRNGKey(s), occ_j))
        assert not occ[ij[0], ij[1]]


def test_sample_empty_tile_uniform_small():
    # Every empty tile of a tiny map is reachable and roughly uniform.
    occ = np.ones((4, 4), bool)
    empties = [(1, 1), (1, 2), (2, 1), (2, 2)]
    for i, j in empties:
        occ[i, j] = False
    draw = jax.jit(jax.vmap(sampling.sample_empty_tile, in_axes=(0, None)))
    keys = jax.random.split(jax.random.PRNGKey(7), 2000)
    out = np.asarray(draw(keys, jnp.asarray(occ)))
    counts = {e: 0 for e in empties}
    for ij in out:
        counts[(int(ij[0]), int(ij[1]))] += 1
    for e in empties:
        assert 350 < counts[e] < 650, counts


def test_random_room_reset_64x64():
    import raycastworlds_tpu as rcw

    cfg = rcw.RandomRoomConfig(
        height_tile_map_tu=64,
        width_tile_map_tu=64,
        num_rays=16,
        height_camera_view_pu=16,
    )
    game = rcw.RandomRoom(cfg)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    state = jax.jit(jax.vmap(game.reset_single))(keys)
    walls = np.asarray(
        jax.vmap(
            lambda w: jax.jit(
                lambda ww: jnp.asarray(ww, jnp.uint32)
            )(w)
        )(state.wall_words)
    )
    assert walls.shape[-1] == (64 * 64 + 31) // 32
    # players spawn on empty tiles inside the border
    pos = np.asarray(state.pos_wu)
    assert (pos > 1.0).all() and (pos < 63.0).all()

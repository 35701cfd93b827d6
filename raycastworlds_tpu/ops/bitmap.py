"""Bit-packed boolean grids for gather-free occupancy lookups.

Tile maps are tiny (H*W <= a few hundred bits), so the whole obstacle map
packs into a handful of uint32 words that stay in registers.  A lookup is
then a short select-chain over the words plus a per-element variable shift —
elementwise work that XLA fuses straight into the DDA loop, with no memory
gather per DDA iteration.  This replaces the reference's ``obstacle_map[i, j]``
inner-loop load (RayCaster DDA contract, /root/reference/src/single_room.jl:223).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def n_words(num_bits: int) -> int:
    return (num_bits + 31) // 32


def pack_bits(bool_map: jax.Array) -> jax.Array:
    """Pack a bool[..., H, W] map into uint32[..., ceil(H*W/32)] words.

    Bit ``k = i*W + j`` of the flattened map lands in word ``k // 32`` at bit
    position ``k % 32``.
    """
    h, w = bool_map.shape[-2:]
    nb = h * w
    nw = n_words(nb)
    flat = bool_map.reshape(bool_map.shape[:-2] + (nb,)).astype(jnp.uint32)
    pad = nw * 32 - nb
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.zeros(bool_map.shape[:-2] + (pad,), jnp.uint32)],
            axis=-1,
        )
    flat = flat.reshape(bool_map.shape[:-2] + (nw, 32))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(flat * weights, axis=-1).astype(jnp.uint32)


def unpack_bits(words: jax.Array, shape) -> jax.Array:
    """Inverse of :func:`pack_bits`: uint32[..., nw] -> bool[..., H, W].

    Off the hot path (debug/top-view/tile-grid consumers); the step/render
    path reads the packed words directly via :func:`lookup_bit`.
    """
    h, w = shape
    nw = words.shape[-1]
    bits = (words[..., :, None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    flat = bits.reshape(words.shape[:-1] + (nw * 32,))[..., : h * w]
    return flat.reshape(words.shape[:-1] + (h, w)).astype(jnp.bool_)


def pack_bits_np(bool_map) -> "np.ndarray":
    """Host-side pack (static maps precomputed in configs)."""
    import numpy as np

    m = np.asarray(bool_map, dtype=bool)
    h, w = m.shape[-2:]
    nb = h * w
    nw = n_words(nb)
    flat = m.reshape(m.shape[:-2] + (nb,)).astype(np.uint32)
    pad = nw * 32 - nb
    if pad:
        flat = np.concatenate(
            [flat, np.zeros(m.shape[:-2] + (pad,), np.uint32)], axis=-1
        )
    flat = flat.reshape(m.shape[:-2] + (nw, 32))
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return np.sum(flat * weights, axis=-1, dtype=np.uint64).astype(np.uint32)


def tiles_to_words(tiles: jax.Array, shape, nw: int) -> jax.Array:
    """Pack K point tiles (i32[K, >=2] rows (i, j, ...)) into occupancy
    words arithmetically — K one-hot ORs, no dense [H, W] map, no scatter.
    Rows with a negative i are disabled slots and contribute nothing."""
    h, w = shape
    idx = tiles[:, 0] * w + tiles[:, 1]  # i32[K]
    alive = tiles[:, 0] >= 0
    word_sel = (
        ((idx[:, None] >> 5) == jnp.arange(nw, dtype=jnp.int32)[None, :])
        & alive[:, None]
    )
    bit = jnp.uint32(1) << (idx & 31).astype(jnp.uint32)
    contrib = jnp.where(word_sel, bit[:, None], jnp.uint32(0))  # [K, nw]
    return jax.lax.reduce(
        contrib, jnp.uint32(0), jax.lax.bitwise_or, dimensions=(0,)
    )


def lookup_bit(words: jax.Array, idx: jax.Array) -> jax.Array:
    """Test bit ``idx`` of packed words.

    words: uint32[n_words] (unbatched; vmap for batches).
    idx:   int32[...] flattened bit indices (must be in range).
    Returns bool[...].
    """
    nw = words.shape[-1]
    word_idx = (idx >> 5).astype(jnp.int32)
    bit_idx = (idx & 31).astype(jnp.uint32)
    if nw == 1:
        w = words[0]
    else:
        # select-chain over the words: nw selects and adds, no gather.
        sel = word_idx[..., None] == jnp.arange(nw, dtype=jnp.int32)
        w = jnp.sum(jnp.where(sel, words, jnp.uint32(0)), axis=-1)
    return ((w >> bit_idx) & jnp.uint32(1)).astype(jnp.bool_)

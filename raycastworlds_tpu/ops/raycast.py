"""Ray-fan generation and the DDA wall-intersection raycaster.

The reference delegates the per-ray DDA march to the external RayCaster.jl
package with data-dependent trip count (contract at
/root/reference/src/single_room.jl:223-227: boolean obstacle grid + origin +
normalized direction -> hit tile, hit-face axis, euclidean distance along the
ray to the hit face), and generates the ray fan by *linear interpolation
across the camera plane* (not angular) at
/root/reference/src/single_room.jl:213-221.

Batched re-conception:
* all rays of an env march in lockstep as [R]-shaped vectors under a fixed
  trip count (map diameter H+W suffices for maps with solid border walls),
  with a hit mask freezing finished rays — no data-dependent control flow,
  fully vmappable and XLA-fusable;
* the per-iteration occupancy test reads a *bit-packed* obstacle map held in
  registers (ops/bitmap.py) with shifts and masks, not a memory gather;
* the ray fan is a precomputed per-heading LUT (EnvConfig.ray_fan_lut).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from . import bitmap


class RayHits(NamedTuple):
    """Per-ray cast results (the reference's ray buffers,
    /root/reference/src/single_room.jl:76-79, as values not state)."""

    ray_dirs: jax.Array   # f32[R, 2] normalized ray directions
    hit_tu: jax.Array     # i32[R, 2] hit tile (0-indexed)
    hit_dim: jax.Array    # i32[R]    0 = i-face, 1 = j-face
    dist_wu: jax.Array    # f32[R]    euclidean distance along ray to hit face


def ray_fan(cfg: EnvConfig, player_dir_wu: jax.Array) -> jax.Array:
    """Normalized ray directions for one env: f32[num_rays, 2].

    Reference geometry (ref :214-221): ``camera_dir = rotate_minus_90(dir)``,
    rays lerp linearly from ``dir + sfov*cam`` to ``dir - sfov*cam`` then
    normalize.  Production code uses the precomputed ``cfg.ray_fan_lut``;
    this function is the live formula, kept for tests/continuous headings.
    """
    d = player_dir_wu
    cam = jnp.stack([d[1], -d[0]])  # rotate_minus_90, ref :193
    s = jnp.asarray(cfg.semi_field_of_view_wu, d.dtype)
    first = d + s * cam
    last = d - s * cam
    r = cfg.num_rays
    t = (jnp.arange(r, dtype=d.dtype) / (r - 1))[:, None]  # [R, 1]
    un = first[None, :] + t * (last - first)[None, :]      # [R, 2]
    norm = jnp.sqrt(jnp.sum(un * un, axis=-1, keepdims=True))
    return un / norm


def cast_rays_scan(
    obstacle_words: jax.Array,
    shape: Tuple[int, int],
    pos_wu: jax.Array,
    ray_dirs: jax.Array,
    max_steps: int,
    unroll: int = 1,
    early_exit: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Branch-free DDA for all rays of one env (vmap over envs).

    Args:
      obstacle_words: uint32[ceil(H*W/32)] bit-packed obstacle map — union of
        all object channels (ref :209 ``any(tile_map, dims=1)``).
      shape: static (H, W).
      pos_wu: f32[2] ray origin.
      ray_dirs: f32[R, 2] normalized directions.
      max_steps: static trip count (>= map diameter for guaranteed hit).

    Returns (hit_tu i32[R, 2], hit_dim i32[R], dist_wu f32[R]).

    Algorithm: classic Lodev/Wolfenstein DDA.  With normalized direction,
    ``delta = |1/d|`` is the ray length per unit axis step; ``side`` is the
    accumulated ray length to the *next* gridline crossing per axis.  Each
    iteration steps the axis with the smaller ``side``; the crossing distance
    is that pre-increment ``side``.  Rays that have hit are frozen by a mask.
    """
    h, w = shape
    dtype = ray_dirs.dtype

    dx = ray_dirs[:, 0]
    dy = ray_dirs[:, 1]
    px = pos_wu[0]
    py = pos_wu[1]

    map_i = jnp.floor(px).astype(jnp.int32) * jnp.ones_like(dx, jnp.int32)
    map_j = jnp.floor(py).astype(jnp.int32) * jnp.ones_like(dx, jnp.int32)

    delta_i = jnp.abs(1.0 / dx)  # IEEE: +inf where dx == 0
    delta_j = jnp.abs(1.0 / dy)
    step_i = jnp.where(dx < 0, -1, 1).astype(jnp.int32)
    step_j = jnp.where(dy < 0, -1, 1).astype(jnp.int32)

    frac_i = px - jnp.floor(px)
    frac_j = py - jnp.floor(py)
    side_i = jnp.where(dx < 0, frac_i, 1.0 - frac_i) * delta_i
    side_j = jnp.where(dy < 0, frac_j, 1.0 - frac_j) * delta_j

    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    class _S(NamedTuple):
        map_i: jax.Array
        map_j: jax.Array
        side_i: jax.Array
        side_j: jax.Array
        hit: jax.Array
        hit_dim: jax.Array
        dist: jax.Array

    init = _S(
        map_i=map_i,
        map_j=map_j,
        side_i=side_i,
        side_j=side_j,
        hit=jnp.zeros_like(dx, bool),
        hit_dim=jnp.zeros_like(dx, jnp.int32),
        dist=jnp.full_like(dx, big),
    )

    def body(s: _S, _):
        take_i = s.side_i < s.side_j  # tie -> step j, matching Lodev's branch
        adv = ~s.hit
        cross = jnp.minimum(s.side_i, s.side_j)
        nmap_i = s.map_i + jnp.where(adv & take_i, step_i, 0)
        nmap_j = s.map_j + jnp.where(adv & ~take_i, step_j, 0)
        nside_i = s.side_i + jnp.where(adv & take_i, delta_i, 0.0)
        nside_j = s.side_j + jnp.where(adv & ~take_i, delta_j, 0.0)
        # Occupancy test from the packed map — register-resident, no gather.
        # Clip keeps the bit index in-bounds; with solid border walls the
        # clip is never reached before a hit.
        idx = jnp.clip(nmap_i, 0, h - 1) * w + jnp.clip(nmap_j, 0, w - 1)
        occ = bitmap.lookup_bit(obstacle_words, idx)
        newly = adv & occ
        return _S(
            map_i=nmap_i,
            map_j=nmap_j,
            side_i=nside_i,
            side_j=nside_j,
            hit=s.hit | occ,
            hit_dim=jnp.where(newly, jnp.where(take_i, 0, 1), s.hit_dim),
            dist=jnp.where(newly, cross, s.dist),
        ), None

    if early_exit:
        # Stop marching once every ray has hit (identical results — frozen
        # rays are no-ops — but typical scenes finish in well under the
        # worst-case H+W iterations).  Under vmap this becomes "until every
        # env's rays are done", still a pure win.
        def cond(carry):
            i, s = carry
            return (i < max_steps) & jnp.any(~s.hit)

        def wbody(carry):
            i, s = carry
            s2, _ = body(s, None)
            return i + 1, s2

        _, final = jax.lax.while_loop(cond, wbody, (jnp.int32(0), init))
    else:
        final, _ = jax.lax.scan(
            body, init, None, length=max_steps, unroll=unroll
        )
    hit_tu = jnp.stack([final.map_i, final.map_j], axis=-1)
    return hit_tu, final.hit_dim, final.dist


def cast_rays_scan_flat(
    obstacle_words: jax.Array,   # u32[B, NW]
    shape: Tuple[int, int],
    pos_wu: jax.Array,           # f32[B, 2]
    ray_dirs: jax.Array,         # f32[B, R, 2]
    max_steps: int,
    unroll: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Batch-level DDA over flattened [B*R] lanes.

    Identical arithmetic (and therefore bit-identical results) to vmapping
    :func:`cast_rays_scan`, but the working arrays are 1-D over all rays of
    all envs.  The per-env packed words broadcast to per-ray operands once,
    hoisted out of the march loop.
    """
    b, r, _ = ray_dirs.shape
    nw = obstacle_words.shape[-1]
    words_flat = jnp.broadcast_to(
        obstacle_words[:, None, :], (b, r, nw)
    ).reshape(b * r, nw)
    dirs_flat = ray_dirs.reshape(b * r, 2)
    pos_flat = jnp.broadcast_to(pos_wu[:, None, :], (b, r, 2)).reshape(
        b * r, 2
    )

    h, w = shape
    dx = dirs_flat[:, 0]
    dy = dirs_flat[:, 1]
    px = pos_flat[:, 0]
    py = pos_flat[:, 1]

    map_i = jnp.floor(px).astype(jnp.int32)
    map_j = jnp.floor(py).astype(jnp.int32)
    delta_i = jnp.abs(1.0 / dx)
    delta_j = jnp.abs(1.0 / dy)
    step_i = jnp.where(dx < 0, -1, 1).astype(jnp.int32)
    step_j = jnp.where(dy < 0, -1, 1).astype(jnp.int32)
    frac_i = px - jnp.floor(px)
    frac_j = py - jnp.floor(py)
    side_i = jnp.where(dx < 0, frac_i, 1.0 - frac_i) * delta_i
    side_j = jnp.where(dy < 0, frac_j, 1.0 - frac_j) * delta_j
    big = jnp.asarray(jnp.finfo(dx.dtype).max, dx.dtype)

    init = (
        map_i, map_j, side_i, side_j,
        jnp.zeros_like(dx, bool),
        jnp.zeros_like(dx, jnp.int32),
        jnp.full_like(dx, big),
    )

    def body(s, _):
        mi, mj, si, sj, hit, hd, dist = s
        take_i = si < sj
        adv = ~hit
        cross = jnp.minimum(si, sj)
        nmi = mi + jnp.where(adv & take_i, step_i, 0)
        nmj = mj + jnp.where(adv & ~take_i, step_j, 0)
        nsi = si + jnp.where(adv & take_i, delta_i, 0.0)
        nsj = sj + jnp.where(adv & ~take_i, delta_j, 0.0)
        idx = jnp.clip(nmi, 0, h - 1) * w + jnp.clip(nmj, 0, w - 1)
        word_idx = idx >> 5
        bit_idx = (idx & 31).astype(jnp.uint32)
        if nw == 1:
            wsel = words_flat[:, 0]
        else:
            sel = word_idx[:, None] == jnp.arange(nw, dtype=jnp.int32)
            wsel = jnp.sum(
                jnp.where(sel, words_flat, jnp.uint32(0)), axis=-1
            )
        occ = ((wsel >> bit_idx) & jnp.uint32(1)).astype(jnp.bool_)
        newly = adv & occ
        return (
            nmi, nmj, nsi, nsj, hit | occ,
            jnp.where(newly, jnp.where(take_i, 0, 1), hd),
            jnp.where(newly, cross, dist),
        ), None

    (mi, mj, _, _, _, hd, dist), _ = jax.lax.scan(
        body, init, None, length=max_steps, unroll=unroll
    )
    hit_tu = jnp.stack(
        [mi.reshape(b, r), mj.reshape(b, r)], axis=-1
    )
    return hit_tu, hd.reshape(b, r), dist.reshape(b, r)


def _crossing_axis(
    obstacle_words: jax.Array,
    shape: Tuple[int, int],
    d_main: jax.Array,      # f32[R] direction component along the crossed axis
    d_cross: jax.Array,     # f32[R] the other component
    p_main: jax.Array,      # f32[]  origin along the crossed axis
    p_cross: jax.Array,     # f32[]  origin along the other axis
    main_is_i: bool,
    line_words=None,  # list of u32[size_main] words; bit c%32 of word c//32
                      # = occupancy of tile c along the line
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """All grid-line crossings of one axis, evaluated in parallel.

    Returns (best_t f32[R], main_tile i32[R], cross_tile i32[R]) — the
    smallest crossing distance whose *entered tile* is occupied, +max-float
    when no crossing of this axis hits.
    """
    h, w = shape
    dtype = d_main.dtype
    n = h if main_is_i else w          # lines the ray can cross this axis
    size_cross = w if main_is_i else h
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    main0 = jnp.floor(p_main).astype(jnp.int32)
    step = jnp.where(d_main < 0, -1, 1).astype(jnp.int32)
    frac = p_main - jnp.floor(p_main)
    frac_sel = jnp.where(d_main < 0, frac, 1.0 - frac)       # [R]
    ad = jnp.abs(d_main)                                     # [R]

    # Layout: [N, R] keeps the wide ray dimension minor and the 8-64-wide
    # candidate axis major.
    #
    # t = (frac_sel + k) / |d| — deliberately add-then-DIVIDE: the obvious
    # ``side0 + k*delta`` is a mul feeding an add, which LLVM may contract
    # into an FMA underneath any HLO-level pinning, breaking 1-ulp parity
    # with the scalar oracles at far hits.  There is no fused divide-add, so
    # this expression rounds identically everywhere.
    k = jnp.arange(n, dtype=dtype)                           # [N]
    t = (frac_sel[None, :] + k[:, None]) / ad[None, :]       # [N, R]
    finite = jnp.isfinite(t)
    c = p_cross + t * d_cross[None, :]                       # [N, R]
    c = jnp.where(finite, c, 0.0)
    # Entered-tile index on the crossed axis is exact integer arithmetic; the
    # cross-axis tile replays the sequential tie rule (ties advance j first):
    # at an i-crossing the j count includes simultaneous j-crossings
    # (floor for dy>0, ceil-1 for dy<0); at a j-crossing the i count
    # EXcludes simultaneous i-crossings (ceil-1 for dx>0, floor for dx<0).
    if main_is_i:
        # d_cross == 0 (gridline-parallel ray) takes floor: the sequential
        # march's map_j never leaves floor(p_cross) when side_j is +inf, so
        # ceil-1 would probe the tile column *below* the line it slides on.
        c_tile = jnp.where(
            d_cross[None, :] >= 0, jnp.floor(c), jnp.ceil(c) - 1.0
        )
    else:
        c_tile = jnp.where(
            d_cross[None, :] > 0, jnp.ceil(c) - 1.0, jnp.floor(c)
        )
    c_idx = jnp.clip(c_tile, 0.0, float(size_cross - 1)).astype(jnp.int32)
    size_main = h if main_is_i else w
    if line_words is not None:
        # The crossed-axis tile index depends on the ray only through the
        # STEP SIGN (m = main0 + (k+1)*step), so the per-candidate map line
        # is one of two word rows selected per env — the occupancy test
        # collapses to n_lw shift-and-masks per (ray, candidate) instead of
        # a 2*ceil(H*W/32) select-chain.  n_lw = ceil(size_cross/32): 1 for
        # every reference-scale map, 2 up to 64-wide, growing gracefully —
        # there is no fallback cliff at 32.
        n_lw = len(line_words)
        ks = jnp.arange(n, dtype=jnp.int32)
        m_plus = jnp.clip(main0 + (ks + 1), 0, size_main - 1)    # [N]
        m_minus = jnp.clip(main0 - (ks + 1), 0, size_main - 1)   # [N]
        iota = jnp.arange(size_main, dtype=jnp.int32)
        # One-hot row selection with the MAP axis minor: [N, size_main] per
        # env, one unrolled pass per 32-tile word (n_lw is 1 up to 32-wide
        # maps, 2 up to 64).  Keeping each word's lines as a separate [M]
        # vector — rather than a [M, n_lw] array — avoids a 1-2-wide minor
        # axis and any minor-axis transpose in the packing.
        onehot_p = m_plus[:, None] == iota[None, :]              # [N, M]
        onehot_m = m_minus[:, None] == iota[None, :]
        bit = (c_idx & 31).astype(jnp.uint32)
        occ_bit = jnp.zeros(t.shape, bool)
        for q in range(n_lw):
            lw_q = line_words[q]                                 # u32[M]
            w_plus_q = jnp.sum(
                jnp.where(onehot_p, lw_q[None, :], jnp.uint32(0)), axis=1
            )  # u32[N]
            w_minus_q = jnp.sum(
                jnp.where(onehot_m, lw_q[None, :], jnp.uint32(0)), axis=1
            )
            word_q = jnp.where(
                step[None, :] > 0, w_plus_q[:, None], w_minus_q[:, None]
            )  # u32[N, R]
            hit_q = ((word_q >> bit) & jnp.uint32(1)) == 1
            if n_lw == 1:
                occ_bit = hit_q
            else:
                occ_bit = occ_bit | (hit_q & ((c_idx >> 5) == q))
        occ = occ_bit & finite
    else:
        m_idx = main0 + (jnp.arange(n, dtype=jnp.int32)[:, None] + 1) * step[None, :]
        m_clip = jnp.clip(m_idx, 0, size_main - 1)
        idx = (
            m_clip * w + c_idx if main_is_i else c_idx * w + m_clip
        )
        occ = bitmap.lookup_bit(obstacle_words, idx) & finite
    t_m = jnp.where(occ, t, big)                             # [N, R]
    # ONE variadic lexicographic-min reduce over (t, k, c_idx) instead of
    # min + argmin + one-hot payload sum.  Selection is identical (argmin
    # returns the first — smallest-k — occurrence of the min, exactly the
    # (t, k) lexicographic rule, and the winner's payload rides along), so
    # results are bit-identical; but three separate [N, R] reductions can
    # each force the candidate arrays through device memory, while a single
    # reduce lets XLA fuse the whole candidate pipeline into one
    # generate-and-reduce pass.
    ks_b = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], t_m.shape
    )

    def _lexmin(acc, val):
        at, ak, ac = acc
        vt, vk, vc = val
        better = (vt < at) | ((vt == at) & (vk < ak))
        return (
            jnp.where(better, vt, at),
            jnp.where(better, vk, ak),
            jnp.where(better, vc, ac),
        )

    # init k = n loses to every real candidate (vk < n), so even an all-big
    # column selects k = 0 — exactly argmin's first-occurrence rule.
    best, kb, c_best = jax.lax.reduce(
        (t_m, ks_b, c_idx),
        (big, jnp.int32(n), jnp.int32(0)),
        _lexmin,
        (0,),
    )
    m_best = main0 + (kb + 1) * step
    return best, m_best, c_best


def _row_line_words(dense: jax.Array):
    """Per-row occupancy words of a dense uint32 0/1 map [H, W]: a list of
    ceil(W/32) vectors u32[H], word q bit j%32 = tile (i, 32q+j%32).  Lane
    reductions over column slices — no transpose, no narrow minor axis."""
    h, w = dense.shape
    words = []
    for q in range(0, w, 32):
        cols = dense[:, q : min(q + 32, w)]
        k = cols.shape[1]
        words.append(
            jnp.sum(cols << jnp.arange(k, dtype=jnp.uint32)[None, :], axis=1)
        )
    return words


def _col_line_words(dense: jax.Array):
    """Per-column occupancy words: list of ceil(H/32) vectors u32[W], word q
    bit i%32 = tile (32q+i%32, j).  Reductions over row slices."""
    h, w = dense.shape
    words = []
    for q in range(0, h, 32):
        rows = dense[q : min(q + 32, h), :]
        k = rows.shape[0]
        words.append(
            jnp.sum(rows << jnp.arange(k, dtype=jnp.uint32)[:, None], axis=0)
        )
    return words


def cast_rays_crossing(
    obstacle_words: jax.Array,
    shape: Tuple[int, int],
    pos_wu: jax.Array,
    ray_dirs: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Loop-free DDA: the hit is the min-distance occupied entered tile over
    ALL grid-line crossings, evaluated in parallel.

    Parallel reformulation of the sequential march (reference contract at
    /root/reference/src/single_room.jl:223-227): a ray crosses at most H
    i-lines and W j-lines before the border walls stop it; each crossing k
    enters exactly one tile at closed-form distance ``(frac + k) / |d|``, so
    the first occupied tile along the ray is simply the minimum crossing
    distance whose entered tile is occupied.  No sequential dependency
    remains: where ``lax.scan`` streams 7 [B, R] carries through device
    memory every DDA iteration, this is one flat [B, R, H+W] elementwise
    program + a min-reduction that XLA fuses straight into the camera
    renderer.

    Numerics: distances are the closed form ``(frac + k) / |d|`` (an
    uncontractible add-then-divide; see _crossing_axis) instead of the scan's
    sequentially accumulated sides — within ~1 ulp of them; hit tiles agree
    with the sequential march everywhere except exact-corner float
    coincidences (rays sliding exactly along a gridline — d_cross == 0 with
    integer p_cross — take floor(p_cross) like the scan's map index).
    Parity for this backend is pinned against its own scalar-oracle mode
    (oracle/single_room.py cast_one_crossing), same expressions.
    """
    h, w = shape
    dx = ray_dirs[:, 0]
    dy = ray_dirs[:, 1]
    px = pos_wu[0]
    py = pos_wu[1]
    dense = bitmap.unpack_bits(obstacle_words, (h, w)).astype(jnp.uint32)
    row_words = _row_line_words(dense)  # list of u32[H]
    col_words = _col_line_words(dense)  # list of u32[W]
    ti, ii, ji = _crossing_axis(
        obstacle_words, (h, w), dx, dy, px, py, main_is_i=True,
        line_words=row_words,
    )
    tj, jj, ij = _crossing_axis(
        obstacle_words, (h, w), dy, dx, py, px, main_is_i=False,
        line_words=col_words,
    )
    use_j = tj <= ti   # ties advance (and check) j first in the sequential march
    dist = jnp.where(use_j, tj, ti)
    hit_dim = jnp.where(use_j, 1, 0).astype(jnp.int32)
    hit_i = jnp.where(use_j, ij, ii)
    hit_j = jnp.where(use_j, jj, ji)
    return jnp.stack([hit_i, hit_j], axis=-1), hit_dim, dist


def cast_rays(
    cfg: EnvConfig,
    obstacle_words: jax.Array,
    pos_wu: jax.Array,
    dir_au: jax.Array,
    ray_dirs: jax.Array | None = None,
) -> RayHits:
    """Full cast for one env (ref ``cast_rays!``, single_room.jl:195-231):
    LUT fan lookup (ops/lut.py) + packed DDA march.
    ``ray_dirs`` overrides the LUT fan (continuous headings compute the fan
    live)."""
    from . import lut as lut_ops

    dirs = (
        ray_dirs
        if ray_dirs is not None
        else lut_ops.take_rows(jnp.asarray(cfg.ray_fan_lut), dir_au)
    )  # [R, 2]
    if cfg.resolved_raycast_backend == "crossing":
        hit_tu, hit_dim, dist = cast_rays_crossing(
            obstacle_words, (cfg.H, cfg.W), pos_wu, dirs
        )
    else:
        hit_tu, hit_dim, dist = cast_rays_scan(
            obstacle_words, (cfg.H, cfg.W), pos_wu, dirs, cfg.dda_steps,
            unroll=cfg.dda_unroll, early_exit=cfg.dda_early_exit,
        )
    return RayHits(ray_dirs=dirs, hit_tu=hit_tu, hit_dim=hit_dim, dist_wu=dist)

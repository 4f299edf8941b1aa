"""Variant-B path-tracing megakernel (Pallas, Triton route).

One program traces TILE rays through every sample and bounce, with each
ray's origin, direction, throughput and closest-hit state kept on chip for
the whole loop: the shape of the reference's one-thread-per-pixel
``pathTrace`` kernel (RTrace/raytrace.metal:11-111). The jnp oracle
(render.py) instead materialises [rays, triangles] work per bounce.

Triangles are tested by one loop for every scene size: a fori_loop over
groups of GROUP triangles whose AABBs are tested first, skipping a group
when no ray of the program can reach it, around a rolled loop over the
group's triangles. Per-ray cost then follows the geometry a ray can reach
rather than the scene size, and the kernel's code (hence its compile
time) does not grow with the scene. Only (t, primitive) is carried
through the loop; the winner's shading attributes are gathered from a
table once per bounce.

All math matches render._path_trace_chunk (same Halton dimensions, same
reference quirks); parity with the jnp oracle is asserted in the tests.

Gradients: ``render_path_pallas`` carries a custom VJP that re-traces with
record emission and runs the hand-written backward (ops/pallas_shade.py).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from .. import sampling as smp
from ..intersect import compile_scene
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from . import route

_F32 = jnp.float32
_U32 = jnp.uint32
_I32 = jnp.int32

TILE = 128                   # rays per program (power of two)
BIG = 1e30
RAY_TMIN = 1e-3
RAY_TMAX = 1e3
# Record code = (prim + 1) + OCC_BIT * shadow_occluded; 0 = miss. Power of
# two (int decode is an and-mask) and small enough that every code stays
# exact in f32 (codes < 2^21 << 2^24) while leaving room for ~1M primitives.
OCC_BIT = 1 << 20

GROUP = 16     # triangles per group (one AABB test, then GROUP plane tests)
BLOCK_W = 16   # pixel-tile width of a program's BLOCK_W x (TILE / BLOCK_W)
               # block of pixels (single-device renders)


def _block_h() -> int:
    return TILE // BLOCK_W


def use_blocked_tiles(config: RenderConfig, sharded: bool) -> bool:
    """BLOCK_W x (TILE / BLOCK_W) pixel tiles per program (see
    _path_kernel). Requires divisible resolution; the sharded path keeps
    the linear mapping (shards slice the linear pixel range)."""
    return (not sharded and config.width % BLOCK_W == 0
            and config.height % _block_h() == 0)


def to_blocked(a: jnp.ndarray, config: RenderConfig) -> jnp.ndarray:
    """Permute per-pixel [N, ...] data from row-major to pixel-tile order
    (pure reshape/transpose)."""
    h, w, bh = config.height, config.width, _block_h()
    rest = a.shape[1:]
    perm = (0, 2, 1, 3) + tuple(4 + i for i in range(len(rest)))
    return jnp.transpose(
        a.reshape(h // bh, bh, w // BLOCK_W, BLOCK_W, *rest),
        perm).reshape(-1, *rest)


def from_blocked(a: jnp.ndarray, config: RenderConfig) -> jnp.ndarray:
    """Inverse of to_blocked on [N, C] data -> [H, W, C]."""
    h, w, bh = config.height, config.width, _block_h()
    c = a.shape[-1]
    return jnp.transpose(
        a.reshape(h // bh, w // BLOCK_W, bh, BLOCK_W, c),
        (0, 2, 1, 3, 4)).reshape(h, w, c)


def padded_len(n: int) -> int:
    return ((n + TILE - 1) // TILE) * TILE


class TraceAux(NamedTuple):
    """Trace-pass outputs consumed by the differentiable replay
    (ops/decoupled.py). ``records`` carries the discrete decisions; the uv
    planes carry the random draws so the replay never recomputes Halton
    digits. Shapes: [spp, bounces, N] except jitter_[xy] [spp, N]."""

    records: jnp.ndarray   # int32: (prim + 1) + OCC_BIT * occluded; 0=miss
    nee_u0: jnp.ndarray    # f32 light-sample u (pre-scale, in [0,1))
    nee_u1: jnp.ndarray
    cos_u0: jnp.ndarray    # f32 cosine-bounce u
    cos_u1: jnp.ndarray
    jitter_x: jnp.ndarray  # f32 camera subpixel jitter
    jitter_y: jnp.ndarray


# Packed triangle-constant rows ([NROWS, T] table).
ROW_NX, ROW_NY, ROW_NZ, ROW_C0 = 0, 1, 2, 3
ROW_S1X, ROW_S1Y, ROW_S1Z, ROW_C1 = 4, 5, 6, 7
ROW_S2X, ROW_S2Y, ROW_S2Z, ROW_C2 = 8, 9, 10, 11
ROW_DR, ROW_DG, ROW_DB, ROW_ISEM = 12, 13, 14, 15
ROW_ER, ROW_EG, ROW_EB = 16, 17, 18
NROWS = 19

# Sphere-constant rows ([SROWS, S] table): center xyz, radius, diffuse rgb,
# is_emissive, emissive rgb.
SROWS = 11

# Attribute-table rows ([NATTR, num_tris + num_spheres]): shading
# attributes of every primitive, gathered once per bounce for the winning
# primitive. Rows: normal xyz (zeros for spheres), diffuse rgb, emissive
# rgb, is_emissive, sphere-center xyz (zeros for triangles).
NATTR = 13


# Halton indices are offset + n with offset < 2^20 (render.pixel_rng_offsets)
# and n < spp, so every index this kernel ever radical-inverses fits in
# HALTON_INDEX_BITS. The jnp oracle runs the full 32-bit digit loop; the
# extra high digits are zero there (q hits 0), so truncating the loop here is
# value-identical.
HALTON_INDEX_BITS = 21


def _halton_tile(i: jnp.ndarray, d: int) -> jnp.ndarray:
    """Halton radical inverse of dimension ``d`` on an index array; fixed
    digit count (sampling.metal:107-122)."""
    b = smp.PRIMES[d]
    return _radical_inverse(i, _F32(b), _F32(1.0 / b), _halton_digits(b))


def _halton_digits(b: int) -> int:
    return int(math.ceil(HALTON_INDEX_BITS / math.log2(b)))


def halton_bounce_table(bounces: int) -> jnp.ndarray:
    """[bounces * 4, 4] f32 rows (base, 1/base, digit count, 0) of the
    per-bounce Halton dimensions 2 + 5 * bounce + k, k = 0..3 (NEE u-pair,
    cosine u-pair), for kernels that loop over bounces at run time. The
    values equal _halton_tile's constants, so the digits are identical."""
    rows = []
    for bounce in range(bounces):
        for k in range(4):
            b = smp.PRIMES[2 + bounce * 5 + k]
            rows.append([b, 1.0 / b, _halton_digits(b), 0.0])
    return jnp.asarray(np.asarray(rows, np.float32))


def _radical_inverse(i, bf, inv_b, digits):
    """Radical inverse of ``i`` in base ``bf`` (with ``inv_b`` = 1/b in
    f32) over ``digits`` digits; ``bf``/``inv_b``/``digits`` may be traced.

    Digit extraction runs in f32 instead of u32 div/mod: indices are < 2^21
    so they are exact in f32, q0 = floor(i * (1/b)) is off by at most 1 from
    rounding, and one correction step recovers the exact (quotient, digit)
    pair — the oracle's integer digits."""

    def body(_, carry):
        f, r, i_f = carry
        f = f * inv_b
        q = jnp.floor(i_f * inv_b)
        digit = i_f - q * bf  # exact: both products are small integers
        # Correct the rounded quotient (at most one step either way).
        too_low = digit >= bf
        too_high = digit < 0.0
        q = jnp.where(too_low, q + 1.0, jnp.where(too_high, q - 1.0, q))
        digit = jnp.where(too_low, digit - bf,
                          jnp.where(too_high, digit + bf, digit))
        return f, r + f * digit, q

    r0 = jnp.zeros(i.shape, _F32)
    i_f = i.astype(_I32).astype(_F32)  # < 2^21: exact
    _, r, _ = jax.lax.fori_loop(0, digits, body, (r0 + 1.0, r0, i_f))
    return r


def _normalize3(x, y, z):
    # 1e-12 floor, matching sampling.normalize: rsqrt's VJP overflows f32
    # below ~1e-24.
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-12))
    return x * inv, y * inv, z * inv


def _f32_divmod(x, m: int):
    """Exact (quotient, remainder) of a small-integer-valued f32 array by a
    static int: floor-divide with one rounding-correction step (the same
    trick as _halton_tile)."""
    mf = _F32(m)
    q = jnp.floor(x * _F32(1.0 / m))
    r = x - q * mf
    too_low = r >= mf
    too_high = r < 0.0
    q = jnp.where(too_low, q + 1.0, jnp.where(too_high, q - 1.0, q))
    r = jnp.where(too_low, r - mf, jnp.where(too_high, r + mf, r))
    return q, r


def camera_jitter(ih: jnp.ndarray, config: RenderConfig):
    """Camera subpixel jitter for Halton index ``ih`` (Halton dims 0/1,
    or the stratified grid over spp cells — sampling.stratified2)."""
    jx = _halton_tile(ih, 0)
    jy = _halton_tile(ih, 1)
    if config.sampler == "stratified":
        k = int(round(math.sqrt(config.spp)))
        ihf = ih.astype(_I32).astype(_F32)
        _, cell = _f32_divmod(ihf, config.spp)
        cy, cx = _f32_divmod(cell, k)
        inv_k = _F32(1.0 / k)
        jx = (cx + jx) * inv_k
        jy = (cy + jy) * inv_k
    return jx, jy


def _safe_inv(d):
    """1/d with |d| < 1e-30 clamped to 1e30 for the AABB slab test. The
    clamp keeps (lo - o) * inv finite and NaN-free in every case (0 * 1e30
    = 0; finite * 1e30 may overflow to inf, which compares correctly), and
    for near-zero directions the test stays CONSERVATIVE: an origin inside
    the slab yields an unconstrained interval, an origin outside yields
    same-sign huge bounds that reject — exactly the true geometry."""
    return jnp.where(jnp.abs(d) < 1e-30, 1e30, 1.0 / d)


def _slab_interval(aabb6, ox, oy, oz, ivx, ivy, ivz):
    """Ray/AABB slab test against one box (6 scalars: lo xyz, hi xyz).
    Returns (tmin, tmax) of the box interval, clamped below at 0. The boxes
    are padded host-side (GROUP_AABB_PAD + relative margin) so FP
    differences between this arithmetic and the in-group plane tests can
    never reject a group containing a true hit — the cull is conservative
    and decisions are bit-identical to the unculled loop (asserted in
    tests/test_grouped.py)."""
    t0x = (aabb6[0] - ox) * ivx
    t1x = (aabb6[3] - ox) * ivx
    t0y = (aabb6[1] - oy) * ivy
    t1y = (aabb6[4] - oy) * ivy
    t0z = (aabb6[2] - oz) * ivz
    t1z = (aabb6[5] - oz) * ivz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                   jnp.minimum(t0y, t1y)),
                       jnp.maximum(jnp.minimum(t0z, t1z), 0.0))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                   jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    return tmin, tmax


# Absolute padding added to every group AABB (plus a 1e-5 relative term) and
# the relative+absolute slack on the per-ray far limit. The slab arithmetic
# differs from the triangle plane test by a few ulps; these margins are ~1000x
# that, so the cull can only ever ACCEPT extra groups (wasted work), never
# reject a group whose triangle would have won.
GROUP_AABB_PAD = 1e-3
T_FAR_SLACK = 1e-3


def _tri_hit(row, ox, oy, oz, dx, dy, dz):
    """Plane-intersection t and barycentric (u, v) of one triangle
    (12 scalars). Raw divide: rays with |den| < 1e-12 produce Inf/NaN,
    every comparison on them is false, and the caller keeps ``ok`` in the
    accept mask — decisions and winning-lane t values match the oracle's
    selected-divide form."""
    (nx, ny, nz, c0, s1x, s1y, s1z, c1, s2x, s2y, s2z, c2) = row
    den = dx * nx + dy * ny + dz * nz
    num = c0 - (ox * nx + oy * ny + oz * nz)
    ok = jnp.abs(den) >= 1e-12
    tt = num / den
    u = (ox * s1x + oy * s1y + oz * s1z) \
        + tt * (dx * s1x + dy * s1y + dz * s1z) - c1
    v = (ox * s2x + oy * s2y + oz * s2z) \
        + tt * (dx * s2x + dy * s2y + dz * s2z) - c2
    inside = ok & (jnp.minimum(u, v) >= 0.0) & (u + v <= 1.0)
    return tt, inside


def _sphere_roots(sph, ox, oy, oz, dx, dy, dz):
    """Quadratic ray/sphere roots (shaders_old.metal:108-136; same op
    order as intersect._sphere_candidates for oracle parity)."""
    scx, scy, scz, rad = sph[:4]
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad
    disc = b * b - 4.0 * a * c
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return pos, t1, t2


def _group_reaches(aabb_ref, g, ox, oy, oz, ivx, ivy, ivz, t_far, live):
    """Block-uniform AABB skip: does any live ray of the program reach
    group ``g``'s box before ``t_far``?"""
    tmin, tmax = _slab_interval([aabb_ref[r, g] for r in range(6)],
                                ox, oy, oz, ivx, ivy, ivz)
    reach = (tmin <= jnp.minimum(tmax, t_far)) & live
    return jnp.max(jnp.where(reach, 1.0, 0.0)) > 0.5


def closest_tris(tri_ref, aabb_ref, n_groups: int, ox, oy, oz, dx, dy, dz,
                 t_best, prim_f):
    """Closest triangle hit: a fori_loop over groups of GROUP triangles,
    skipping a group when no ray of the program reaches its AABB before
    the ray's current best t, and a rolled loop over the group's
    triangles (constants read as dynamically indexed scalars). Host-side
    Morton packing keeps the boxes tight; the skip is conservative (padded
    boxes), so decisions equal the brute-force loop's."""
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    live = jnp.full(ox.shape, True)

    def tri_body(idx, carry):
        t_b, p_f = carry
        tt, inside = _tri_hit([tri_ref[r, idx] for r in range(12)],
                              ox, oy, oz, dx, dy, dz)
        closer = inside & (tt > RAY_TMIN) & (tt < RAY_TMAX) & (tt < t_b)
        return (jnp.where(closer, tt, t_b),
                jnp.where(closer, idx.astype(_F32), p_f))

    def group_body(g, carry):
        t_far = jnp.minimum(carry[0] * (1.0 + T_FAR_SLACK) + T_FAR_SLACK,
                            RAY_TMAX)
        return jax.lax.cond(
            _group_reaches(aabb_ref, g, ox, oy, oz, ivx, ivy, ivz, t_far,
                           live),
            lambda c: jax.lax.fori_loop(g * GROUP, g * GROUP + GROUP,
                                        tri_body, c),
            lambda c: c, carry)

    return jax.lax.fori_loop(0, n_groups, group_body, (t_best, prim_f))


def occluded_tris(tri_ref, aabb_ref, n_groups: int, ox, oy, oz, dx, dy, dz,
                  t_lo, t_max):
    """Shadow any-hit over a (dense, occluder-culled) triangle table: a
    group is skipped when no still-unoccluded ray's [0, t_max] segment
    overlaps its box (conservative, so occlusion decisions are those of
    the full loop). A hit counts for t_lo < t < t_max. Returns bools."""
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_seg = t_max * (1.0 + T_FAR_SLACK) + T_FAR_SLACK

    def tri_body(idx, occ):
        tt, inside = _tri_hit([tri_ref[r, idx] for r in range(12)],
                              ox, oy, oz, dx, dy, dz)
        return occ | (inside & (tt > t_lo) & (tt < t_max))

    def group_body(g, occ):
        return jax.lax.cond(
            _group_reaches(aabb_ref, g, ox, oy, oz, ivx, ivy, ivz, t_seg,
                           ~occ),
            lambda o: jax.lax.fori_loop(g * GROUP, g * GROUP + GROUP,
                                        tri_body, o),
            lambda o: o, occ)

    return jax.lax.fori_loop(0, n_groups, group_body,
                             jnp.zeros(ox.shape, bool))


def spheres_closest(sph_ref, num_tris: int, num_spheres: int,
                    ox, oy, oz, dx, dy, dz, t_best, prim_f):
    """Analytic spheres after the triangles (ties keep the triangle, like
    the oracle's first-min argmin over [tris..., spheres...])."""
    for s_idx in range(num_spheres):
        spos, t1, t2 = _sphere_roots([sph_ref[r, s_idx] for r in range(4)],
                                     ox, oy, oz, dx, dy, dz)
        t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
        t2_ok = (t2 > RAY_TMIN) & (t2 < RAY_TMAX)
        tt = jnp.where(t1_ok, t1, t2)
        closer = spos & (t1_ok | t2_ok) & (tt < t_best)
        t_best = jnp.where(closer, tt, t_best)
        prim_f = jnp.where(closer, _F32(num_tris + s_idx), prim_f)
    return t_best, prim_f


def spheres_occluded(sph_ref, num_spheres: int, occ, ox, oy, oz, dx, dy, dz,
                     t_lo, t_max):
    for s_idx in range(num_spheres):
        spos, t1, t2 = _sphere_roots([sph_ref[r, s_idx] for r in range(4)],
                                     ox, oy, oz, dx, dy, dz)
        t1_ok = (t1 > t_lo) & (t1 < t_max)
        t2_ok = (t2 > t_lo) & (t2 < t_max)
        occ = occ | (spos & (t1_ok | t2_ok))
    return occ


def _path_kernel(config: RenderConfig, n_pixels: int, num_tris: int,
                 num_spheres: int, emit_records: bool, records_only: bool,
                 n_groups: int, n_groups_sh: int, blocked: bool,
                 offsets_ref, rid_base_ref, cam_ref, light_ref, tri_ref,
                 sph_ref, atab_ref, aabb_ref, shadow_ref, sh_aabb_ref,
                 hal_ref, *rest):
    """One program: TILE rays through the full spp x bounces path trace.

    With ``emit_records``, also writes one int32 visibility record per
    (sample, bounce, ray): code = (winning prim + 1) + OCC_BIT * occluded
    (0 = miss; sphere s records as num_tris + s + 1). The records replay the
    kernel's discrete decisions in the backward (ops/pallas_shade.py). In
    this mode (unless ``records_only``) the random draws arrive as
    pregenerated input planes (``pregen_draws``) instead of being
    radical-inversed in the loop.

    ``tri_ref`` is the zero-padded [12, GROUP * n_groups] geometry table
    with its group AABBs ``aabb_ref``; ``shadow_ref``/``sh_aabb_ref`` the
    same for the shadow loop (occluder-culled triangles packed dense).
    Padding columns are all-zero, so their plane tests fail the |den| guard
    and can never win or occlude. ``hal_ref`` holds the per-bounce Halton
    bases (``halton_bounce_table``): the bounce loop runs at run time, so
    the kernel's code does not grow with the bounce count."""
    reads_draws = emit_records and not records_only
    if reads_draws:
        (nee0_ref, nee1_ref, cos0_ref, cos1_ref, jx_ref, jy_ref,
         out_r_ref, out_g_ref, out_b_ref, rec_out_ref) = rest
    else:
        out_r_ref, out_g_ref, out_b_ref = rest[:3]
        rec_out_ref = rest[3] if emit_records else None
    W = config.width
    H = config.height
    B = config.bounces
    he = _F32(config.area_light_half_extent)

    pid = pl.program_id(0)
    lane = jax.lax.broadcasted_iota(_I32, (TILE,), 0)
    # Global pixel id: rid_base is the shard's first pixel (0 single-device;
    # axis_index * shard_size under shard_map) so sharded rendering keeps
    # every per-pixel quantity a pure function of the global pixel.
    rid = rid_base_ref[0, 0] + pid * TILE + lane
    if blocked:
        # Pixel-tile mapping: each program owns a compact
        # BLOCK_W x (TILE / BLOCK_W) pixel block, so its frustum / shadow
        # cone is compact and the block-uniform AABB skip rejects more
        # boxes. A pure permutation of the offsets input and the outputs
        # host-side; per-pixel math is unchanged.
        nbx = W // BLOCK_W
        blk = rid_base_ref[0, 0] // TILE + pid
        px = ((blk % nbx) * BLOCK_W + lane % BLOCK_W).astype(_F32)
        py = ((blk // nbx) * _block_h() + lane // BLOCK_W).astype(_F32)
    else:
        px = (rid % W).astype(_F32)
        py = (rid // W).astype(_F32)
    in_image = rid < n_pixels

    off = offsets_ref[...]  # [TILE] uint32

    cam = [cam_ref[0, k] for k in range(12)]
    pos, uhw, vhh, wv = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    lcx, lcy, lcz = light_ref[0, 0], light_ref[0, 1], light_ref[0, 2]
    lr, lg, lb = light_ref[0, 3], light_ref[0, 4], light_ref[0, 5]

    n_prims = num_tris + num_spheres

    def halton(ih, row):
        return _radical_inverse(ih, hal_ref[row, 0], hal_ref[row, 1],
                                hal_ref[row, 2].astype(_I32))

    def closest(ox, oy, oz, dx, dy, dz):
        """Running-min closest hit. Returns (hit, t, prim_f, normal xyz,
        diffuse rgb, emissive rgb, is_em)."""
        t_best = jnp.full((TILE,), BIG, _F32)
        prim_f = t_best * 0.0 - 1.0  # winning primitive index, -1 = miss
        t_best, prim_f = closest_tris(tri_ref, aabb_ref, n_groups,
                                      ox, oy, oz, dx, dy, dz, t_best, prim_f)
        t_best, prim_f = spheres_closest(sph_ref, num_tris, num_spheres,
                                         ox, oy, oz, dx, dy, dz,
                                         t_best, prim_f)
        hit = t_best < BIG * 0.5
        # Miss lanes gather primitive 0; every consumer gates by ``hit``.
        pc = jnp.clip(prim_f, 0.0, _F32(n_prims - 1)).astype(_I32)
        at = [atab_ref[r, pc] for r in range(NATTR)]
        nhx, nhy, nhz = at[0], at[1], at[2]
        if num_spheres:
            # Sphere normal: (hit point - center) normalized
            # (shaders_old.metal:122-123); select over the triangle normal
            # (zeros in the table's sphere columns).
            sphere_won = hit & (prim_f >= _F32(num_tris))
            t_s = jnp.where(sphere_won, t_best, 0.0)
            nvx = ox + dx * t_s - at[10]
            nvy = oy + dy * t_s - at[11]
            nvz = oz + dz * t_s - at[12]
            inv = jax.lax.rsqrt(jnp.maximum(
                nvx * nvx + nvy * nvy + nvz * nvz, 1e-6))
            nhx = jnp.where(sphere_won, nvx * inv, nhx)
            nhy = jnp.where(sphere_won, nvy * inv, nhy)
            nhz = jnp.where(sphere_won, nvz * inv, nhz)
        return (hit, t_best, prim_f, nhx, nhy, nhz, at[3], at[4], at[5],
                at[6], at[7], at[8], at[9])

    def occluded_q(ox, oy, oz, dx, dy, dz, t_max):
        """Shadow any-hit with per-ray t_max (raytrace.metal:79-85).
        The shadow table holds only the triangles that can block a
        surface->light segment (intersect.potential_occluders, when given);
        decisions are bit-identical to the full loop."""
        occ = occluded_tris(shadow_ref, sh_aabb_ref, n_groups_sh,
                            ox, oy, oz, dx, dy, dz, 0.0, t_max)
        return spheres_occluded(sph_ref, num_spheres, occ, ox, oy, oz,
                                dx, dy, dz, 0.0, t_max)

    def one_sample(n_i32, carry):
        acc_r, acc_g, acc_b = carry
        if reads_draws:
            js = pl.ds(n_i32 * TILE, TILE)
            jx = jx_ref[js]
            jy = jy_ref[js]
            ih = None
        else:
            ih = off + n_i32.astype(_U32)
            jx, jy = camera_jitter(ih, config)

        # Camera ray (sampling.metal:125-157); basis prescaled on host.
        s = ((px + jx) / _F32(W)) * 2.0 - 1.0
        t = -(((py + jy) / _F32(H)) * 2.0 - 1.0)
        dx = s * uhw[0] + t * vhh[0] - wv[0]
        dy = s * uhw[1] + t * vhh[1] - wv[1]
        dz = s * uhw[2] + t * vhh[2] - wv[2]
        dx, dy, dz = _normalize3(dx, dy, dz)
        ox = px * 0.0 + pos[0]
        oy = px * 0.0 + pos[1]
        oz = px * 0.0 + pos[2]

        one = px * 0.0 + 1.0
        zero = px * 0.0

        def one_bounce(bounce, st):
            (ox, oy, oz, dx, dy, dz, col_r, col_g, col_b,
             a_r, a_g, a_b, alive) = st
            (hit, t_hit, prim_f, nhx, nhy, nhz, dfr, dfg, dfb,
             emr, emg, emb, isem) = closest(ox, oy, oz, dx, dy, dz)
            is_em = isem > 0.5
            active = alive & hit
            hit_light = active & is_em
            # Emissive hit REPLACES the accumulator (raytrace.metal:57-60).
            a_r = jnp.where(hit_light, emr, a_r)
            a_g = jnp.where(hit_light, emg, a_g)
            a_b = jnp.where(hit_light, emb, a_b)
            surf = active & ~is_em

            t_safe = jnp.where(surf, t_hit, 0.0)
            hx = ox + dx * t_safe + nhx * 1e-3
            hy = oy + dy * t_safe + nhy * 1e-3
            hz = oz + dz * t_safe + nhz * 1e-3

            # NEE (sampleAreaLight, sampling.metal:198-236): hardcoded frame
            # right=(he,0,0), up=(0,0,he), light normal (0,-1,0).
            bs = pl.ds((n_i32 * B + bounce) * TILE, TILE)
            if reads_draws:
                u_nee0 = nee0_ref[bs]
                u_nee1 = nee1_ref[bs]
            else:
                u_nee0 = halton(ih, bounce * 4 + 0)
                u_nee1 = halton(ih, bounce * 4 + 1)
            w0 = u_nee0 * 2.0 - 1.0
            w1 = u_nee1 * 2.0 - 1.0
            tlx = lcx + he * w0 - hx
            tly = lcy - hy
            tlz = lcz + he * w1 - hz
            ldist = jnp.sqrt(jnp.maximum(
                tlx * tlx + tly * tly + tlz * tlz, 0.0))
            inv_d = 1.0 / jnp.maximum(ldist, 1e-3)
            ldx, ldy, ldz = tlx * inv_d, tly * inv_d, tlz * inv_d
            cos_l = jnp.clip(ldy, 0.0, 1.0)  # -ld . (0,-1,0)
            fall = inv_d * inv_d * cos_l
            cos_s = jnp.clip(nhx * ldx + nhy * ldy + nhz * ldz, 0.0, 1.0)
            gain = fall * cos_s

            col_r = jnp.where(surf, col_r * dfr, col_r)
            col_g = jnp.where(surf, col_g * dfg, col_g)
            col_b = jnp.where(surf, col_b * dfb, col_b)

            occ = occluded_q(hx, hy, hz, ldx, ldy, ldz, ldist - 1e-3)
            if emit_records:
                code = (prim_f + 1.0) + jnp.where(occ, _F32(OCC_BIT),
                                                  _F32(0.0))
                rec_out_ref[bs] = code.astype(_I32)
            contrib = surf & ~occ
            w_c = jnp.where(contrib, gain, 0.0)
            a_r = a_r + lr * w_c * col_r
            a_g = a_g + lg * w_c * col_g
            a_b = a_b + lb * w_c * col_b

            # Cosine bounce (sampling.metal:39-66).
            if reads_draws:
                u0 = cos0_ref[bs]
                u1 = cos1_ref[bs]
            else:
                u0 = halton(ih, bounce * 4 + 2)
                u1 = halton(ih, bounce * 4 + 3)
            phi = _F32(2.0 * math.pi) * u0
            cth = jnp.sqrt(u1)
            sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 0.0))
            lx = sth * jnp.cos(phi)
            ly = cth
            lz2 = sth * jnp.sin(phi)
            ax, ay, az = _F32(0.0072), _F32(1.0), _F32(0.0034)
            rx = nhy * az - nhz * ay
            ry = nhz * ax - nhx * az
            rz = nhx * ay - nhy * ax
            rx, ry, rz = _normalize3(rx, ry, rz)
            fx = ry * nhz - rz * nhy
            fy = rz * nhx - rx * nhz
            fz = rx * nhy - ry * nhx
            sdx = lx * rx + ly * nhx + lz2 * fx
            sdy = lx * ry + ly * nhy + lz2 * fy
            sdz = lx * rz + ly * nhz + lz2 * fz

            ox = jnp.where(surf, hx, ox)
            oy = jnp.where(surf, hy, oy)
            oz = jnp.where(surf, hz, oz)
            dx = jnp.where(surf, sdx, dx)
            dy = jnp.where(surf, sdy, dy)
            dz = jnp.where(surf, sdz, dz)
            alive = surf
            return (ox, oy, oz, dx, dy, dz, col_r, col_g, col_b,
                    a_r, a_g, a_b, alive)

        st = jax.lax.fori_loop(0, B, one_bounce,
                               (ox, oy, oz, dx, dy, dz, one, one, one,
                                zero, zero, zero, in_image))
        a_r, a_g, a_b = st[9:12]
        return acc_r + a_r, acc_g + a_g, acc_b + a_b

    zero = px * 0.0
    acc_r, acc_g, acc_b = jax.lax.fori_loop(
        0, config.spp, one_sample, (zero, zero, zero))
    inv_spp = _F32(1.0 / config.spp)
    out_r_ref[...] = acc_r * inv_spp
    out_g_ref[...] = acc_g * inv_spp
    out_b_ref[...] = acc_b * inv_spp


def group_aabbs(verts):
    """[T, 3, 3] verts -> per-GROUP AABB table [6, ng] (rows: lo xyz, hi
    xyz). The trailing partial group is padded with copies of the last
    triangle so padding never widens a box. Conservative margin:
    GROUP_AABB_PAD + 1e-5 relative. Shared by the path and MIS packers."""
    n = verts.shape[0]
    ng = max(1, (n + GROUP - 1) // GROUP)
    pad = ng * GROUP - n
    v = jnp.concatenate(
        [verts, jnp.broadcast_to(verts[-1:], (pad, 3, 3))]) \
        if pad else verts
    v = v.reshape(ng, GROUP * 3, 3)
    margin = GROUP_AABB_PAD + 1e-5 * jnp.max(jnp.abs(verts))
    lo = jnp.min(v, axis=1) - margin      # [ng, 3]
    hi = jnp.max(v, axis=1) + margin
    return jnp.concatenate([lo.T, hi.T], axis=0).astype(_F32)


def pad_geo(x):
    """Zero-pad geometry columns to a whole number of groups."""
    p = ((x.shape[1] + GROUP - 1) // GROUP) * GROUP
    return jnp.pad(x, ((0, 0), (0, p - x.shape[1])))


def pack_shadow_tables(tri, verts, occluders, tri_geo, aabb_main):
    """Dense occluder-culled shadow geometry + its group AABB table (the
    main tables when no cull is supplied)."""
    if occluders is None:
        return tri_geo, aabb_main
    keep = [i for i, k in enumerate(occluders) if k]
    if not keep:
        # One all-zero group behind a box at 1e20 that every ray misses.
        return (jnp.zeros((12, GROUP), _F32),
                jnp.full((6, 1), 1e20, _F32))
    kidx = jnp.asarray(keep, jnp.int32)
    return pad_geo(tri[:12, kidx]), group_aabbs(verts[kidx])


def camera_vec(scene: Scene, config: RenderConfig) -> jnp.ndarray:
    """[1, 12] camera row: position, then the basis prescaled by the
    half-extents of the image plane."""
    cam = scene.camera
    res_x, res_y = config.resolution
    aspect = float(res_x // res_y) if config.integer_aspect else res_x / res_y
    half_width = jnp.tan(jnp.asarray(cam.horizontal_fov, _F32) / 2.0)
    half_height = half_width / _F32(aspect)
    u, v, w = smp.camera_basis(jnp.asarray(cam.direction, _F32),
                               jnp.asarray(cam.up, _F32))
    return jnp.concatenate([
        jnp.asarray(cam.position, _F32), u * half_width, v * half_height, w,
    ]).reshape(1, 12)


def _pack_inputs(scene: Scene, config: RenderConfig, occluders=None):
    """Host-side marshalling: triangle constants to a [NROWS, T] table,
    camera to a prescaled-basis vector, light to scalars — the analog of the
    reference's convert*/makeBuffer step (RTrace/computeShader.swift:13-41).

    Returns (tri_geo [12, P_gpad] zero-padded to a GROUP multiple, cam_vec,
    light_vec, sph, atab, aabb, shadow_geo with only the
    ``occluders``-kept triangles packed dense, shadow aabb). Zero padding
    columns produce den == 0 in the plane test, which the |den| >= 1e-12
    guard rejects — they can never win a hit or occlude."""
    compiled = compile_scene(scene.triangles, lane_pad=1)
    tri = jnp.stack([
        compiled.n[:, 0], compiled.n[:, 1], compiled.n[:, 2], compiled.c0,
        compiled.s1[:, 0], compiled.s1[:, 1], compiled.s1[:, 2], compiled.c1,
        compiled.s2[:, 0], compiled.s2[:, 1], compiled.s2[:, 2], compiled.c2,
        compiled.diffuse[:, 0], compiled.diffuse[:, 1], compiled.diffuse[:, 2],
        compiled.is_emissive.astype(_F32),
        compiled.emissive[:, 0], compiled.emissive[:, 1],
        compiled.emissive[:, 2],
    ])  # [NROWS, T]

    cam_vec = camera_vec(scene, config)
    light = scene.light
    light_vec = jnp.concatenate([
        jnp.asarray(light.center, _F32).reshape(-1),
        jnp.asarray(light.color, _F32).reshape(-1),
    ]).reshape(1, 6)

    sp = scene.spheres
    if sp.num_spheres:
        sph = jnp.stack([
            sp.center[:, 0], sp.center[:, 1], sp.center[:, 2], sp.radius,
            sp.diffuse[:, 0], sp.diffuse[:, 1], sp.diffuse[:, 2],
            (jnp.linalg.norm(sp.emissive, axis=-1) > 0.0).astype(_F32),
            sp.emissive[:, 0], sp.emissive[:, 1], sp.emissive[:, 2],
        ])  # [SROWS, S]
    else:
        sph = jnp.zeros((SROWS, 1), _F32)  # placeholder; loops are empty

    # Attribute table [NATTR, tris + spheres], column order matching the
    # kernel's prim_f encoding (triangles first, then spheres).
    n_t = scene.triangles.num_triangles
    zt = jnp.zeros((3, n_t), _F32)
    tri_cols = jnp.concatenate([
        tri[ROW_NX:ROW_NZ + 1],                      # normal
        tri[ROW_DR:ROW_DB + 1],                      # diffuse
        tri[ROW_ER:ROW_EB + 1],                      # emissive
        tri[ROW_ISEM:ROW_ISEM + 1],                  # is_emissive
        zt,                                          # sphere center (n/a)
    ], axis=0)  # [NATTR, T]
    if sp.num_spheres:
        zs = jnp.zeros((3, sp.num_spheres), _F32)
        sph_cols = jnp.concatenate([
            zs,                                      # normal (computed)
            sph[4:7],                                # diffuse
            sph[8:11],                               # emissive
            sph[7:8],                                # is_emissive
            sph[0:3],                                # center
        ], axis=0)  # [NATTR, S]
        atab = jnp.concatenate([tri_cols, sph_cols], axis=1)
    else:
        atab = tri_cols
    verts = jnp.asarray(scene.triangles.verts, _F32)
    tri_geo = pad_geo(tri[:12])                      # [12, P_gpad]
    aabb = group_aabbs(verts)
    shadow_geo, aabb_shadow = pack_shadow_tables(tri, verts, occluders,
                                                 tri_geo, aabb)
    return (tri_geo, cam_vec, light_vec, sph, atab, aabb, shadow_geo,
            aabb_shadow)


def pregen_draws(config: RenderConfig, local_offsets=None):
    """The trace kernel's random draws (camera jitter + per-bounce
    NEE/cosine u-pairs) as tile-major planes, in plain jnp: a pure function
    of (config, pixel offsets), hence step-invariant across a training or
    benchmark loop. Pass the result to ``render_path_decoupled_fused(...,
    draws=...)`` from outside the loop to hoist it (XLA may sink it into a
    ``lax.scan`` body otherwise). The values are the same f32 Halton digits
    the kernels compute in ``records_only`` mode. Without
    ``local_offsets`` the planes follow the single-device pixel order the
    trace kernel uses (pixel tiles when ``use_blocked_tiles``); shards pass
    their own linear offsets. Returns the 6-tuple
    (nee_u0, nee_u1, cos_u0, cos_u1, jitter_x, jitter_y); the first four
    are [tiles, spp, bounces, TILE] flattened, the jitters [tiles, spp,
    TILE] flattened."""
    if local_offsets is None:
        local_offsets = pixel_rng_offsets(config)
        if use_blocked_tiles(config, False):
            local_offsets = to_blocked(local_offsets, config)
    n_local = local_offsets.shape[0]
    n_padded = padded_len(n_local)
    off = jnp.pad(local_offsets, (0, n_padded - n_local)).reshape(-1, 1, TILE)
    ih = off + jnp.arange(config.spp, dtype=_U32).reshape(1, -1, 1)
    jx, jy = camera_jitter(ih, config)

    def per_bounce(k):
        return jnp.stack([_halton_tile(ih, 2 + b * 5 + k)
                          for b in range(config.bounces)], axis=2).reshape(-1)

    return (per_bounce(0), per_bounce(1), per_bounce(2), per_bounce(3),
            jx.reshape(-1), jy.reshape(-1))


def _render_pallas_impl(scene: Scene, config: RenderConfig,
                        interpret=None, emit_records: bool = False,
                        raw_records: bool = False,
                        records_only: bool = False,
                        local_offsets=None, rid_base=None,
                        flat_output: bool = False, draws=None,
                        occluders=None):
    """Single-device entry when local_offsets/rid_base are None; under
    shard_map, pass the shard's RNG-offset slice and its global first pixel
    id ([1, 1] i32) — outputs are then the shard's flat [local, 3] hdr.

    ``records_only`` (implies raw_records) drops the six random-draw planes
    from the record stream — the backward kernel regenerates the Halton
    draws instead (pallas_shade recompute_rng mode). At 1024^2 x 256 spp x
    3 bounces the f32 draw planes alone are ~18 GB; the int32 records are
    3.2 GB."""
    interpret = route.interpret_mode(interpret)
    n_pixels = config.num_pixels
    num_tris = scene.triangles.num_triangles
    num_spheres = scene.spheres.num_spheres
    assert num_tris + num_spheres + 1 < OCC_BIT, "record encoding limit"
    # Pixel-tile mapping: single-device, divisible resolution, and not the
    # decoded-TraceAux mode (its decode assumes linear pixel order).
    blocked = use_blocked_tiles(config, local_offsets is not None) \
        and not (emit_records and not (raw_records or records_only))
    if occluders is not None:
        assert len(occluders) == num_tris, (len(occluders), num_tris)
    (tri, cam_vec, light_vec, sph, atab, aabb, shadow_geo,
     aabb_shadow) = _pack_inputs(scene, config, occluders=occluders)
    if local_offsets is None:
        local_offsets = pixel_rng_offsets(config)
        if blocked:
            local_offsets = to_blocked(local_offsets, config)
    if rid_base is None:
        rid_base = jnp.zeros((1, 1), _I32)
    n_local = local_offsets.shape[0]
    n_padded = padded_len(n_local)
    offsets = jnp.pad(local_offsets, (0, n_padded - n_local))
    n_tiles = n_padded // TILE

    kernel = partial(_path_kernel, config, n_pixels, num_tris, num_spheres,
                     emit_records, records_only, aabb.shape[1],
                     aabb_shadow.shape[1], blocked)
    tile_spec = pl.BlockSpec((TILE,), lambda i: (i,))
    plane = jax.ShapeDtypeStruct((n_padded,), _F32)
    out_shapes = [plane, plane, plane]
    out_specs = [tile_spec, tile_spec, tile_spec]
    draw_arrays = ()
    if emit_records:
        nsb = config.spp * config.bounces
        sb_spec = pl.BlockSpec((nsb * TILE,), lambda i: (i,))
        out_shapes.append(jax.ShapeDtypeStruct((n_padded * nsb,), _I32))
        out_specs.append(sb_spec)
        if not records_only:
            if draws is not None:
                expect = [(n_padded * nsb,)] * 4 + [(n_padded * config.spp,)] * 2
                got = [tuple(d.shape) for d in draws]
                if got != expect:
                    raise ValueError(
                        "draws= does not match this (config, shard): expected"
                        f" plane shapes {expect}, got {got} — regenerate with"
                        " pallas_path.pregen_draws(config, local_offsets)")
            draw_arrays = tuple(draws) if draws is not None else \
                pregen_draws(config, local_offsets)
    if draws is not None and (records_only or not emit_records):
        # A caller-supplied pregen that this mode cannot consume is a bug at
        # the call site — fail loudly instead of silently re-deriving.
        raise ValueError(
            "draws= was passed but this mode regenerates draws in-kernel "
            f"(records_only={records_only}, emit_records={emit_records}); "
            "drop the argument or disable records_only")
    s_spec = pl.BlockSpec((config.spp * TILE,), lambda i: (i,))
    draw_specs = ([sb_spec] * 4 + [s_spec] * 2) if draw_arrays else []
    tables = tuple(route.pad_pow2(t) for t in
                   (cam_vec, light_vec, tri, sph, atab, aabb, shadow_geo,
                    aabb_shadow, halton_bounce_table(config.bounces)))
    outs = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[tile_spec, pl.no_block_spec]
        + [pl.no_block_spec] * len(tables) + draw_specs,
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shapes),
        backend="triton",
        compiler_params=route.compiler_params(),
        interpret=interpret,
        name="path_trace",
    )(offsets, rid_base, *tables, *draw_arrays)
    r, g, b = outs[:3]
    hdr = jnp.stack([r, g, b], axis=-1)
    if flat_output:
        hdr = hdr[:n_local]
    elif blocked:
        hdr = from_blocked(hdr[:n_local], config)
    else:
        hdr = hdr[:n_local].reshape(config.height, config.width, 3)
    if not emit_records:
        return hdr
    if raw_records or records_only:
        # Undecoded tile-major planes, exactly as the kernel wrote them —
        # consumed relayout-free by the backward kernel
        # (ops/pallas_shade.py) with identical BlockSpecs.
        return hdr, tuple(outs[3:]) + tuple(draw_arrays)

    # Decode per-(sample, bounce) planes: [tile, sample, bounce, TILE].
    def sb(x):
        x = x.reshape(n_tiles, config.spp, config.bounces, TILE)
        return jnp.moveaxis(x, 0, 2).reshape(
            config.spp, config.bounces, n_padded)[:, :, :n_local]

    def s(x):
        x = x.reshape(n_tiles, config.spp, TILE)
        return jnp.moveaxis(x, 0, 1).reshape(
            config.spp, n_padded)[:, :n_local]

    rec, nee0, nee1, cos0, cos1 = (sb(o) for o in
                                   (outs[3],) + tuple(draw_arrays[:4]))
    jx, jy = (s(o) for o in draw_arrays[4:6])
    return hdr, TraceAux(records=rec, nee_u0=nee0, nee_u1=nee1,
                         cos_u0=cos0, cos_u1=cos1, jitter_x=jx, jitter_y=jy)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def render_path_pallas(scene: Scene, config: RenderConfig) -> jnp.ndarray:
    """Variant-B path trace via the megakernel. Returns [H, W, 3] HDR.
    Differentiable: the backward re-traces with record emission and runs
    the hand-written backward (ops/pallas_shade.py). Forward-only callers
    pay nothing for it; gradient callers pay one extra (record-emitting)
    trace, so steady-state training loops should call
    ``render_path_decoupled_fused`` directly (one trace total)."""
    return _render_pallas_impl(scene, config)


def _fwd(scene, config):
    return _render_pallas_impl(scene, config), scene


def _bwd(config, scene, g):
    from .pallas_shade import render_path_decoupled_fused
    _, vjp = jax.vjp(lambda s: render_path_decoupled_fused(s, config), scene)
    return vjp(g)


render_path_pallas.defvjp(_fwd, _bwd)


def render_path_pallas_interpret(scene: Scene, config: RenderConfig):
    """Interpreter-mode run (CPU) for parity tests."""
    return _render_pallas_impl(scene, config, interpret=True)

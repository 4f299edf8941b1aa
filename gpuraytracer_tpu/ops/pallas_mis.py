"""Variant-A 3-strategy MIS megakernel (Pallas, Triton route).

The reference's heaviest workload: ``drawTriangle`` +
``recursiveMultiImportanceSampling`` (Sources/gpuRaytracer/shaders.metal:543-707)
— per pixel: ``camera_rays`` primary rays, each shaded with
``mis_samples/3`` samples of three strategies (light / cosine / VNDF-GGX),
power-heuristic weighted, with one unweighted NEE at the first bounce hit of
the two BSDF strategies. Per sample that is 5 ray-scene traversals (1 light
probe + 2 BSDF closest-hits + 2 secondary light probes) ≈ 3,000
traversals/pixel at reference settings (SURVEY.md §3.2).

One program holds TILE pixels for the whole camera-ray x sample loop, with
the triangle loops of pallas_path (group-AABB-skipped rolled loops). The
reference's per-sample randoms are *pixel-independent* Halton points
(haltonRandom(i, d), shaders.metal:557,564,584,595,617), so they live in a
small table read as scalars: the light-strategy sample position is a plain
scalar broadcast.

All math mirrors render._mis_chunk / sampling.py exactly (same quirks:
D_GGX takes roughness not roughness², light pdf to the light *center*,
β=1 power heuristic); parity vs the jnp oracle is asserted in tests.

Gradients: like ``render_path_pallas``, a custom VJP whose backward is the
VJP of the jnp reference (recompute-based); ``render_mis_fused``
(ops/pallas_mis_bwd.py) is the kernel-speed differentiable path.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from .. import sampling as smp
from ..intersect import compile_scene
from ..render import render_mis
from ..types import RenderConfig, Scene
from . import route
from .pallas_path import (camera_vec, closest_tris, group_aabbs,
                          occluded_tris, pack_shadow_tables, pad_geo,
                          spheres_closest, spheres_occluded)

_F32 = jnp.float32
_U32 = jnp.uint32
_I32 = jnp.int32

TILE = 128                   # pixels per program (power of two)
BIG = 1e30
RAY_TMIN = 1e-3
RAY_TMAX = 1e3
INV_2_32 = float(1.0 / 4294967296.0)
PI = math.pi

# Triangle-constant rows ([NROWS, T] table) — pallas_path's 19 rows plus
# metallic/roughness (the MIS BRDF needs them).
NROWS = 21
(ROW_NX, ROW_NY, ROW_NZ, ROW_C0,
 ROW_S1X, ROW_S1Y, ROW_S1Z, ROW_C1,
 ROW_S2X, ROW_S2Y, ROW_S2Z, ROW_C2,
 ROW_DR, ROW_DG, ROW_DB, ROW_ISEM,
 ROW_ER, ROW_EG, ROW_EB, ROW_MET, ROW_RGH) = range(NROWS)

# Debug bisection knob: include (light, cosine, vndf) strategy contributions.
DEBUG_STRATEGY_MASK = (True, True, True)

# Per-sample random table rows ([NTAB, S]): 5 (u1, u2) pairs.
NTAB = 10
(TAB_LU0, TAB_LU1, TAB_CU0, TAB_CU1, TAB_CSU0, TAB_CSU1,
 TAB_VU0, TAB_VU1, TAB_VSU0, TAB_VSU1) = range(NTAB)

# Attribute-table rows ([NATTR, T + S]): shading attributes gathered per
# closest hit for the winning primitive (as in pallas_path.closest): normal
# xyz (zeros for spheres), diffuse rgb, metallic, roughness, is_emissive,
# sphere-center xyz (zeros for triangles).
NATTR = 12

# Sphere-constant rows ([SROWS, S]): center xyz, radius (geometry only;
# shading attributes come from the attribute table).
SROWS = 4

# Per-sample record bit layout (int32, built with exact integer ops):
# reach1 | reach2<<1 | reach3<<2 | (cos_prim+1)<<REC_SHIFT_C
# | (vndf_prim+1)<<REC_SHIFT_V. 14-bit codes — up to 16382 primitives.
REC_SHIFT_C = 3
REC_SHIFT_V = 17
REC_CODE_MASK = (1 << 14) - 1
REC_MAX_PRIMS = REC_CODE_MASK - 1


def _normalize3(x, y, z):
    # 1e-12 floor (matches sampling.normalize): rsqrt's VJP overflows f32
    # below ~1e-24 — the in-kernel jax.vjp of the half-vector
    # normalize3(v + l) hits it when v ~ -l on masked lanes (inf, then
    # 0 * inf = NaN through the reverse sweep).
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-12))
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _hash_u32(x):
    """xorshift-multiply hash on a u32 tile (shaders.metal:58-69)."""
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _u32_to_f32(x):
    """u32 -> f32 in [0, 1), from two int32-safe halves (exactly the
    oracle's value)."""
    hi = (x >> 16).astype(_I32).astype(_F32)
    lo = (x & _U32(0xFFFF)).astype(_I32).astype(_F32)
    return (hi * 65536.0 + lo) * _F32(INV_2_32)


def _ortho_basis(nx, ny, nz):
    """Branching basis (sampling.metal:159-172): a = |n.x| > 0.9 ? ey : ex,
    tangent = normalize(a - (a.n) n), bitangent = n x tangent."""
    use_y = jnp.abs(nx) > 0.9
    ax = jnp.where(use_y, 0.0, 1.0)
    ay = jnp.where(use_y, 1.0, 0.0)
    an = ax * nx + ay * ny
    tx, ty, tz = _normalize3(ax - an * nx, ay - an * ny, -an * nz)
    bx, by, bz = _cross3(nx, ny, nz, tx, ty, tz)
    return tx, ty, tz, bx, by, bz


def _d_ggx(n_dot_h, a):
    # +1e-12: AD-safety against 0/0 on masked roughness-0 lanes (mirrors
    # sampling.d_ggx exactly — oracle/kernel parity; 1e-20 underflows to
    # zero when the division's VJP squares it).
    f = (n_dot_h * a * a - n_dot_h) * n_dot_h + 1.0
    return (a * a) / (_F32(PI) * f * f + 1e-12)


def _smith_g1(n_dot_v, roughness):
    a = roughness * roughness
    a2 = a * a
    nv2 = jnp.maximum(n_dot_v * n_dot_v, 1e-12)  # sampling.smith_g1_ggx
    return 2.0 / (1.0 + jnp.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))


def _brdf(vx, vy, vz, nx, ny, nz, dfr, dfg, dfb, met, rgh, lx, ly, lz):
    """calculateBRDFContribution (shaders.metal:259-289) on tiles.
    ``v`` is the view dir (= -incoming), ``l`` the light dir. Returns rgb."""
    hx, hy, hz = _normalize3(vx + lx, vy + ly, vz + lz)
    n_dot_v = jnp.abs(_dot3(nx, ny, nz, vx, vy, vz)) + 1e-5
    n_dot_l = jnp.clip(_dot3(nx, ny, nz, lx, ly, lz), 0.0, 1.0)
    n_dot_h = jnp.clip(_dot3(nx, ny, nz, hx, hy, hz), 0.0, 1.0)
    l_dot_h = jnp.clip(_dot3(lx, ly, lz, hx, hy, hz), 0.0, 1.0)

    one_m_met = 1.0 - met
    f0r = 0.04 * one_m_met + dfr * met
    f0g = 0.04 * one_m_met + dfg * met
    f0b = 0.04 * one_m_met + dfb * met
    d = _d_ggx(n_dot_h, rgh)
    p5 = jnp.power(1.0 - l_dot_h, 5.0)
    fr_ = f0r + (1.0 - f0r) * p5
    fg_ = f0g + (1.0 - f0g) * p5
    fb_ = f0b + (1.0 - f0b) * p5
    # Guards mirror sampling.v_smith_ggx_correlated (AD safety on masked
    # roughness-0 lanes; value-preserving on live lanes).
    a = rgh * rgh
    ggx_l = n_dot_v * jnp.sqrt(jnp.maximum(
        (-n_dot_l * a + n_dot_l) * n_dot_l + a, 1e-12))
    ggx_v = n_dot_l * jnp.sqrt(jnp.maximum(
        (-n_dot_v * a + n_dot_v) * n_dot_v + a, 1e-12))
    vis = 0.5 / (ggx_v + ggx_l + 1e-7)
    spec = (d * vis) / (4.0 * n_dot_v * n_dot_l + 1e-7)
    fd = _F32(1.0 / PI)
    out = []
    for df, fs in ((dfr, fr_), (dfg, fg_), (dfb, fb_)):
        k_d = (1.0 - fs) * one_m_met
        out.append(k_d * (df * fd + spec * fs) * n_dot_l)
    return out[0], out[1], out[2]


def _cosine_pdf(nx, ny, nz, dx, dy, dz):
    return jnp.maximum(0.0, _dot3(nx, ny, nz, dx, dy, dz)) * _F32(1.0 / PI)


def _vndf_pdf(vx, vy, vz, nx, ny, nz, lx, ly, lz, rgh):
    """D * G1 * VoH / (4 NoV + 1e-7) (shaders.metal:437-445; the epsilon
    mirrors sampling.vndf_pdf's AD guard). ``v`` = view dir."""
    hx, hy, hz = _normalize3(vx + lx, vy + ly, vz + lz)
    n_dot_h = jnp.abs(_dot3(nx, ny, nz, hx, hy, hz))
    v_dot_h = jnp.abs(_dot3(vx, vy, vz, hx, hy, hz))
    n_dot_v = jnp.abs(_dot3(nx, ny, nz, vx, vy, vz))
    d = _d_ggx(n_dot_h, rgh)
    g1 = _smith_g1(n_dot_v, rgh)
    return (d * g1 * v_dot_h) / (4.0 * n_dot_v + 1e-7)


def _power_heuristic_3(p1, p2, p3, n):
    """β=1 with per-strategy count n (shaders.metal:132-137, called with
    beta=1.0 at :534,574,606)."""
    a = n * p1
    return a / (a + n * p2 + n * p3 + 1e-6)


def _mis_kernel(config: RenderConfig, n_pixels: int, num_tris: int,
                num_spheres: int, emit_records: bool, n_groups: int,
                n_groups_sh: int,
                rid_base_ref, cam_ref, light_ref, tri_ref, sph_ref, tab_ref,
                atab_ref, aabb_ref, shadow_ref, sh_aabb_ref, *rest):
    """One program: TILE pixels through the full variant-A pipeline.
    Outputs raw accumulated color (pre exposure/tonemap), like the oracle.

    With ``emit_records`` (the differentiable fused path,
    ops/pallas_mis_bwd.py), also writes the integrator's discrete decisions:
      rec_refs[0]  per (camera ray, pixel):  int32 camera closest-hit code
                   = prim + 1 (0 = miss); rows [camera ray, TILE]
      rec_refs[1]  per (camera ray, sample, pixel): packed int32
                   (see REC_SHIFT_C/REC_SHIFT_V — 14-bit prim codes);
                   rows [camera ray, sample, TILE]
    These replay the kernel's visibility/argmin decisions in the backward
    kernel, which treats them (correctly) as piecewise constant.

    The triangle loops are pallas_path's (``closest_tris`` /
    ``occluded_tris``) over the zero-padded geometry table ``tri_ref`` and
    the dense occluder-culled shadow table ``shadow_ref``, each with its
    group AABBs. The skip is conservative, so decisions equal the brute
    loop's."""
    out_r_ref, out_g_ref, out_b_ref = rest[:3]
    rec_refs = rest[3:]
    W = config.width
    s_per = config.mis_samples // 3

    pid = pl.program_id(0)
    lane = jax.lax.broadcasted_iota(_I32, (TILE,), 0)
    # Global pixel id (rid_base = the shard's first pixel under shard_map;
    # 0 single-device) — jitter/camera stay pure functions of the global
    # pixel, so sharded rendering is bit-identical per pixel.
    rid = rid_base_ref[0, 0] + pid * TILE + lane
    pxi = rid % W
    pyi = rid // W
    px = pxi.astype(_F32)
    py = pyi.astype(_F32)
    in_image = rid < n_pixels

    cam = [cam_ref[0, k] for k in range(12)]
    pos, uhw, vhh, wv = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    # Light: center(3), emitted_radiance(3), width, depth, normal(3),
    # tangent(3), bitangent(3) — frame precomputed host-side with the same
    # branching basis as the oracle.
    lt = [light_ref[0, k] for k in range(17)]
    lcx, lcy, lcz = lt[0:3]
    ler, leg, leb = lt[3:6]
    lw, ld = lt[6], lt[7]
    lnx, lny, lnz = lt[8:11]
    ltx, lty, ltz = lt[11:14]
    lbx, lby, lbz = lt[14:17]

    n_prims = num_tris + num_spheres

    def closest_full(ox, oy, oz, dx, dy, dz):
        """Closest hit returning full shading attrs. Only (t_best, prim_f)
        are carried through the primitive loop; the attributes are gathered
        for the winner afterwards."""
        t_best = jnp.full((TILE,), BIG, _F32)
        prim_f = t_best * 0.0 - 1.0
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
            nvx = ox + dx * t_s - at[9]
            nvy = oy + dy * t_s - at[10]
            nvz = oz + dz * t_s - at[11]
            inv = jax.lax.rsqrt(jnp.maximum(
                nvx * nvx + nvy * nvy + nvz * nvz, 1e-6))
            nhx = jnp.where(sphere_won, nvx * inv, nhx)
            nhy = jnp.where(sphere_won, nvy * inv, nhy)
            nhz = jnp.where(sphere_won, nvz * inv, nhz)
        return (hit, t_best, prim_f, nhx, nhy, nhz, at[3], at[4], at[5],
                at[6], at[7], at[8])

    def light_reachable(ox, oy, oz, dx, dy, dz, t_max):
        """No occluder strictly short of the light-sample distance — the
        well-conditioned form of the reference's closest-hit-is-emissive
        probe (shaders.metal:519-541; see render._direct_light_contribution
        for why). ``occluders`` statically culls triangles that provably
        cannot block a surface->light segment
        (intersect.potential_occluders); decisions are bit-identical."""
        occ = occluded_tris(shadow_ref, sh_aabb_ref, n_groups_sh,
                            ox, oy, oz, dx, dy, dz, RAY_TMIN, t_max)
        occ = spheres_occluded(sph_ref, num_spheres, occ, ox, oy, oz,
                               dx, dy, dz, RAY_TMIN, t_max)
        return ~occ

    def square_light_pdf(p_x, p_y, p_z, dx, dy, dz):
        """pdf to the light *center* (shaders.metal:315-326 quirk)."""
        tox = lcx - p_x
        toy = lcy - p_y
        toz = lcz - p_z
        dist2 = tox * tox + toy * toy + toz * toz
        cos_t = jnp.maximum(0.0, -(dx * lnx + dy * lny + dz * lnz))
        return dist2 / (lw * ld * cos_t + 1e-6)

    def direct_light(p_x, p_y, p_z, nx, ny, nz, inx, iny, inz,
                     dfr, dfg, dfb, met, rgh, u0, u1, active,
                     use_heuristic):
        """calculateDirectLightSamplingContribution (shaders.metal:519-541).
        ``u0, u1`` are table scalars; the light sample point is scalar too."""
        ox = p_x + nx * 1e-4
        oy = p_y + ny * 1e-4
        oz = p_z + nz * 1e-4
        sx = lcx + ltx * ((u0 - 0.5) * lw) + lbx * ((u1 - 0.5) * ld)
        sy = lcy + lty * ((u0 - 0.5) * lw) + lby * ((u1 - 0.5) * ld)
        sz = lcz + ltz * ((u0 - 0.5) * lw) + lbz * ((u1 - 0.5) * ld)
        tox, toy, toz = sx - ox, sy - oy, sz - oz
        dist = jnp.sqrt(jnp.maximum(
            tox * tox + toy * toy + toz * toz, 1e-30))
        # Plain division, not reciprocal-multiply: the reference's first
        # Halton sample (halton(0, d) == 0) lands exactly on the light
        # rectangle corner, so the closest-hit classification of the light
        # probe sits on an FP knife edge — the kernel must produce the same
        # ULPs as the oracle (direct_square_light_sample divides).
        ldx, ldy, ldz = tox / dist, toy / dist, toz / dist
        pdf_l = square_light_pdf(p_x, p_y, p_z, ldx, ldy, ldz)
        reach = light_reachable(ox, oy, oz, ldx, ldy, ldz,
                                dist * (1.0 - 1e-4))
        hit_light = active & reach
        vx, vy, vz = -inx, -iny, -inz
        br, bg, bb = _brdf(vx, vy, vz, nx, ny, nz, dfr, dfg, dfb, met, rgh,
                           ldx, ldy, ldz)
        inv_pdf = 1.0 / pdf_l
        cr = br * ler * inv_pdf
        cg = bg * leg * inv_pdf
        cb = bb * leb * inv_pdf
        if use_heuristic:
            pdf_c = _cosine_pdf(nx, ny, nz, ldx, ldy, ldz)
            pdf_v = _vndf_pdf(vx, vy, vz, nx, ny, nz, ldx, ldy, ldz, rgh)
            w = _power_heuristic_3(pdf_l, pdf_c, pdf_v, _F32(s_per))
            cr, cg, cb = cr * w, cg * w, cb * w
        zero = cr * 0.0
        return (jnp.where(hit_light, cr, zero),
                jnp.where(hit_light, cg, zero),
                jnp.where(hit_light, cb, zero), reach)

    def bounce_strategy(p_x, p_y, p_z, nx, ny, nz, inx, iny, inz,
                        dfr, dfg, dfb, met, rgh, active,
                        sdx, sdy, sdz, pdf_self, w, su0, su1):
        """Shared cosine/VNDF body (shaders.metal:562-623). Returns the rgb
        contribution plus the discrete decisions (winning prim, secondary
        light reach) for the record stream."""
        ox = p_x + nx * 1e-4
        oy = p_y + ny * 1e-4
        oz = p_z + nz * 1e-4
        (hit, t2, prim2, n2x, n2y, n2z, d2r, d2g, d2b, m2, r2,
         isem2) = closest_full(ox, oy, oz, sdx, sdy, sdz)
        vx, vy, vz = -inx, -iny, -inz
        br, bg, bb = _brdf(vx, vy, vz, nx, ny, nz, dfr, dfg, dfb, met, rgh,
                           sdx, sdy, sdz)
        # Double-where reciprocal (mirrors render._bounce_strategy): the
        # VNDF pdf is exactly 0 on roughness-0 lanes; 1/0 = inf would make
        # the weighted product NaN in reverse mode.
        pdf_ok = pdf_self > 0.0
        inv_pdf = jnp.where(pdf_ok, 1.0 / jnp.where(pdf_ok, pdf_self, 1.0),
                            0.0)

        hit_light = active & hit & (isem2 > 0.5)
        ltr = w * br * ler * inv_pdf
        ltg = w * bg * leg * inv_pdf
        ltb = w * bb * leb * inv_pdf

        hit_geo = active & hit & (isem2 <= 0.5)
        t_safe = jnp.where(hit_geo, t2, 0.0)
        bpx = ox + sdx * t_safe
        bpy = oy + sdy * t_safe
        bpz = oz + sdz * t_safe
        sr, sg, sb, sec_reach = direct_light(
            bpx, bpy, bpz, n2x, n2y, n2z, sdx, sdy, sdz,
            d2r, d2g, d2b, m2, r2, su0, su1, hit_geo, False)
        gr = br * inv_pdf * sr
        gg = bg * inv_pdf * sg
        gb = bb * inv_pdf * sb
        zero = ltr * 0.0
        return (jnp.where(hit_light, ltr, zero) + jnp.where(hit_geo, gr, zero),
                jnp.where(hit_light, ltg, zero) + jnp.where(hit_geo, gg, zero),
                jnp.where(hit_light, ltb, zero) + jnp.where(hit_geo, gb, zero),
                prim2, sec_reach)

    def one_camera_ray(i_i32, carry):
        acc_r, acc_g, acc_b = carry
        # hashRandom jitter (shaders.metal:71-85): strides are the literal
        # 800/600 of the reference, independent of actual resolution.
        xi = pxi.astype(_U32)
        yi = pyi.astype(_U32)
        iu = jnp.full((), 0, _U32) + i_i32.astype(_U32)
        sample_id = (yi * _U32(800) + xi) * iu
        jx = _u32_to_f32(_hash_u32(xi + yi * _U32(800) + sample_id))
        jy = _u32_to_f32(_hash_u32(yi + xi * _U32(600) + sample_id
                                   + _U32(12345)))

        s = ((px + jx) / _F32(config.width)) * 2.0 - 1.0
        t = -(((py + jy) / _F32(config.height)) * 2.0 - 1.0)
        dx = s * uhw[0] + t * vhh[0] - wv[0]
        dy = s * uhw[1] + t * vhh[1] - wv[1]
        dz = s * uhw[2] + t * vhh[2] - wv[2]
        dx, dy, dz = _normalize3(dx, dy, dz)
        ox = px * 0.0 + pos[0]
        oy = px * 0.0 + pos[1]
        oz = px * 0.0 + pos[2]

        (hit, t_hit, prim_cam, nhx, nhy, nhz, dfr, dfg, dfb, met, rgh,
         isem) = closest_full(ox, oy, oz, dx, dy, dz)
        hit = hit & in_image
        if emit_records:
            rec_refs[0][pl.ds(i_i32 * TILE, TILE)] = (
                jnp.where(hit, prim_cam + 1.0, 0.0)).astype(_I32)
        cam_hit_light = hit & (isem > 0.5)
        acc_r = acc_r + jnp.where(cam_hit_light, ler, 0.0)
        acc_g = acc_g + jnp.where(cam_hit_light, leg, 0.0)
        acc_b = acc_b + jnp.where(cam_hit_light, leb, 0.0)

        surf = hit & (isem <= 0.5)
        # NOT normal-offset (shaders.metal:497).
        t_safe = jnp.where(surf, t_hit, 0.0)
        p_x = ox + dx * t_safe
        p_y = oy + dy * t_safe
        p_z = oz + dz * t_safe

        def one_sample(s_i32, c3):
            m_r, m_g, m_b = c3
            tab = [tab_ref[k, s_i32] for k in range(NTAB)]

            # Strategy 1: light sampling.
            s1r, s1g, s1b, reach1 = direct_light(
                p_x, p_y, p_z, nhx, nhy, nhz, dx, dy, dz,
                dfr, dfg, dfb, met, rgh, tab[TAB_LU0], tab[TAB_LU1],
                surf, True)

            vx, vy, vz = -dx, -dy, -dz
            tx, ty, tz, bx, by, bz = _ortho_basis(nhx, nhy, nhz)

            # Strategy 2: cosine (cosineWeightedRay, shaders.metal:355-374).
            phi = _F32(2.0 * PI) * tab[TAB_CU0]
            cth = jnp.sqrt(jnp.full((), 0.0, _F32) + tab[TAB_CU1])
            sth = jnp.sqrt(jnp.maximum(1.0 - tab[TAB_CU1], 0.0))
            cp, sp = jnp.cos(phi), jnp.sin(phi)
            cdx, cdy, cdz = _normalize3(
                tx * (cp * sth) + bx * (sp * sth) + nhx * cth,
                ty * (cp * sth) + by * (sp * sth) + nhy * cth,
                tz * (cp * sth) + bz * (sp * sth) + nhz * cth)
            pdf_c = _cosine_pdf(nhx, nhy, nhz, cdx, cdy, cdz)
            pdf_l = square_light_pdf(p_x, p_y, p_z, cdx, cdy, cdz)
            pdf_v = _vndf_pdf(vx, vy, vz, nhx, nhy, nhz, cdx, cdy, cdz, rgh)
            w_c = _power_heuristic_3(pdf_c, pdf_l, pdf_v, _F32(s_per))
            s2r, s2g, s2b, prim_c, reach2 = bounce_strategy(
                p_x, p_y, p_z, nhx, nhy, nhz, dx, dy, dz,
                dfr, dfg, dfb, met, rgh, surf,
                cdx, cdy, cdz, pdf_c, w_c, tab[TAB_CSU0], tab[TAB_CSU1])

            # Strategy 3: VNDF (vndfRay, shaders.metal:382-435).
            alpha = rgh * rgh
            vtx = _dot3(vx, vy, vz, tx, ty, tz)
            vtb = _dot3(vx, vy, vz, bx, by, bz)
            vtn = _dot3(vx, vy, vz, nhx, nhy, nhz)
            vex, vey, vez = _normalize3(alpha * vtx, alpha * vtb, vtn)
            t1x, t1y, t1z = _normalize3(vez, vez * 0.0, -vex)
            t2x, t2y, t2z = _cross3(vex, vey, vez, t1x, t1y, t1z)
            vphi = _F32(2.0 * PI) * tab[TAB_VU0]
            # len(Ve) == 1 after normalize (reference quirk) =>
            # cosThetaMax = 1/sqrt(2).
            ctm = _F32(1.0 / math.sqrt(2.0))
            vct = ctm + (1.0 - ctm) * tab[TAB_VU1]
            vst = jnp.sqrt(jnp.maximum(0.0, 1.0 - vct * vct))
            vcp, vsp = jnp.cos(vphi), jnp.sin(vphi)
            hx_, hy_, hz_ = _normalize3(
                t1x * (vcp * vst) + t2x * (vsp * vst) + vex * vct,
                t1y * (vcp * vst) + t2y * (vsp * vst) + vey * vct,
                t1z * (vcp * vst) + t2z * (vsp * vst) + vez * vct)
            nhx_, nhy_, nhz_ = _normalize3(
                alpha * hx_, alpha * hy_, jnp.maximum(0.0, hz_))
            whx = tx * nhx_ + bx * nhy_ + nhx * nhz_
            why = ty * nhx_ + by * nhy_ + nhy * nhz_
            whz = tz * nhx_ + bz * nhy_ + nhz * nhz_
            whx, why, whz = _normalize3(whx, why, whz)
            # The reference reflects the incoming dir:
            # reflect(d, wh) = d - 2 (d . wh) wh.
            ddh = _dot3(dx, dy, dz, whx, why, whz)
            vdx = dx - 2.0 * ddh * whx
            vdy = dy - 2.0 * ddh * why
            vdz = dz - 2.0 * ddh * whz
            pdf_v2 = _vndf_pdf(vx, vy, vz, nhx, nhy, nhz, vdx, vdy, vdz, rgh)
            pdf_l2 = square_light_pdf(p_x, p_y, p_z, vdx, vdy, vdz)
            pdf_c2 = _cosine_pdf(nhx, nhy, nhz, vdx, vdy, vdz)
            w_v = _power_heuristic_3(pdf_v2, pdf_l2, pdf_c2, _F32(s_per))
            s3r, s3g, s3b, prim_v, reach3 = bounce_strategy(
                p_x, p_y, p_z, nhx, nhy, nhz, dx, dy, dz,
                dfr, dfg, dfb, met, rgh, surf,
                vdx, vdy, vdz, pdf_v2, w_v, tab[TAB_VSU0], tab[TAB_VSU1])

            if emit_records:
                # Exact int32 pack (disjoint bit ranges => adds == ORs);
                # prim indices < 2^24 are exact through the f32->i32 cast.
                packed = (
                    jnp.where(reach1, 1, 0)
                    + jnp.where(reach2, 2, 0)
                    + jnp.where(reach3, 4, 0)
                    + (prim_c + 1.0).astype(_I32) * (1 << REC_SHIFT_C)
                    + (prim_v + 1.0).astype(_I32) * (1 << REC_SHIFT_V))
                rec_refs[1][pl.ds((i_i32 * s_per + s_i32) * TILE, TILE)] = \
                    packed

            m1, m2, m3 = (_F32(1.0) if on else _F32(0.0)
                          for on in DEBUG_STRATEGY_MASK)
            return (m_r + m1 * s1r + m2 * s2r + m3 * s3r,
                    m_g + m1 * s1g + m2 * s2g + m3 * s3g,
                    m_b + m1 * s1b + m2 * s2b + m3 * s3b)

        zero = px * 0.0
        m_r, m_g, m_b = jax.lax.fori_loop(
            0, s_per, one_sample, (zero, zero, zero))
        inv_s = _F32(1.0 / s_per)
        acc_r = acc_r + jnp.where(surf, m_r * inv_s, 0.0)
        acc_g = acc_g + jnp.where(surf, m_g * inv_s, 0.0)
        acc_b = acc_b + jnp.where(surf, m_b * inv_s, 0.0)
        return acc_r, acc_g, acc_b

    zero = px * 0.0
    acc_r, acc_g, acc_b = jax.lax.fori_loop(
        0, config.camera_rays, one_camera_ray, (zero, zero, zero))
    out_r_ref[...] = acc_r
    out_g_ref[...] = acc_g
    out_b_ref[...] = acc_b


def _pack_inputs(scene: Scene, config: RenderConfig, occluders=None):
    """Host-side marshalling (the reference's convert*/makeBuffer step):
    the geometry table zero-padded to GROUP granularity and its group
    AABBs, the dense occluder-culled shadow table and its AABBs
    (pallas_path.group_aabbs), camera, light, sample and attribute
    tables."""
    compiled = compile_scene(scene.triangles, lane_pad=1)
    tri = jnp.stack([
        compiled.n[:, 0], compiled.n[:, 1], compiled.n[:, 2], compiled.c0,
        compiled.s1[:, 0], compiled.s1[:, 1], compiled.s1[:, 2], compiled.c1,
        compiled.s2[:, 0], compiled.s2[:, 1], compiled.s2[:, 2], compiled.c2,
        compiled.diffuse[:, 0], compiled.diffuse[:, 1], compiled.diffuse[:, 2],
        compiled.is_emissive.astype(_F32),
        compiled.emissive[:, 0], compiled.emissive[:, 1],
        compiled.emissive[:, 2],
        compiled.metallic, compiled.roughness,
    ])  # [NROWS, T]

    cam_vec = camera_vec(scene, config)
    light = scene.light
    lnorm = jnp.asarray(light.normal, _F32)
    lt, lb = smp.build_orthonormal_basis(lnorm)
    light_vec = jnp.concatenate([
        jnp.asarray(light.center, _F32).reshape(-1),
        jnp.asarray(light.emitted_radiance, _F32).reshape(-1),
        jnp.asarray(light.width, _F32).reshape(1),
        jnp.asarray(light.depth, _F32).reshape(1),
        lnorm.reshape(-1), lt.reshape(-1), lb.reshape(-1),
    ]).reshape(1, 17)

    # Per-sample random tables (pixel-independent; shared with the oracle
    # and the backward kernel via sampling.mis_sample_table_rows).
    tabs = smp.mis_sample_table_rows(config.mis_samples,
                                     config.sampler)  # [NTAB, S]

    # Attribute table [NATTR, T + S] (row order matches _mis_kernel's
    # closest_full unpack): triangles first, then spheres.
    n_t = scene.triangles.num_triangles
    zt = jnp.zeros((3, n_t), _F32)
    tri_cols = jnp.concatenate([
        tri[ROW_NX:ROW_NZ + 1],                      # normal
        tri[ROW_DR:ROW_DB + 1],                      # diffuse
        tri[ROW_MET:ROW_MET + 1], tri[ROW_RGH:ROW_RGH + 1],
        tri[ROW_ISEM:ROW_ISEM + 1],
        zt,                                          # sphere center (n/a)
    ], axis=0)  # [NATTR, T]
    sp = scene.spheres
    if sp.num_spheres:
        sph = jnp.stack([sp.center[:, 0], sp.center[:, 1], sp.center[:, 2],
                         sp.radius])  # [SROWS, S]
        zs = jnp.zeros((3, sp.num_spheres), _F32)
        sph_is_em = (jnp.linalg.norm(sp.emissive, axis=-1)
                     > 0.0).astype(_F32)
        sph_cols = jnp.concatenate([
            zs,                                      # normal (computed)
            sp.diffuse.T,                            # diffuse
            sp.metallic.reshape(1, -1), sp.roughness.reshape(1, -1),
            sph_is_em.reshape(1, -1),
            sp.center.T,                             # center
        ], axis=0)  # [NATTR, S]
        atab = jnp.concatenate([tri_cols, sph_cols], axis=1)
    else:
        sph = jnp.zeros((SROWS, 1), _F32)  # placeholder; loops are empty
        atab = tri_cols
    verts = jnp.asarray(scene.triangles.verts, _F32)
    tri_geo = pad_geo(tri[:12])
    aabb = group_aabbs(verts)
    shadow_geo, aabb_shadow = pack_shadow_tables(tri, verts, occluders,
                                                 tri_geo, aabb)
    return (tri_geo, cam_vec, light_vec, tabs, sph, atab, aabb, shadow_geo,
            aabb_shadow)


def _render_mis_impl(scene: Scene, config: RenderConfig, interpret=None,
                     emit_records: bool = False, occluders=None,
                     local_n=None, rid_base=None, flat_output=False):
    """``local_n``/``rid_base``/``flat_output``: shard-local rendering for
    shard_map (parallel/fast.py) — render the ``local_n`` pixels starting
    at global pixel ``rid_base`` and return flat [local_n, 3] hdr."""
    interpret = route.interpret_mode(interpret)
    n_pixels = config.num_pixels
    local_n = n_pixels if local_n is None else local_n
    if rid_base is None:
        rid_base = jnp.zeros((1, 1), jnp.int32)
    n_padded = ((local_n + TILE - 1) // TILE) * TILE
    num_tris = scene.triangles.num_triangles
    num_spheres = scene.spheres.num_spheres
    assert num_tris + num_spheres < REC_MAX_PRIMS, "record encoding limit"
    if occluders is not None:
        assert len(occluders) == num_tris, (len(occluders), num_tris)
    (tri, cam_vec, light_vec, tabs, sph, atab, aabb, shadow_geo,
     aabb_shadow) = _pack_inputs(scene, config, occluders=occluders)
    kernel = partial(_mis_kernel, config, n_pixels, num_tris, num_spheres,
                     emit_records, aabb.shape[1], aabb_shadow.shape[1])
    plane = jax.ShapeDtypeStruct((n_padded,), _F32)
    s_per = config.mis_samples // 3
    cr_n = config.camera_rays
    tile_spec = pl.BlockSpec((TILE,), lambda i: (i,))
    out_shapes = [plane, plane, plane]
    out_specs = [tile_spec, tile_spec, tile_spec]
    if emit_records:
        # Rows [tile, camera ray, TILE] and [tile, camera ray, sample, TILE].
        out_shapes += [
            jax.ShapeDtypeStruct((n_padded * cr_n,), jnp.int32),
            jax.ShapeDtypeStruct((n_padded * cr_n * s_per,), jnp.int32),
        ]
        out_specs += [
            pl.BlockSpec((cr_n * TILE,), lambda i: (i,)),
            pl.BlockSpec((cr_n * s_per * TILE,), lambda i: (i,)),
        ]
    tables = tuple(route.pad_pow2(t) for t in
                   (cam_vec, light_vec, tri, sph, tabs, atab, aabb,
                    shadow_geo, aabb_shadow))
    outs = pl.pallas_call(
        kernel,
        grid=(n_padded // TILE,),
        in_specs=[pl.no_block_spec] * (1 + len(tables)),
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shapes),
        backend="triton",
        compiler_params=route.compiler_params(),
        interpret=interpret,
        name="mis_trace",
    )(jnp.asarray(rid_base, jnp.int32).reshape(1, 1), *tables)
    hdr = jnp.stack(outs[:3], axis=-1)
    hdr = (hdr[:local_n] if flat_output
           else hdr[:n_pixels].reshape(config.height, config.width, 3))
    if emit_records:
        # Raw tile-major planes, exactly as written — consumed
        # relayout-free by the backward kernel (ops/pallas_mis_bwd.py).
        return hdr, tuple(outs[3:])
    return hdr


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def render_mis_pallas(scene: Scene, config: RenderConfig) -> jnp.ndarray:
    """Variant-A MIS render via the Pallas megakernel. Returns [H, W, 3] raw
    accumulated HDR (pre-tonemap; apply render.tonemap_mis for the LDR image).
    Differentiable: backward is the VJP of the jnp reference."""
    return _render_mis_impl(scene, config)


def _fwd(scene, config):
    return _render_mis_impl(scene, config), scene


def _bwd(config, scene, g):
    _, vjp = jax.vjp(lambda s: render_mis(s, config).hdr, scene)
    return vjp(g)


render_mis_pallas.defvjp(_fwd, _bwd)


def render_mis_pallas_interpret(scene: Scene, config: RenderConfig):
    """Interpreter-mode run (CPU) for parity tests."""
    return _render_mis_impl(scene, config, interpret=True)

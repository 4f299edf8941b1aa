"""Hand-written Pallas backward (Triton route) for the variant-A MIS
megakernel.

The trace kernel (ops/pallas_mis.py, ``emit_records=True``) writes the
integrator's discrete decisions per (camera ray, sample, pixel): the
camera/cosine/VNDF closest-hit winners and the three light-probe visibility
bits — exactly what AD treats as piecewise constant. This kernel recomputes
each sample's *continuous* math from those records on chip — no ray-scene
traversals, which is where the forward's FLOPs go — and reverses it with a
HAND-WRITTEN sweep (the same recipe as the variant-B path backward,
ops/pallas_shade.py). Applying jax.vjp to each strategy inside the kernel
would keep every linearization-point residual live across the strategy's
sweep and re-derive the sample-invariant frames per sample; instead:

  * module-level forward/reverse pairs (``_fwd_brdf``/``_rev_brdf``,
    ``_fwd_vndf``, ``_fwd_smith_g1``, ``_fwd_dggx``, ``_fwd_lightpdf``,
    ``_fwd_ph3``, ``_fwd_direct_light``, ``_fwd_bounce``) — pure jnp on
    tiles, each asserted against jax.vjp of its own forward in
    tests/test_mis_fused.py::test_handwritten_reverse_helpers;
  * the sample-INVARIANT stages (camera ray + hit, ortho basis, VNDF view
    frame, offset origin) hoisted out of the sample loop and reversed once
    per (tile, camera ray) via one jax.vjp — 1/s_per of the old cost, and
    the per-sample sweep no longer re-derives basis/frame chains;
  * the per-sample hot path (3 strategies × 5 BRDF evaluations) fully
    hand-derived, interleaving forward recompute with reverse math so
    residuals die within one sample's body.

Cotangent outputs per program (one ray tile x one camera ray), accumulated
across the sample loop and added over programs by ``jnp.sum``:
  * per-primitive table [ndif, P]: normal xyz, plane c0, diffuse rgb,
    metallic, roughness (+ a discarded is_emissive row) — and, for sphere
    scenes, center xyz + radius (+ a discarded is_sphere row) — by one-hot
    sums per fetch site into the program's own partial block
    (route.accumulate_rows);
  * camera (12) and light (17) scalars as running per-lane partial sums,
    reduced once per program.

Scope: triangle AND sphere scenes. Sphere lanes replay the analytic
quadratic t(center, radius) and the point normal (hit − center)/‖·‖ with
hand-derived reverses (mirroring pallas_shade.py's sphere chains), so
center/radius cotangents flow at kernel speed. References being
differentiated: Sources/gpuRaytracer/shaders.metal:543-707 (MIS
integrator), Sources/gpuRaytracer/shaders_old.metal:108-136 (analytic
sphere).

Gradient conventions match jax AD: clip(x, lo, hi) gates with
(x >= lo) & (x <= hi); |x| differentiates to sign(x); maximum(x, c) passes
the gradient where x >= c. Parity vs jax.grad of the jnp oracle is
asserted across every parameter group in tests/test_mis_fused.py.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from .. import sampling as smp
from ..intersect import compile_scene
from ..types import RenderConfig, Scene
from . import pallas_mis as pm
from . import route
from .pallas_mis import (
    DEBUG_STRATEGY_MASK, NTAB,
    REC_CODE_MASK, REC_SHIFT_C, REC_SHIFT_V,
    TAB_CSU0, TAB_CSU1, TAB_CU0, TAB_CU1, TAB_LU0, TAB_LU1,
    TAB_VSU0, TAB_VSU1, TAB_VU0, TAB_VU1,
    _cross3, _dot3, _hash_u32, _normalize3, _ortho_basis,
    _render_mis_impl, _u32_to_f32,
)
from .pallas_path import camera_vec

_F32 = jnp.float32
_U32 = jnp.uint32
_I32 = jnp.int32
PI = math.pi

# Differentiable per-primitive table rows: n(3), c0, diffuse(3), metallic,
# roughness, is_emissive (the last is only compared against 0.5, so its
# cotangent is structurally zero and gets dropped host-side). Sphere scenes
# append center(3), radius, is_sphere (selector, cotangent likewise zero).
NDIF = 10
NDIF_SPH = 15
NCAM = 12
NLIGHT = 17
NSCAL = NCAM + NLIGHT
NSCAL_PAD = 32
RAY_TMIN = 1e-3
RAY_TMAX = 1e3

# Hoisted sample-invariant plane layout (``cs`` tuple; see _hoist_stage).
CS_D = 0       # 0-2   camera ray direction
CS_P = 3       # 3-5   camera-hit surface point
CS_NH = 6      # 6-8   shading normal
CS_DF = 9      # 9-11  diffuse rgb
CS_MET = 12
CS_RGH = 13
CS_T = 14      # 14-16 ortho-basis tangent
CS_B = 17      # 17-19 ortho-basis bitangent
CS_VE = 20     # 20-22 VNDF view vector (stretched-normalized v)
CS_T1 = 23     # 23-25 VNDF frame tangent 1
CS_T2 = 26     # 26-28 VNDF frame tangent 2
CS_ALPHA = 29  # roughness² (also the BRDF's GGX 'a')
CS_OFF = 30    # 30-32 offset secondary origin p + nh*1e-4
# Camera-material BRDF/VNDF invariants (every subexpression of the
# 3-per-sample (v, nh, material) BRDF+VNDF sites that does not depend on
# the outgoing direction — hoisted per tile, reversed by the hoist vjp):
CS_V = 33      # 33-35 view vector -d
CS_CNDV = 36   # |nh·v| + 1e-5 (BRDF n·v)
CS_CSQV = 37   # sqrt(ndv²(1-a) + a) (BRDF Smith-vis v-term)
CS_F0 = 38     # 38-40 Fresnel F0 rgb
CS_OMM = 41    # 1 - metallic
CS_G1 = 42     # Smith G1(|nh·v|, rgh) (VNDF pdf)
CS_VNDV = 43   # |nh·v| (VNDF pdf denominator term)
NCS = 44

# Light vector layout ([1, NLIGHT] table → broadcast planes): center(3),
# emitted_radiance(3), width, depth, normal(3), tangent(3), bitangent(3).
L_C = 0
L_E = 3
L_W = 6
L_D = 7
L_N = 8
L_T = 11
L_B = 14

# Extended sample-table rows: the direction chains' per-sample
# transcendentals, precomputed host-side (see _sample_tables).
TAB_W0C, TAB_W1C, TAB_CTH, TAB_K0V, TAB_K1V, TAB_VCT = range(NTAB, NTAB + 6)
NTAB_EXT = NTAB + 6


# ---------------------------------------------------------------------------
# Hand-written forward/reverse pairs (per-sample hot path).
#
# Each ``_fwd_*`` returns (primal outputs, res); the matching ``_rev_*``
# consumes ``res`` plus the upstream cotangent and returns input cotangents
# in the forward's argument order. All are pure jnp on planes — asserted
# against jax.vjp of their own forward in tests/test_mis_fused.py.
# ---------------------------------------------------------------------------


def _fwd_norm3(x, y, z, eps):
    """y = x * rsqrt(max(|x|², eps)) — mirrors pallas_mis._normalize3."""
    q = x * x + y * y + z * z
    inv = jax.lax.rsqrt(jnp.maximum(q, eps))
    return (x * inv, y * inv, z * inv), (x, y, z, inv, q >= eps)


def _rev_norm3(res, dx_, dy_, dz_):
    x, y, z, inv, ok = res
    d_inv = x * dx_ + y * dy_ + z * dz_
    d_q = jnp.where(ok, (-0.5) * inv * inv * inv * d_inv, 0.0)
    return (inv * dx_ + 2.0 * x * d_q,
            inv * dy_ + 2.0 * y * d_q,
            inv * dz_ + 2.0 * z * d_q)


def _fwd_dggx(ndh, rgh):
    """D_GGX(n·h, roughness) — reference quirk: takes roughness, not α
    (sampling.d_ggx / shaders.metal:291-300). The reciprocal is saved so
    the reverse is division-free (VPU divides cost ~5-10x a multiply;
    the whole sweep keeps this diet)."""
    f = (ndh * rgh * rgh - ndh) * ndh + 1.0
    den = _F32(PI) * f * f + 1e-12
    out = (rgh * rgh) / den   # division form: ULP parity with the oracle
    inv_den = 1.0 / den
    return out, (ndh, rgh, f, inv_den, out)


def _rev_dggx(res, d_out):
    ndh, rgh, f, inv_den, out = res
    d_rgh = 2.0 * rgh * inv_den * d_out
    d_den = -(out * inv_den) * d_out
    d_f = 2.0 * _F32(PI) * f * d_den
    d_ndh = 2.0 * ndh * (rgh * rgh - 1.0) * d_f
    d_rgh += 2.0 * rgh * ndh * ndh * d_f
    return d_ndh, d_rgh


def _fwd_smith_g1(ndv, rgh):
    """Smith G1 for GGX — oracle-form forward (sampling.smith_g1_ggx,
    ULP parity) with reciprocals saved so the reverse needs two divides,
    not five."""
    a = rgh * rgh
    a2 = a * a
    nv2r = ndv * ndv
    nv2 = jnp.maximum(nv2r, 1e-12)
    s = jnp.sqrt(1.0 + a2 * (1.0 - nv2) / nv2)
    g1 = 2.0 / (1.0 + s)
    inv_nv2 = 1.0 / nv2
    return g1, (ndv, rgh, a, a2, nv2r, inv_nv2, s, g1)


def _rev_smith_g1(res, d_g1):
    ndv, rgh, a, a2, nv2r, inv_nv2, s, g1 = res
    d_s = -(g1 / (1.0 + s)) * d_g1
    d_in = d_s / (2.0 * s)          # inner = s², s >= 1
    d_a2 = (inv_nv2 - 1.0) * d_in
    d_nv2 = -(a2 * inv_nv2 * inv_nv2) * d_in
    d_ndv = jnp.where(nv2r >= 1e-12, 2.0 * ndv * d_nv2, 0.0)
    d_rgh = 4.0 * rgh * a * d_a2    # a2 = rgh⁴
    return d_ndv, d_rgh


def _fwd_brdf(v3, n3, df3, met, rgh, l3):
    """calculateBRDFContribution (shaders.metal:259-289) — mirrors
    pallas_mis._brdf op-for-op. ``v`` is the view dir (= -incoming)."""
    vx, vy, vz = v3
    nx, ny, nz = n3
    lx, ly, lz = l3
    h3, res_h = _fwd_norm3(vx + lx, vy + ly, vz + lz, 1e-12)
    hx, hy, hz = h3
    ndv_raw = nx * vx + ny * vy + nz * vz
    ndv = jnp.abs(ndv_raw) + 1e-5
    ndl_raw = nx * lx + ny * ly + nz * lz
    ndl = jnp.clip(ndl_raw, 0.0, 1.0)
    ndh_raw = nx * hx + ny * hy + nz * hz
    ndh = jnp.clip(ndh_raw, 0.0, 1.0)
    ldh_raw = lx * hx + ly * hy + lz * hz
    ldh = jnp.clip(ldh_raw, 0.0, 1.0)
    omm = 1.0 - met
    f0 = tuple(0.04 * omm + df3[c] * met for c in range(3))
    dggx, res_d = _fwd_dggx(ndh, rgh)
    # Forward expressions mirror the oracle ULP-for-ULP (pow, sqrt, plain
    # divides — round-5 finding: reciprocal-multiply forms drift by ulps,
    # which grazing-geometry gradients amplify to ~1e-4); the saved
    # reciprocals keep the REVERSE division-free.
    p5 = jnp.power(1.0 - ldh, 5.0)
    x2 = (1.0 - ldh) * (1.0 - ldh)
    x4 = x2 * x2                         # reverse factor for d(p5)
    fres = tuple(f0[c] + (1.0 - f0[c]) * p5 for c in range(3))
    a = rgh * rgh
    argl = (-ndl * a + ndl) * ndl + a
    sql = jnp.sqrt(jnp.maximum(argl, 1e-12))
    inv_sql = 1.0 / sql
    ggx_l = ndv * sql
    argv = (-ndv * a + ndv) * ndv + a
    sqv = jnp.sqrt(jnp.maximum(argv, 1e-12))
    inv_sqv = 1.0 / sqv
    ggx_v = ndl * sqv
    sumg = ggx_v + ggx_l + 1e-7
    vis = 0.5 / sumg
    inv_sumg = vis + vis                 # exact: power-of-two rescale
    den_s = 4.0 * ndv * ndl + 1e-7
    spec = dggx * vis / den_s
    inv_dens = 1.0 / den_s
    fd = _F32(1.0 / PI)
    out = tuple((1.0 - fres[c]) * omm * (df3[c] * fd + spec * fres[c]) * ndl
                for c in range(3))
    res = (v3, n3, df3, met, rgh, l3, h3, res_h,
           ndv_raw, ndv, ndl_raw, ndl, ndh_raw, ndh, ldh_raw, x4,
           omm, f0, dggx, res_d, p5, fres, a, argl, inv_sql, sql, argv,
           inv_sqv, sqv, vis, inv_sumg, inv_dens, spec)
    return out, res


def _rev_brdf(res, d_out):
    (v3, n3, df3, met, rgh, l3, h3, res_h,
     ndv_raw, ndv, ndl_raw, ndl, ndh_raw, ndh, ldh_raw, x4,
     omm, f0, dggx, res_d, p5, fres, a, argl, inv_sql, sql, argv,
     inv_sqv, sqv, vis, inv_sumg, inv_dens, spec) = res
    fd = _F32(1.0 / PI)
    zero = d_out[0] * 0.0
    d_ndl = zero
    d_ndv = zero
    d_spec_acc = zero
    d_omm = zero
    d_met = zero
    d_p5 = zero
    d_a = zero
    d_df = [zero, zero, zero]
    for c in range(3):
        g = d_out[c]
        kd = (1.0 - fres[c]) * omm
        inner = df3[c] * fd + spec * fres[c]
        d_kd = inner * ndl * g
        d_inner = kd * ndl * g
        d_ndl += kd * inner * g
        d_fc = spec * d_inner - omm * d_kd
        d_omm += (1.0 - fres[c]) * d_kd
        d_df[c] += fd * d_inner
        d_spec_acc += fres[c] * d_inner
        d_f0 = (1.0 - p5) * d_fc
        d_p5 += (1.0 - f0[c]) * d_fc
        d_omm += 0.04 * d_f0
        d_df[c] += met * d_f0
        d_met += df3[c] * d_f0
    d_met -= d_omm
    d_ldh = -5.0 * x4 * d_p5
    # spec = dggx * vis * inv_dens
    d_dggx = vis * inv_dens * d_spec_acc
    d_vis = dggx * inv_dens * d_spec_acc
    d_dens = -(spec * inv_dens) * d_spec_acc
    d_ndv += 4.0 * ndl * d_dens
    d_ndl += 4.0 * ndv * d_dens
    d_sumg = -(vis * inv_sumg) * d_vis
    # ggx_v = ndl * sqv ; ggx_l = ndv * sql
    d_ndl += sqv * d_sumg
    d_sqv = ndl * d_sumg
    d_ndv += sql * d_sumg
    d_sql = ndv * d_sumg
    d_argv = jnp.where(argv >= 1e-12, 0.5 * inv_sqv * d_sqv, 0.0)
    d_argl = jnp.where(argl >= 1e-12, 0.5 * inv_sql * d_sql, 0.0)
    # arg = nd²(1-a) + a
    d_ndv += 2.0 * ndv * (1.0 - a) * d_argv
    d_a += (1.0 - ndv * ndv) * d_argv
    d_ndl += 2.0 * ndl * (1.0 - a) * d_argl
    d_a += (1.0 - ndl * ndl) * d_argl
    d_ndh, d_rgh = _rev_dggx(res_d, d_dggx)
    d_rgh += 2.0 * rgh * d_a
    # gates
    d_ldh_raw = jnp.where((ldh_raw >= 0.0) & (ldh_raw <= 1.0), d_ldh, 0.0)
    d_ndh_raw = jnp.where((ndh_raw >= 0.0) & (ndh_raw <= 1.0), d_ndh, 0.0)
    d_ndl_raw = jnp.where((ndl_raw >= 0.0) & (ndl_raw <= 1.0), d_ndl, 0.0)
    d_ndv_raw = jnp.sign(ndv_raw) * d_ndv
    hx, hy, hz = h3
    vx, vy, vz = v3
    nx, ny, nz = n3
    lx, ly, lz = l3
    d_n = (lx * d_ndl_raw + hx * d_ndh_raw + vx * d_ndv_raw,
           ly * d_ndl_raw + hy * d_ndh_raw + vy * d_ndv_raw,
           lz * d_ndl_raw + hz * d_ndh_raw + vz * d_ndv_raw)
    d_l = [nx * d_ndl_raw + hx * d_ldh_raw,
           ny * d_ndl_raw + hy * d_ldh_raw,
           nz * d_ndl_raw + hz * d_ldh_raw]
    d_h = (nx * d_ndh_raw + lx * d_ldh_raw,
           ny * d_ndh_raw + ly * d_ldh_raw,
           nz * d_ndh_raw + lz * d_ldh_raw)
    d_v = [nx * d_ndv_raw, ny * d_ndv_raw, nz * d_ndv_raw]
    dh = _rev_norm3(res_h, *d_h)
    for c in range(3):
        d_v[c] += dh[c]
        d_l[c] += dh[c]
    return tuple(d_v), d_n, tuple(d_df), d_met, d_rgh, tuple(d_l)


def _fwd_vndf(v3, n3, l3, rgh):
    """VNDF pdf: D·G1·|v·h| / (4|n·v| + 1e-7) — mirrors
    pallas_mis._vndf_pdf (shaders.metal:437-445)."""
    h3, res_h = _fwd_norm3(v3[0] + l3[0], v3[1] + l3[1], v3[2] + l3[2],
                           1e-12)
    ndh_raw = n3[0] * h3[0] + n3[1] * h3[1] + n3[2] * h3[2]
    ndh = jnp.abs(ndh_raw)
    vdh_raw = v3[0] * h3[0] + v3[1] * h3[1] + v3[2] * h3[2]
    vdh = jnp.abs(vdh_raw)
    ndv_raw = n3[0] * v3[0] + n3[1] * v3[1] + n3[2] * v3[2]
    ndv = jnp.abs(ndv_raw)
    dggx, res_d = _fwd_dggx(ndh, rgh)
    g1, res_g = _fwd_smith_g1(ndv, rgh)
    den = 4.0 * ndv + 1e-7
    pdf = dggx * g1 * vdh / den   # division form: oracle ULP parity
    inv_den = 1.0 / den
    res = (v3, n3, l3, h3, res_h, ndh_raw, vdh_raw, ndv_raw,
           dggx, res_d, g1, res_g, vdh, inv_den, pdf)
    return pdf, res


def _rev_vndf(res, d_pdf):
    (v3, n3, l3, h3, res_h, ndh_raw, vdh_raw, ndv_raw,
     dggx, res_d, g1, res_g, vdh, inv_den, pdf) = res
    d_dggx = g1 * vdh * inv_den * d_pdf
    d_g1 = dggx * vdh * inv_den * d_pdf
    d_vdh = dggx * g1 * inv_den * d_pdf
    d_den = -(pdf * inv_den) * d_pdf
    d_ndv = 4.0 * d_den
    d_ndh, d_rgh = _rev_dggx(res_d, d_dggx)
    d_ndv_g, d_rgh_g = _rev_smith_g1(res_g, d_g1)
    d_ndv += d_ndv_g
    d_rgh += d_rgh_g
    d_ndh_raw = jnp.sign(ndh_raw) * d_ndh
    d_vdh_raw = jnp.sign(vdh_raw) * d_vdh
    d_ndv_raw = jnp.sign(ndv_raw) * d_ndv
    d_n = (h3[0] * d_ndh_raw + v3[0] * d_ndv_raw,
           h3[1] * d_ndh_raw + v3[1] * d_ndv_raw,
           h3[2] * d_ndh_raw + v3[2] * d_ndv_raw)
    d_v = [h3[0] * d_vdh_raw + n3[0] * d_ndv_raw,
           h3[1] * d_vdh_raw + n3[1] * d_ndv_raw,
           h3[2] * d_vdh_raw + n3[2] * d_ndv_raw]
    d_h = (n3[0] * d_ndh_raw + v3[0] * d_vdh_raw,
           n3[1] * d_ndh_raw + v3[1] * d_vdh_raw,
           n3[2] * d_ndh_raw + v3[2] * d_vdh_raw)
    dh = _rev_norm3(res_h, *d_h)
    d_l = (dh[0], dh[1], dh[2])
    for c in range(3):
        d_v[c] += dh[c]
    return tuple(d_v), d_n, d_l, d_rgh


def _fwd_cospdf(n3, d3):
    """Cosine-hemisphere pdf max(0, n·d)/π."""
    raw = n3[0] * d3[0] + n3[1] * d3[1] + n3[2] * d3[2]
    return jnp.maximum(0.0, raw) * _F32(1.0 / PI), raw


def _rev_cospdf(n3, d3, raw, d_pdf):
    d_raw = jnp.where(raw >= 0.0, d_pdf * _F32(1.0 / PI), 0.0)
    d_n = (d3[0] * d_raw, d3[1] * d_raw, d3[2] * d_raw)
    d_d = (n3[0] * d_raw, n3[1] * d_raw, n3[2] * d_raw)
    return d_n, d_d


def _fwd_lightpdf(lightp, q3, dir3):
    """Square-light pdf to the light *center* (shaders.metal:315-326
    quirk) — mirrors pallas_mis.square_light_pdf."""
    to = (lightp[L_C] - q3[0], lightp[L_C + 1] - q3[1],
          lightp[L_C + 2] - q3[2])
    dist2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    ct_raw = -(dir3[0] * lightp[L_N] + dir3[1] * lightp[L_N + 1]
               + dir3[2] * lightp[L_N + 2])
    cos_t = jnp.maximum(0.0, ct_raw)
    den = lightp[L_W] * lightp[L_D] * cos_t + 1e-6
    pdf = dist2 / den             # division form: oracle ULP parity
    inv_den = 1.0 / den
    res = (q3, dir3, to, ct_raw, cos_t, inv_den, pdf,
           lightp[L_W], lightp[L_D],
           (lightp[L_N], lightp[L_N + 1], lightp[L_N + 2]))
    return pdf, res


def _rev_lightpdf(res, d_pdf, d_lightp):
    """Accumulates light cotangents into ``d_lightp`` (list, mutated);
    returns (d_q, d_dir)."""
    q3, dir3, to, ct_raw, cos_t, inv_den, pdf, lw, ldep, ln = res
    d_dist2 = d_pdf * inv_den
    d_den = -(pdf * inv_den) * d_pdf
    d_lightp[L_W] += ldep * cos_t * d_den
    d_lightp[L_D] += lw * cos_t * d_den
    d_ct = jnp.where(ct_raw >= 0.0, lw * ldep * d_den, 0.0)
    d_dir = [-ln[0] * d_ct, -ln[1] * d_ct, -ln[2] * d_ct]
    for c in range(3):
        d_lightp[L_N + c] += -dir3[c] * d_ct
    d_q = []
    for c in range(3):
        d_to = 2.0 * to[c] * d_dist2
        d_lightp[L_C + c] += d_to
        d_q.append(-d_to)
    return tuple(d_q), d_dir


def _fwd_ph3(p1, p2, p3, n):
    """β=1 power heuristic with per-strategy count n
    (shaders.metal:132-137)."""
    aa = n * p1
    den = aa + n * p2 + n * p3 + 1e-6
    w = aa / den                  # division form: oracle ULP parity
    inv_den = 1.0 / den
    return w, (inv_den, w, n)


def _rev_ph3(res, d_w):
    inv_den, w, n = res
    t = d_w * inv_den
    return n * (1.0 - w) * t, -n * w * t, -n * w * t


def _fwd_bv(cs, l3):
    """Camera-material BRDF + VNDF pdf toward ``l3`` — the three
    per-sample (v, nh, material) sites. Every direction-independent
    subexpression (n·v, F0, 1-met, GGX 'a', the Smith-vis v-term, Smith
    G1, the VNDF denominator) comes precomputed from the hoist stage,
    and the half-vector normalize(v + l) + its dots are shared between
    the BRDF and the VNDF pdf (they are identical). ~30% cheaper than
    the generic _fwd_brdf + _fwd_vndf pair (op census, round 5)."""
    v3 = (cs[CS_V], cs[CS_V + 1], cs[CS_V + 2])
    n3 = (cs[CS_NH], cs[CS_NH + 1], cs[CS_NH + 2])
    df3 = (cs[CS_DF], cs[CS_DF + 1], cs[CS_DF + 2])
    rgh = cs[CS_RGH]
    a = cs[CS_ALPHA]
    ndv = cs[CS_CNDV]
    sqv = cs[CS_CSQV]
    f0 = (cs[CS_F0], cs[CS_F0 + 1], cs[CS_F0 + 2])
    omm = cs[CS_OMM]
    g1 = cs[CS_G1]
    vndv = cs[CS_VNDV]
    h3, res_h = _fwd_norm3(v3[0] + l3[0], v3[1] + l3[1], v3[2] + l3[2],
                           1e-12)
    ndl_raw = n3[0] * l3[0] + n3[1] * l3[1] + n3[2] * l3[2]
    ndl = jnp.clip(ndl_raw, 0.0, 1.0)
    ndh_raw = n3[0] * h3[0] + n3[1] * h3[1] + n3[2] * h3[2]
    ndh_b = jnp.clip(ndh_raw, 0.0, 1.0)
    ldh_raw = l3[0] * h3[0] + l3[1] * h3[1] + l3[2] * h3[2]
    ldh = jnp.clip(ldh_raw, 0.0, 1.0)
    dggx_b, res_db = _fwd_dggx(ndh_b, rgh)
    # Forward expressions mirror the oracle ULP-for-ULP (see _fwd_brdf's
    # note); reciprocals saved for the division-free reverse.
    p5 = jnp.power(1.0 - ldh, 5.0)
    x2 = (1.0 - ldh) * (1.0 - ldh)
    x4 = x2 * x2
    fres = tuple(f0[c] + (1.0 - f0[c]) * p5 for c in range(3))
    argl = (-ndl * a + ndl) * ndl + a
    sql = jnp.sqrt(jnp.maximum(argl, 1e-12))
    inv_sql = 1.0 / sql
    sumg = ndl * sqv + ndv * sql + 1e-7
    vis = 0.5 / sumg
    inv_sumg = vis + vis
    den_s = 4.0 * ndv * ndl + 1e-7
    spec = dggx_b * vis / den_s
    inv_dens = 1.0 / den_s
    fd = _F32(1.0 / PI)
    out = tuple((1.0 - fres[c]) * omm * (df3[c] * fd + spec * fres[c]) * ndl
                for c in range(3))
    ndh_v = jnp.abs(ndh_raw)
    vdh_raw = v3[0] * h3[0] + v3[1] * h3[1] + v3[2] * h3[2]
    vdh = jnp.abs(vdh_raw)
    dggx_v, res_dv = _fwd_dggx(ndh_v, rgh)
    denv = 4.0 * vndv + 1e-7
    pdf = dggx_v * g1 * vdh / denv
    inv_denv = 1.0 / denv
    res = (v3, n3, df3, l3, rgh, a, ndv, sqv, f0, omm, g1, inv_denv, h3,
           res_h, ndl_raw, ndl, ndh_raw, ldh_raw, x4, p5, fres,
           dggx_b, res_db, argl, inv_sql, sql, inv_sumg, vis, inv_dens,
           spec, vdh_raw, vdh, dggx_v, res_dv, pdf)
    return out, pdf, res


def _rev_bv(res, d_out, d_pdf):
    """Reverse of _fwd_bv. Returns a dict of cotangents: ``d_l`` plus
    one entry per consumed hoisted plane (accumulated into d_cs by the
    caller; the hoist vjp carries them back to (d, nh, material))."""
    (v3, n3, df3, l3, rgh, a, ndv, sqv, f0, omm, g1, inv_denv, h3,
     res_h, ndl_raw, ndl, ndh_raw, ldh_raw, x4, p5, fres,
     dggx_b, res_db, argl, inv_sql, sql, inv_sumg, vis, inv_dens,
     spec, vdh_raw, vdh, dggx_v, res_dv, pdf) = res
    fd = _F32(1.0 / PI)
    zero = d_out[0] * 0.0
    d_ndl = zero
    d_spec = zero
    d_omm = zero
    d_p5 = zero
    d_df = [zero, zero, zero]
    d_f0 = [zero, zero, zero]
    for c in range(3):
        g = d_out[c]
        kd = (1.0 - fres[c]) * omm
        inner = df3[c] * fd + spec * fres[c]
        gi = ndl * g
        d_kd = inner * gi
        d_inner = kd * gi
        d_ndl += (kd * inner) * g
        d_fc = spec * d_inner - omm * d_kd
        d_omm += (1.0 - fres[c]) * d_kd
        d_df[c] = fd * d_inner
        d_spec += fres[c] * d_inner
        d_f0[c] = (1.0 - p5) * d_fc
        d_p5 += (1.0 - f0[c]) * d_fc
    d_ldh = -5.0 * x4 * d_p5
    # spec = dggx_b * vis * inv_dens
    d_dggx_b = vis * inv_dens * d_spec
    d_vis = dggx_b * inv_dens * d_spec
    d_dens = -(spec * inv_dens) * d_spec
    d_ndv = 4.0 * ndl * d_dens
    d_ndl += 4.0 * ndv * d_dens
    d_sumg = -(vis * inv_sumg) * d_vis
    d_ndl += sqv * d_sumg
    d_sqv = ndl * d_sumg
    d_ndv += sql * d_sumg
    d_sql = ndv * d_sumg
    d_argl = jnp.where(argl >= 1e-12, 0.5 * inv_sql * d_sql, 0.0)
    d_ndl += 2.0 * ndl * (1.0 - a) * d_argl
    d_a = (1.0 - ndl * ndl) * d_argl
    d_ndh_b, d_rgh = _rev_dggx(res_db, d_dggx_b)
    # VNDF pdf = dggx_v * g1 * vdh / (4 vndv + 1e-7)
    gv = g1 * vdh
    d_dggx_v = gv * inv_denv * d_pdf
    d_g1 = dggx_v * vdh * inv_denv * d_pdf
    d_vdh = dggx_v * g1 * inv_denv * d_pdf
    d_vndv = 4.0 * (-(pdf * inv_denv) * d_pdf)
    d_ndh_v, d_rgh_v = _rev_dggx(res_dv, d_dggx_v)
    d_rgh += d_rgh_v
    # gates
    d_ndh_raw = (jnp.where((ndh_raw >= 0.0) & (ndh_raw <= 1.0),
                           d_ndh_b, 0.0)
                 + jnp.sign(ndh_raw) * d_ndh_v)
    d_ndl_raw = jnp.where((ndl_raw >= 0.0) & (ndl_raw <= 1.0), d_ndl, 0.0)
    d_ldh_raw = jnp.where((ldh_raw >= 0.0) & (ldh_raw <= 1.0), d_ldh, 0.0)
    d_vdh_raw = jnp.sign(vdh_raw) * d_vdh
    d_n = tuple(l3[c] * d_ndl_raw + h3[c] * d_ndh_raw for c in range(3))
    d_l = [n3[c] * d_ndl_raw + h3[c] * d_ldh_raw for c in range(3)]
    d_h = tuple(n3[c] * d_ndh_raw + l3[c] * d_ldh_raw
                + v3[c] * d_vdh_raw for c in range(3))
    d_v = [h3[c] * d_vdh_raw for c in range(3)]
    dh = _rev_norm3(res_h, *d_h)
    for c in range(3):
        d_v[c] += dh[c]
        d_l[c] += dh[c]
    return dict(d_l=d_l, d_v=d_v, d_n=d_n, d_df=d_df, d_rgh=d_rgh,
                d_a=d_a, d_ndv=d_ndv, d_sqv=d_sqv, d_f0=d_f0,
                d_omm=d_omm, d_g1=d_g1, d_vndv=d_vndv)


def _fwd_lsample(lightp, o3, u0, u1):
    """Light-rectangle sample point + unit direction from origin ``o3``
    (the first half of calculateDirectLightSamplingContribution)."""
    su0 = u0 - 0.5
    su1 = u1 - 0.5
    sw = su0 * lightp[L_W]
    sdep = su1 * lightp[L_D]
    to = tuple(lightp[L_C + c] + lightp[L_T + c] * sw
               + lightp[L_B + c] * sdep - o3[c] for c in range(3))
    q2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
    # Division form for ULP parity with the trace kernel (see
    # _fwd_direct_light's note); reciprocal saved for the reverse.
    dist = jnp.sqrt(jnp.maximum(q2, 1e-30))
    inv_dist = 1.0 / dist
    ld = tuple(to[c] / dist for c in range(3))
    return ld, (to, q2, inv_dist, su0, su1, lightp)


def _rev_lsample(res, d_ld, d_lightp):
    """Accumulates light cotangents into ``d_lightp``; returns d_o."""
    to, q2, inv_dist, su0, su1, lightp = res
    d_to = [inv_dist * d_ld[0], inv_dist * d_ld[1], inv_dist * d_ld[2]]
    d_invd = to[0] * d_ld[0] + to[1] * d_ld[1] + to[2] * d_ld[2]
    d_q2 = jnp.where(q2 >= 1e-30,
                     -0.5 * inv_dist * inv_dist * inv_dist * d_invd, 0.0)
    lw = lightp[L_W]
    ldep = lightp[L_D]
    d_o = []
    for c in range(3):
        d_to[c] += 2.0 * to[c] * d_q2
        d_s = d_to[c]
        d_lightp[L_C + c] += d_s
        d_lightp[L_T + c] += su0 * lw * d_s
        d_lightp[L_W] += su0 * lightp[L_T + c] * d_s
        d_lightp[L_B + c] += su1 * ldep * d_s
        d_lightp[L_D] += su1 * lightp[L_B + c] * d_s
        d_o.append(-d_s)
    return tuple(d_o)


def _fwd_direct_light(lightp, q3, n3, inc3, df3, met, rgh, u0, u1, gate,
                      s_per_f, heuristic):
    """calculateDirectLightSamplingContribution (shaders.metal:519-541)
    with the probe's visibility decision supplied as the recorded ``gate``
    (= active & reach). ``u0, u1`` are table scalars. Mirrors the trace
    kernel's direct_light minus the ray-scene probe."""
    ox = q3[0] + n3[0] * 1e-4
    oy = q3[1] + n3[1] * 1e-4
    oz = q3[2] + n3[2] * 1e-4
    su0 = (u0 - 0.5) * lightp[L_W]
    su1 = (u1 - 0.5) * lightp[L_D]
    sx = lightp[L_C] + lightp[L_T] * su0 + lightp[L_B] * su1
    sy = lightp[L_C + 1] + lightp[L_T + 1] * su0 + lightp[L_B + 1] * su1
    sz = lightp[L_C + 2] + lightp[L_T + 2] * su0 + lightp[L_B + 2] * su1
    tox, toy, toz = sx - ox, sy - oy, sz - oz
    q2 = tox * tox + toy * toy + toz * toz
    # Division form, matching the trace kernel/oracle ULP-for-ULP: the
    # replayed direction sits under ill-conditioned geometry gradients at
    # grazing pixels, where a 1-ulp drift (rsqrt-multiply form) measurably
    # moves sphere/vert gradients. The saved reciprocal keeps the REVERSE
    # division-free.
    dist = jnp.sqrt(jnp.maximum(q2, 1e-30))
    inv_dist = 1.0 / dist
    ld = (tox / dist, toy / dist, toz / dist)
    pdf_l, res_pl = _fwd_lightpdf(lightp, q3, ld)
    v3 = (-inc3[0], -inc3[1], -inc3[2])
    b3, res_b = _fwd_brdf(v3, n3, df3, met, rgh, ld)
    inv_pdf = 1.0 / pdf_l
    le = (lightp[L_E], lightp[L_E + 1], lightp[L_E + 2])
    cpre = tuple(b3[c] * le[c] * inv_pdf for c in range(3))
    if heuristic:
        pdf_c, raw_pc = _fwd_cospdf(n3, ld)
        pdf_v, res_pv = _fwd_vndf(v3, n3, ld, rgh)
        w, res_w = _fwd_ph3(pdf_l, pdf_c, pdf_v, s_per_f)
        out = tuple(jnp.where(gate, cpre[c] * w, 0.0) for c in range(3))
        res_h = (raw_pc, res_pv, res_w, w)
    else:
        out = tuple(jnp.where(gate, cpre[c], 0.0) for c in range(3))
        res_h = None
    res = (q3, n3, v3, ld, (tox, toy, toz), q2, inv_dist, res_pl, b3,
           res_b, inv_pdf, le, cpre, gate, u0, u1, res_h, lightp)
    return out, res


def _rev_direct_light(res, d_out, d_lightp):
    """Accumulates light cotangents into ``d_lightp``; returns
    (d_q, d_n, d_inc, d_df, d_met, d_rgh)."""
    (q3, n3, v3, ld, to3, q2, inv_dist, res_pl, b3, res_b,
     inv_pdf, le, cpre, gate, u0, u1, res_h, lightp) = res
    zero = d_out[0] * 0.0
    d_b = [zero, zero, zero]
    d_inv_pdf = zero
    d_ld = [zero, zero, zero]
    d_n_acc = [zero, zero, zero]
    d_rgh_acc = zero
    d_pdf_l = zero
    if res_h is not None:
        raw_pc, res_pv, res_w, w = res_h
        d_w = zero
        d_cpre = []
        for c in range(3):
            g = jnp.where(gate, d_out[c], 0.0)
            d_w += cpre[c] * g
            d_cpre.append(w * g)
        d_pl_w, d_pc, d_pv = _rev_ph3(res_w, d_w)
        d_pdf_l += d_pl_w
        dn_c, dd_c = _rev_cospdf(n3, ld, raw_pc, d_pc)
        d_v_pv, dn_v, dd_v, d_rgh_pv = _rev_vndf(res_pv, d_pv)
        d_rgh_acc += d_rgh_pv
        d_v = [d_v_pv[0], d_v_pv[1], d_v_pv[2]]
        for c in range(3):
            d_n_acc[c] += dn_c[c] + dn_v[c]
            d_ld[c] += dd_c[c] + dd_v[c]
    else:
        d_cpre = [jnp.where(gate, d_out[c], 0.0) for c in range(3)]
        d_v = [zero, zero, zero]
    for c in range(3):
        d_b[c] += le[c] * inv_pdf * d_cpre[c]
        d_lightp[L_E + c] += b3[c] * inv_pdf * d_cpre[c]
        d_inv_pdf += b3[c] * le[c] * d_cpre[c]
    d_pdf_l += -(inv_pdf * inv_pdf) * d_inv_pdf
    # brdf
    d_v_b, d_n_b, d_df, d_met, d_rgh_b, d_l_b = _rev_brdf(res_b, tuple(d_b))
    d_rgh_acc += d_rgh_b
    for c in range(3):
        d_v[c] += d_v_b[c]
        d_n_acc[c] += d_n_b[c]
        d_ld[c] += d_l_b[c]
    # light pdf (uses q, ld)
    d_q_pl, d_ld_pl = _rev_lightpdf(res_pl, d_pdf_l, d_lightp)
    for c in range(3):
        d_ld[c] += d_ld_pl[c]
    d_q = [d_q_pl[0], d_q_pl[1], d_q_pl[2]]
    # ld = to * rsqrt(max(to·to, 1e-30)) — same reverse as _rev_norm3
    tox, toy, toz = to3
    d_to = [inv_dist * d_ld[0], inv_dist * d_ld[1], inv_dist * d_ld[2]]
    d_invd = tox * d_ld[0] + toy * d_ld[1] + toz * d_ld[2]
    d_q2 = jnp.where(q2 >= 1e-30,
                     -0.5 * inv_dist * inv_dist * inv_dist * d_invd, 0.0)
    d_to[0] += 2.0 * tox * d_q2
    d_to[1] += 2.0 * toy * d_q2
    d_to[2] += 2.0 * toz * d_q2
    # to = s - o ; s = lc + lt*su0 + lb*su1 ; o = q + n*1e-4
    su0 = (u0 - 0.5)
    su1 = (u1 - 0.5)
    lw = lightp[L_W]
    ldep = lightp[L_D]
    for c in range(3):
        d_s = d_to[c]
        d_lightp[L_C + c] += d_s
        d_lightp[L_T + c] += su0 * lw * d_s
        d_lightp[L_W] += su0 * lightp[L_T + c] * d_s
        d_lightp[L_B + c] += su1 * ldep * d_s
        d_lightp[L_D] += su1 * lightp[L_B + c] * d_s
        d_q[c] += -d_to[c]
        d_n_acc[c] += -1e-4 * d_to[c]
    d_inc = (-d_v[0], -d_v[1], -d_v[2])
    return (tuple(d_q), tuple(d_n_acc), d_inc, d_df, d_met, d_rgh_acc)


def _fwd_bounce(cs, lightp, at2, hit2, sec_reach, sd3, pdf_self, w,
                su0, su1, surf, s_per_f, num_spheres, b2):
    """Shared cosine/VNDF bounce body (shaders.metal:562-623) with the
    recorded closest-hit winner's attributes ``at2`` and the recorded
    secondary light reach ``sec_reach``. The camera-material BRDF toward
    ``sd3`` arrives precomputed (``b2``, from _fwd_bv — its reverse
    returns d_b2 for the caller to route). Mirrors the trace kernel's
    bounce_strategy minus the traversals."""
    off = (cs[CS_OFF], cs[CS_OFF + 1], cs[CS_OFF + 2])
    n2t = (at2[0], at2[1], at2[2])
    c02 = at2[3]
    den2 = sd3[0] * n2t[0] + sd3[1] * n2t[1] + sd3[2] * n2t[2]
    ok2 = jnp.abs(den2) >= 1e-12
    sden2 = jnp.where(ok2, den2, 1.0)
    inv_sden2 = 1.0 / sden2
    num2 = c02 - (off[0] * n2t[0] + off[1] * n2t[1] + off[2] * n2t[2])
    t2p = num2 / sden2   # division form: ULP parity with the trace kernel
    t2 = t2p
    sph = None
    if num_spheres:
        # Analytic sphere replay (mirrors _mis_kernel.sphere_roots /
        # pallas_shade's sphere chain op-for-op).
        is_sph = at2[14] > 0.5
        oc = (off[0] - at2[10], off[1] - at2[11], off[2] - at2[12])
        rad = at2[13]
        a_q = sd3[0] * sd3[0] + sd3[1] * sd3[1] + sd3[2] * sd3[2]
        b_q = 2.0 * (oc[0] * sd3[0] + oc[1] * sd3[1] + oc[2] * sd3[2])
        c_q = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - rad * rad
        disc = b_q * b_q - 4.0 * a_q * c_q
        posd = disc > 0.0
        sq = jnp.sqrt(jnp.where(posd, disc, 1.0))
        t1 = (-b_q - sq) / (2.0 * a_q)
        t2q = (-b_q + sq) / (2.0 * a_q)
        t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
        t_sph = jnp.where(t1_ok, t1, t2q)
        t2 = jnp.where(is_sph, t_sph, t2p)
        sph = dict(is_sph=is_sph, oc=oc, rad=rad, a_q=a_q, b_q=b_q,
                   c_q=c_q, posd=posd, sq=sq, t1=t1, t2q=t2q, t1_ok=t1_ok)
    pdf_ok = pdf_self > 0.0
    inv_pdf = jnp.where(pdf_ok, 1.0 / jnp.where(pdf_ok, pdf_self, 1.0), 0.0)
    isem2 = at2[9] > 0.5
    hit_light = surf & hit2 & isem2
    hit_geo = surf & hit2 & ~isem2
    le = (lightp[L_E], lightp[L_E + 1], lightp[L_E + 2])
    t2s = jnp.where(hit_geo, t2, 0.0)
    bp = (off[0] + sd3[0] * t2s, off[1] + sd3[1] * t2s,
          off[2] + sd3[2] * t2s)
    n2 = n2t
    sphn = None
    if num_spheres:
        sel = hit_geo & sph["is_sph"]
        nv = (bp[0] - at2[10], bp[1] - at2[11], bp[2] - at2[12])
        qn = nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]
        inv_n = jax.lax.rsqrt(jnp.maximum(qn, 1e-6))
        n2 = (jnp.where(sel, nv[0] * inv_n, n2t[0]),
              jnp.where(sel, nv[1] * inv_n, n2t[1]),
              jnp.where(sel, nv[2] * inv_n, n2t[2]))
        sphn = dict(sel=sel, nv=nv, qn=qn, inv_n=inv_n)
    df2 = (at2[4], at2[5], at2[6])
    dl3, res_dl = _fwd_direct_light(lightp, bp, n2, sd3, df2, at2[7],
                                    at2[8], su0, su1, hit_geo & sec_reach,
                                    s_per_f, False)
    out = tuple(jnp.where(hit_light, w * b2[c] * le[c] * inv_pdf, 0.0)
                + jnp.where(hit_geo, b2[c] * inv_pdf * dl3[c], 0.0)
                for c in range(3))
    res = (off, sd3, n2t, ok2, inv_sden2, t2p, sph, b2, pdf_ok,
           inv_pdf, hit_light, hit_geo, le, t2s, bp, sphn, dl3, res_dl, w,
           lightp, at2)
    return out, res


def _rev_bounce(res, d_out, d_lightp, d_at2, num_spheres):
    """Accumulates light/at2 cotangents into ``d_lightp``/``d_at2``
    (lists, mutated); returns a dict of cs-level cotangents plus
    (d_sd, d_pdf_self, d_w)."""
    (off, sd3, n2t, ok2, inv_sden2, t2p, sph, b2, pdf_ok,
     inv_pdf, hit_light, hit_geo, le, t2s, bp, sphn, dl3, res_dl, w,
     lightp, at2) = res
    zero = d_out[0] * 0.0
    d_b2 = [zero, zero, zero]
    d_inv_pdf = zero
    d_w = zero
    d_dl = [zero, zero, zero]
    for c in range(3):
        d_lt = jnp.where(hit_light, d_out[c], 0.0)
        d_g = jnp.where(hit_geo, d_out[c], 0.0)
        # g = b2 * inv_pdf * dl
        d_b2[c] += inv_pdf * dl3[c] * d_g
        d_inv_pdf += b2[c] * dl3[c] * d_g
        d_dl[c] = b2[c] * inv_pdf * d_g
        # lt = w * b2 * le * inv_pdf
        d_w += b2[c] * le[c] * inv_pdf * d_lt
        d_b2[c] += w * le[c] * inv_pdf * d_lt
        d_lightp[L_E + c] += w * b2[c] * inv_pdf * d_lt
        d_inv_pdf += w * b2[c] * le[c] * d_lt
    d_pdf_self = jnp.where(pdf_ok, -(inv_pdf * inv_pdf) * d_inv_pdf, 0.0)
    # secondary direct light
    d_bp_t, d_n2, d_sd_dl, d_df2, d_met2, d_rgh2 = _rev_direct_light(
        res_dl, tuple(d_dl), d_lightp)
    d_bp = list(d_bp_t)
    d_sd = list(d_sd_dl)
    d_at2[4] += d_df2[0]
    d_at2[5] += d_df2[1]
    d_at2[6] += d_df2[2]
    d_at2[7] += d_met2
    d_at2[8] += d_rgh2
    # n2 select (sphere point normal)
    if num_spheres:
        sel = sphn["sel"]
        nv = sphn["nv"]
        inv_n = sphn["inv_n"]
        d_n2t = [jnp.where(sel, 0.0, d_n2[c]) for c in range(3)]
        d_nv = [jnp.where(sel, d_n2[c], 0.0) * inv_n for c in range(3)]
        d_inv_n = (nv[0] * jnp.where(sel, d_n2[0], 0.0)
                   + nv[1] * jnp.where(sel, d_n2[1], 0.0)
                   + nv[2] * jnp.where(sel, d_n2[2], 0.0))
        d_qn = jnp.where(sphn["qn"] >= 1e-6,
                         -0.5 * inv_n * inv_n * inv_n * d_inv_n, 0.0)
        for c in range(3):
            d_nv[c] += 2.0 * nv[c] * d_qn
            d_bp[c] += d_nv[c]
            d_at2[10 + c] += -d_nv[c]
    else:
        d_n2t = [d_n2[0], d_n2[1], d_n2[2]]
    # bp = off + sd * t2s
    d_off = [d_bp[0], d_bp[1], d_bp[2]]
    d_t2s = sd3[0] * d_bp[0] + sd3[1] * d_bp[1] + sd3[2] * d_bp[2]
    for c in range(3):
        d_sd[c] += t2s * d_bp[c]
    d_t2 = jnp.where(hit_geo, d_t2s, 0.0)
    # t2 select: sphere quadratic vs plane
    if num_spheres:
        is_sph = sph["is_sph"]
        d_tsph = jnp.where(is_sph, d_t2, 0.0)
        d_t2p = jnp.where(is_sph, 0.0, d_t2)
        t1_ok = sph["t1_ok"]
        a_q, b_q, c_q = sph["a_q"], sph["b_q"], sph["c_q"]
        d_t1 = jnp.where(t1_ok, d_tsph, 0.0)
        d_t2q = jnp.where(t1_ok, 0.0, d_tsph)
        inv2a = 1.0 / (2.0 * a_q)
        d_b_q = -(d_t1 + d_t2q) * inv2a
        d_sq = (d_t2q - d_t1) * inv2a
        d_a_q = -(sph["t1"] * d_t1 + sph["t2q"] * d_t2q) / a_q
        d_disc = jnp.where(sph["posd"], d_sq / (2.0 * sph["sq"]), 0.0)
        d_b_q += 2.0 * b_q * d_disc
        d_a_q += -4.0 * c_q * d_disc
        d_c_q = -4.0 * a_q * d_disc
        oc = sph["oc"]
        d_at2[13] += -2.0 * sph["rad"] * d_c_q
        for c in range(3):
            d_oc = 2.0 * oc[c] * d_c_q + 2.0 * sd3[c] * d_b_q
            d_sd[c] += 2.0 * oc[c] * d_b_q + 2.0 * sd3[c] * d_a_q
            d_off[c] += d_oc
            d_at2[10 + c] += -d_oc
    else:
        d_t2p = d_t2
    # plane chain: t2p = (c02 - off·n2t) * inv_sden2
    d_num = d_t2p * inv_sden2
    d_sden = -(t2p * inv_sden2) * d_t2p
    d_den2 = jnp.where(ok2, d_sden, 0.0)
    d_at2[3] += d_num
    for c in range(3):
        d_off[c] += -n2t[c] * d_num
        d_n2t[c] += sd3[c] * d_den2 - off[c] * d_num
        d_sd[c] += n2t[c] * d_den2
        d_at2[c] += d_n2t[c]
    return dict(d_off=d_off, d_b2=tuple(d_b2), d_sd=d_sd,
                d_pdf_self=d_pdf_self, d_w=d_w)


def _sample_fwd_rev(cs, lightp, tabsc, reach1, reach2, reach3,
                    hit_c, at_c, hit_v, at_v, surf, gs, s_per_f,
                    d_cs, d_lightp, d_at_c, d_at_v, num_spheres):
    """Forward recompute + hand-written reverse for ONE MIS sample (all
    three strategies). ``gs`` is the upstream rgb cotangent already gated
    by surf and scaled by 1/s_per; ``tabsc`` the sample's table scalar
    draws. Accumulates into the d_* lists (mutated in place). The forward
    mirrors pallas_mis._mis_kernel.one_sample with the hoisted
    sample-invariant frames supplied via ``cs``."""
    m1, m2, m3 = DEBUG_STRATEGY_MASK
    d3 = (cs[CS_D], cs[CS_D + 1], cs[CS_D + 2])
    p3 = (cs[CS_P], cs[CS_P + 1], cs[CS_P + 2])
    nh3 = (cs[CS_NH], cs[CS_NH + 1], cs[CS_NH + 2])
    t3 = (cs[CS_T], cs[CS_T + 1], cs[CS_T + 2])
    b3 = (cs[CS_B], cs[CS_B + 1], cs[CS_B + 2])
    ve3 = (cs[CS_VE], cs[CS_VE + 1], cs[CS_VE + 2])
    t1v3 = (cs[CS_T1], cs[CS_T1 + 1], cs[CS_T1 + 2])
    t2v3 = (cs[CS_T2], cs[CS_T2 + 1], cs[CS_T2 + 2])
    alpha = cs[CS_ALPHA]
    off3 = (cs[CS_OFF], cs[CS_OFF + 1], cs[CS_OFF + 2])

    def apply_bv(bv):
        """Route a _rev_bv cotangent dict into the hoisted-plane slots."""
        for c in range(3):
            d_cs[CS_V + c] += bv["d_v"][c]
            d_cs[CS_NH + c] += bv["d_n"][c]
            d_cs[CS_DF + c] += bv["d_df"][c]
            d_cs[CS_F0 + c] += bv["d_f0"][c]
        d_cs[CS_RGH] += bv["d_rgh"]
        d_cs[CS_ALPHA] += bv["d_a"]
        d_cs[CS_CNDV] += bv["d_ndv"]
        d_cs[CS_CSQV] += bv["d_sqv"]
        d_cs[CS_OMM] += bv["d_omm"]
        d_cs[CS_G1] += bv["d_g1"]
        d_cs[CS_VNDV] += bv["d_vndv"]

    # ---- Strategy 1: light sampling (heuristic-weighted) ----------------
    if m1:
        ld1, res_ls1 = _fwd_lsample(lightp, off3, tabsc[TAB_LU0],
                                    tabsc[TAB_LU1])
        pdf_l1, res_pl1 = _fwd_lightpdf(lightp, p3, ld1)
        b1, pdf_v1, res_bv1 = _fwd_bv(cs, ld1)
        pdf_c1, raw_pc1 = _fwd_cospdf(nh3, ld1)
        w1, res_w1 = _fwd_ph3(pdf_l1, pdf_c1, pdf_v1, s_per_f)
        inv_pdf1 = 1.0 / pdf_l1
        le = (lightp[L_E], lightp[L_E + 1], lightp[L_E + 2])
        gate1 = surf & reach1
        # reverse: out_c = where(gate1, (b1_c·le_c·inv_pdf1)·w1, 0)
        zero = gs[0] * 0.0
        d_w = zero
        d_invp = zero
        d_b1 = []
        for c in range(3):
            g = jnp.where(gate1, gs[c], 0.0)
            cpre = b1[c] * le[c] * inv_pdf1
            d_w += cpre * g
            d_cpre = w1 * g
            d_b1.append(le[c] * inv_pdf1 * d_cpre)
            d_lightp[L_E + c] += b1[c] * inv_pdf1 * d_cpre
            d_invp += b1[c] * le[c] * d_cpre
        d_pdf_l1 = -(inv_pdf1 * inv_pdf1) * d_invp
        d_pl, d_pc, d_pv = _rev_ph3(res_w1, d_w)
        d_pdf_l1 += d_pl
        d_n_pc, d_d_pc = _rev_cospdf(nh3, ld1, raw_pc1, d_pc)
        bv = _rev_bv(res_bv1, tuple(d_b1), d_pv)
        apply_bv(bv)
        d_q_pl, d_dir_pl = _rev_lightpdf(res_pl1, d_pdf_l1, d_lightp)
        d_ld = [bv["d_l"][c] + d_d_pc[c] + d_dir_pl[c] for c in range(3)]
        d_off1 = _rev_lsample(res_ls1, d_ld, d_lightp)
        for c in range(3):
            d_cs[CS_P + c] += d_q_pl[c]
            d_cs[CS_NH + c] += d_n_pc[c]
            d_cs[CS_OFF + c] += d_off1[c]

    # ---- Strategy 2: cosine-weighted bounce -----------------------------
    if m2:
        # Host-precomputed direction scalars (see _sample_tables).
        w0 = tabsc[TAB_W0C]
        w1 = tabsc[TAB_W1C]
        cth = tabsc[TAB_CTH]
        raw = tuple(t3[c] * w0 + b3[c] * w1 + nh3[c] * cth
                    for c in range(3))
        cd3, res_cd = _fwd_norm3(raw[0], raw[1], raw[2], 1e-12)
        pdf_c, raw_pc = _fwd_cospdf(nh3, cd3)
        pdf_l, res_pl = _fwd_lightpdf(lightp, p3, cd3)
        b2, pdf_v, res_bv = _fwd_bv(cs, cd3)
        w_c, res_w = _fwd_ph3(pdf_c, pdf_l, pdf_v, s_per_f)
        _, res_bo = _fwd_bounce(cs, lightp, at_c, hit_c, reach2, cd3,
                                pdf_c, w_c, tabsc[TAB_CSU0],
                                tabsc[TAB_CSU1], surf, s_per_f,
                                num_spheres, b2)
        bo = _rev_bounce(res_bo, gs, d_lightp, d_at_c, num_spheres)
        d_cd = list(bo["d_sd"])
        d_p1, d_p2, d_p3v = _rev_ph3(res_w, bo["d_w"])
        d_pdf_c = bo["d_pdf_self"] + d_p1
        bv = _rev_bv(res_bv, bo["d_b2"], d_p3v)
        apply_bv(bv)
        d_q_pl, d_dir_pl = _rev_lightpdf(res_pl, d_p2, d_lightp)
        d_n_pc, d_d_pc = _rev_cospdf(nh3, cd3, raw_pc, d_pdf_c)
        for c in range(3):
            d_cd[c] += bv["d_l"][c] + d_dir_pl[c] + d_d_pc[c]
        d_raw = _rev_norm3(res_cd, d_cd[0], d_cd[1], d_cd[2])
        for c in range(3):
            d_cs[CS_OFF + c] += bo["d_off"][c]
            d_cs[CS_NH + c] += d_n_pc[c] + cth * d_raw[c]
            d_cs[CS_P + c] += d_q_pl[c]
            d_cs[CS_T + c] += w0 * d_raw[c]
            d_cs[CS_B + c] += w1 * d_raw[c]

    # ---- Strategy 3: VNDF-GGX bounce ------------------------------------
    if m3:
        k0 = tabsc[TAB_K0V]
        k1 = tabsc[TAB_K1V]
        vct = tabsc[TAB_VCT]
        hraw = tuple(t1v3[c] * k0 + t2v3[c] * k1 + ve3[c] * vct
                     for c in range(3))
        h3, res_h = _fwd_norm3(hraw[0], hraw[1], hraw[2], 1e-12)
        mz = jnp.maximum(0.0, h3[2])
        nl3, res_nl = _fwd_norm3(alpha * h3[0], alpha * h3[1], mz, 1e-12)
        whraw = tuple(t3[c] * nl3[0] + b3[c] * nl3[1] + nh3[c] * nl3[2]
                      for c in range(3))
        wh3, res_wh = _fwd_norm3(whraw[0], whraw[1], whraw[2], 1e-12)
        ddh = d3[0] * wh3[0] + d3[1] * wh3[1] + d3[2] * wh3[2]
        vd3 = tuple(d3[c] - 2.0 * ddh * wh3[c] for c in range(3))
        b2v, pdf_v2, res_bv3 = _fwd_bv(cs, vd3)
        pdf_l2, res_pl3 = _fwd_lightpdf(lightp, p3, vd3)
        pdf_c2, raw_pc3 = _fwd_cospdf(nh3, vd3)
        w_v, res_w3 = _fwd_ph3(pdf_v2, pdf_l2, pdf_c2, s_per_f)
        _, res_bo3 = _fwd_bounce(cs, lightp, at_v, hit_v, reach3, vd3,
                                 pdf_v2, w_v, tabsc[TAB_VSU0],
                                 tabsc[TAB_VSU1], surf, s_per_f,
                                 num_spheres, b2v)
        bo = _rev_bounce(res_bo3, gs, d_lightp, d_at_v, num_spheres)
        d_vd = list(bo["d_sd"])
        d_p1, d_p2, d_p3v = _rev_ph3(res_w3, bo["d_w"])
        d_pdf_v2 = bo["d_pdf_self"] + d_p1
        d_n_pc, d_d_pc = _rev_cospdf(nh3, vd3, raw_pc3, d_p3v)
        d_q_pl, d_dir_pl = _rev_lightpdf(res_pl3, d_p2, d_lightp)
        bv = _rev_bv(res_bv3, bo["d_b2"], d_pdf_v2)
        apply_bv(bv)
        for c in range(3):
            d_vd[c] += d_d_pc[c] + d_dir_pl[c] + bv["d_l"][c]
        # vd = d - 2*ddh*wh ; ddh = d·wh
        d_ddh = -2.0 * (wh3[0] * d_vd[0] + wh3[1] * d_vd[1]
                        + wh3[2] * d_vd[2])
        d_wh = [-2.0 * ddh * d_vd[c] for c in range(3)]
        d_d_loc = [d_vd[c] for c in range(3)]
        for c in range(3):
            d_d_loc[c] += wh3[c] * d_ddh
            d_wh[c] += d3[c] * d_ddh
        d_whraw = _rev_norm3(res_wh, d_wh[0], d_wh[1], d_wh[2])
        d_nlx = (t3[0] * d_whraw[0] + t3[1] * d_whraw[1]
                 + t3[2] * d_whraw[2])
        d_nly = (b3[0] * d_whraw[0] + b3[1] * d_whraw[1]
                 + b3[2] * d_whraw[2])
        d_nlz = (nh3[0] * d_whraw[0] + nh3[1] * d_whraw[1]
                 + nh3[2] * d_whraw[2])
        d_nraw = _rev_norm3(res_nl, d_nlx, d_nly, d_nlz)
        d_cs[CS_ALPHA] += h3[0] * d_nraw[0] + h3[1] * d_nraw[1]
        d_h = (alpha * d_nraw[0], alpha * d_nraw[1],
               jnp.where(h3[2] >= 0.0, d_nraw[2], 0.0))
        d_hraw = _rev_norm3(res_h, d_h[0], d_h[1], d_h[2])
        for c in range(3):
            d_cs[CS_T1 + c] += k0 * d_hraw[c]
            d_cs[CS_T2 + c] += k1 * d_hraw[c]
            d_cs[CS_VE + c] += vct * d_hraw[c]
            d_cs[CS_T + c] += nl3[0] * d_whraw[c]
            d_cs[CS_B + c] += nl3[1] * d_whraw[c]
            d_cs[CS_OFF + c] += bo["d_off"][c]
            d_cs[CS_D + c] += d_d_loc[c]
            d_cs[CS_NH + c] += d_n_pc[c] + nl3[2] * d_whraw[c]
            d_cs[CS_P + c] += d_q_pl[c]


def _mis_bwd_kernel(config: RenderConfig, n_pixels: int, n_prims: int,
                    num_spheres: int,
                    g_r_ref, g_g_ref, g_b_ref, crec_ref, srec_ref,
                    rid_base_ref, tab_ref, cam_ref, light_ref, stab_ref,
                    dpart_ref, dscal_ref):
    """One program = (ray tile, camera ray): replay every sample from the
    records and accumulate parameter cotangents via the HAND-WRITTEN
    reverse sweep (_sample_fwd_rev). The sample-invariant camera stage —
    camera ray, camera hit, ortho basis, VNDF view frame, offset origin —
    runs (and is linearized via one jax.vjp) ONCE per program; the
    per-sample sweep consumes its outputs as independent planes and its
    vjp is applied once to the accumulated cotangents at the end (vjps are
    linear in the cotangent, so this is exactly the same gradient at
    1/s_per the camera-stage work)."""
    TILE = pm.TILE
    W = config.width
    H = config.height
    P = n_prims
    ndif = NDIF_SPH if num_spheres else NDIF
    s_per = config.mis_samples // 3

    pid = pl.program_id(0)
    cr_i = pl.program_id(1)  # camera-ray index
    lane = jax.lax.broadcasted_iota(_I32, (TILE,), 0)
    rid = rid_base_ref[0, 0] + pid * TILE + lane
    pxi = rid % W
    pyi = rid // W
    px = pxi.astype(_F32)
    py = pyi.astype(_F32)
    in_image = rid < n_pixels

    g3 = (g_r_ref[...], g_g_ref[...], g_b_ref[...])
    zero = px * 0.0
    route.zero_partials(dpart_ref, ndif, dpart_ref.shape[2])

    cam12 = [cam_ref[0, k] for k in range(NCAM)]
    light17 = [light_ref[0, k] for k in range(NLIGHT)]
    # Broadcast the scalar parameters to planes so their cotangents come
    # back as planes (partial sums deferred to one final reduction per
    # program instead of 29 scalar reductions per sample).
    camp0 = tuple(zero + c for c in cam12)
    lightp = tuple(zero + c for c in light17)

    def fetch(code):
        """code (prim + 1, 0 = miss) -> (hit, pc, at: ndif gathered
        planes). Miss lanes gather primitive 0; consumers gate by hit."""
        prim = code - 1
        pc = jnp.clip(prim, 0, P - 1)
        hit = prim >= 0
        return hit, pc, [tab_ref[r, pc] for r in range(ndif)]

    def accum_tab(pc, hit, d_at):
        route.accumulate_rows(dpart_ref, pc, hit, d_at, P)

    def sphere_t(at_, ox, oy, oz, dx, dy, dz, tt_plane):
        """Select the analytic sphere root on is_sphere lanes (mirrors
        _mis_kernel.sphere_roots op-for-op => bit-equal t replay). No-op
        for triangle-only scenes."""
        if not num_spheres:
            return tt_plane
        is_sph = at_[14] > 0.5
        ocx, ocy, ocz = ox - at_[10], oy - at_[11], oz - at_[12]
        a_q = dx * dx + dy * dy + dz * dz
        b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - at_[13] * at_[13]
        disc = b_q * b_q - 4.0 * a_q * c_q
        posd = disc > 0.0
        sq = jnp.sqrt(jnp.where(posd, disc, 1.0))
        t1 = (-b_q - sq) / (2.0 * a_q)
        t2 = (-b_q + sq) / (2.0 * a_q)
        t1_ok = (t1 > RAY_TMIN) & (t1 < RAY_TMAX)
        return jnp.where(is_sph, jnp.where(t1_ok, t1, t2), tt_plane)

    def sphere_normal(at_, p_x, p_y, p_z, active, nh3):
        """Point normal (p − center)/‖·‖ on active sphere lanes (mirrors
        _mis_kernel.closest_full's post-loop normal select)."""
        if not num_spheres:
            return nh3
        sel = active & (at_[14] > 0.5)
        nvx, nvy, nvz = p_x - at_[10], p_y - at_[11], p_z - at_[12]
        inv = jax.lax.rsqrt(jnp.maximum(
            nvx * nvx + nvy * nvy + nvz * nvz, 1e-6))
        return (jnp.where(sel, nvx * inv, nh3[0]),
                jnp.where(sel, nvy * inv, nh3[1]),
                jnp.where(sel, nvz * inv, nh3[2]))

    # hashRandom jitter (non-differentiable; mirrors the trace kernel).
    xi = pxi.astype(_U32)
    yi = pyi.astype(_U32)
    iu = jnp.full((), 0, _U32) + cr_i.astype(_U32)
    sample_id = (yi * _U32(800) + xi) * iu
    jx = _u32_to_f32(_hash_u32(xi + yi * _U32(800) + sample_id))
    jy = _u32_to_f32(_hash_u32(yi + xi * _U32(600) + sample_id
                               + _U32(12345)))

    crec = crec_ref[...]
    cam_hit, pc_cam, at_cam = fetch(crec)
    cam_hit = cam_hit & in_image
    isem_cam = at_cam[9] > 0.5
    cam_hit_light = cam_hit & isem_cam
    surf = cam_hit & ~isem_cam

    def hoist_stage(at_cam_, camp_):
        """All sample-invariant continuous math: camera ray + camera-hit
        surface from the recorded winner's plane equation (same expression
        as the closest-hit loop => bit-equal t), the ortho basis, and the
        VNDF view frame. Linearized once per (tile, camera ray)."""
        pos, uhw, vhh, wv = (camp_[0:3], camp_[3:6], camp_[6:9],
                             camp_[9:12])
        s = ((px + jx) / _F32(W)) * 2.0 - 1.0
        t = -(((py + jy) / _F32(H)) * 2.0 - 1.0)
        dx = s * uhw[0] + t * vhh[0] - wv[0]
        dy = s * uhw[1] + t * vhh[1] - wv[1]
        dz = s * uhw[2] + t * vhh[2] - wv[2]
        dx, dy, dz = _normalize3(dx, dy, dz)
        ox, oy, oz = pos[0], pos[1], pos[2]
        nhx, nhy, nhz = at_cam_[0], at_cam_[1], at_cam_[2]
        c0 = at_cam_[3]
        den = dx * nhx + dy * nhy + dz * nhz
        ok = jnp.abs(den) >= 1e-12
        tt = (c0 - (ox * nhx + oy * nhy + oz * nhz)) \
            / jnp.where(ok, den, 1.0)
        tt = sphere_t(at_cam_, ox, oy, oz, dx, dy, dz, tt)
        t_safe = jnp.where(surf, tt, 0.0)
        p_x = ox + dx * t_safe
        p_y = oy + dy * t_safe
        p_z = oz + dz * t_safe
        nhx, nhy, nhz = sphere_normal(at_cam_, p_x, p_y, p_z, surf,
                                      (nhx, nhy, nhz))
        met = at_cam_[7]
        rgh = at_cam_[8]
        tx, ty, tz, bx, by, bz = _ortho_basis(nhx, nhy, nhz)
        vx, vy, vz = -dx, -dy, -dz
        alpha = rgh * rgh
        vtx = _dot3(vx, vy, vz, tx, ty, tz)
        vtb = _dot3(vx, vy, vz, bx, by, bz)
        vtn = _dot3(vx, vy, vz, nhx, nhy, nhz)
        vex, vey, vez = _normalize3(alpha * vtx, alpha * vtb, vtn)
        t1x, t1y, t1z = _normalize3(vez, vez * 0.0, -vex)
        t2x, t2y, t2z = _cross3(vex, vey, vez, t1x, t1y, t1z)
        # Camera-material BRDF/VNDF invariants (consumed by _fwd_bv).
        cndv_raw = nhx * vx + nhy * vy + nhz * vz
        cndv = jnp.abs(cndv_raw) + 1e-5
        comm = 1.0 - met
        f0r = 0.04 * comm + at_cam_[4] * met
        f0g = 0.04 * comm + at_cam_[5] * met
        f0b = 0.04 * comm + at_cam_[6] * met
        csqv = jnp.sqrt(jnp.maximum(
            (-cndv * alpha + cndv) * cndv + alpha, 1e-12))
        vndv = jnp.abs(cndv_raw)
        nv2h = jnp.maximum(vndv * vndv, 1e-12)
        g1v = 2.0 / (1.0 + jnp.sqrt(
            1.0 + (alpha * alpha) * (1.0 - nv2h) / nv2h))
        return (dx, dy, dz, p_x, p_y, p_z, nhx, nhy, nhz,
                at_cam_[4], at_cam_[5], at_cam_[6], met, rgh,
                tx, ty, tz, bx, by, bz, vex, vey, vez,
                t1x, t1y, t1z, t2x, t2y, t2z, alpha,
                p_x + nhx * 1e-4, p_y + nhy * 1e-4, p_z + nhz * 1e-4,
                vx, vy, vz, cndv, csqv, f0r, f0g, f0b, comm, g1v, vndv)

    cs, vjp_hoist = jax.vjp(hoist_stage, at_cam, camp0)

    inv_s = _F32(1.0 / s_per)
    s_per_f = _F32(s_per)
    gs = tuple(jnp.where(surf, g3[c] * inv_s, 0.0) for c in range(3))

    def one_sample(s_i32, carry):
        d_cs_t, dlightp_t = carry
        tabsc = [stab_ref[k, s_i32] for k in range(NTAB_EXT)]
        srec = srec_ref[pl.ds(s_i32 * TILE, TILE)]
        reach1 = (srec & 1) == 1
        reach2 = ((srec >> 1) & 1) == 1
        reach3 = ((srec >> 2) & 1) == 1
        code_c = (srec >> REC_SHIFT_C) & REC_CODE_MASK
        code_v = (srec >> REC_SHIFT_V) & REC_CODE_MASK
        # Fetch/accumulate only for the strategies that are enabled (the
        # masks are static; the debug bisection knob then measures each
        # strategy's true cost including its fetch site).
        _, m2_, m3_ = DEBUG_STRATEGY_MASK
        accum_sites = []
        d_cs = list(d_cs_t)
        d_lightp = list(dlightp_t)
        hit_c = hit_v = surf
        at_c = at_v = [zero for _ in range(ndif)]
        d_at_c = [zero for _ in range(ndif)]
        d_at_v = [zero for _ in range(ndif)]
        if m2_:
            hit_c, pc_c, at_c = fetch(code_c)
            accum_sites.append((pc_c, hit_c, d_at_c))
        if m3_:
            hit_v, pc_v, at_v = fetch(code_v)
            accum_sites.append((pc_v, hit_v, d_at_v))
        _sample_fwd_rev(cs, lightp, tabsc, reach1, reach2, reach3,
                        hit_c, at_c, hit_v, at_v, surf, gs, s_per_f,
                        d_cs, d_lightp, d_at_c, d_at_v, num_spheres)
        for pc_s, hit_s, d_at in accum_sites:
            accum_tab(pc_s, hit_s, d_at)
        return tuple(d_cs), tuple(d_lightp)

    # Camera-ray-hits-light term: acc += where(chl, emitted_radiance); its
    # only cotangent is d(emitted_radiance) — hand-accumulated.
    zlight = [zero for _ in range(NLIGHT)]
    for c in range(3):
        zlight[L_E + c] = jnp.where(cam_hit_light, g3[c], 0.0)

    d_cs0 = tuple(zero for _ in range(NCS))
    d_cs, dlightp = jax.lax.fori_loop(
        0, s_per, one_sample, (d_cs0, tuple(zlight)))

    d_at_cam, dcamp = vjp_hoist(d_cs)
    accum_tab(pc_cam, cam_hit, list(d_at_cam))
    for k, p in enumerate(dcamp + dlightp):
        dscal_ref[0, k] = jnp.sum(p)


def _bwd_pallas(config: RenderConfig, n_prims: int, num_spheres: int,
                g_planes, recs, tab, cam_vec, light_vec, stab,
                interpret: bool, rid_base=None, local_n=None):
    """Run the backward kernel over a (ray tile, camera ray) grid; returns
    (d_tab [ndif, P], d_scal [NSCAL]) summed over programs."""
    TILE = pm.TILE
    n_pixels = config.num_pixels
    local_n = n_pixels if local_n is None else local_n
    if rid_base is None:
        rid_base = jnp.zeros((1, 1), jnp.int32)
    n_tiles = (local_n + TILE - 1) // TILE
    cr_n = config.camera_rays
    s_per = config.mis_samples // 3
    ndif = NDIF_SPH if num_spheres else NDIF
    p_pad = route.padded_prims(n_prims)
    tab = jnp.pad(tab, ((0, route.next_pow2(tab.shape[0]) - tab.shape[0]),
                        (0, p_pad - tab.shape[1])))

    ray_spec = pl.BlockSpec((TILE,), lambda i, j: (i,))
    kernel = partial(_mis_bwd_kernel, config, n_pixels, n_prims,
                     num_spheres)
    dpart, dscal = pl.pallas_call(
        kernel,
        grid=(n_tiles, cr_n),
        in_specs=[
            ray_spec, ray_spec, ray_spec,                    # g r/g/b
            pl.BlockSpec((TILE,), lambda i, j: (i * cr_n + j,)),
            pl.BlockSpec((s_per * TILE,), lambda i, j: (i * cr_n + j,)),
        ] + [pl.no_block_spec] * 5,
        out_specs=(
            pl.BlockSpec((1, ndif, p_pad), lambda i, j: (i * cr_n + j, 0, 0)),
            pl.BlockSpec((1, NSCAL_PAD), lambda i, j: (i * cr_n + j, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((n_tiles * cr_n, ndif, p_pad), _F32),
            jax.ShapeDtypeStruct((n_tiles * cr_n, NSCAL_PAD), _F32)),
        backend="triton",
        compiler_params=route.compiler_params(),
        interpret=interpret,
        name="mis_backward",
    )(*g_planes, *recs, jnp.asarray(rid_base, jnp.int32).reshape(1, 1),
      tab, route.pad_pow2(cam_vec), route.pad_pow2(light_vec),
      route.pad_pow2(stab))
    return (jnp.sum(dpart, axis=0)[:, :n_prims],
            jnp.sum(dscal, axis=0)[:NSCAL])


# ---------------------------------------------------------------------------
# custom_vjp wrapper: forward = the MIS trace kernel's own hdr (identity);
# backward = the kernel above.
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _attach_grad_mis(config: RenderConfig, interpret, hdr, tab, cam_vec,
                     light_vec, stab, recs, rid_base):
    return hdr


def _attach_fwd(config, interpret, hdr, tab, cam_vec, light_vec, stab, recs,
                rid_base):
    return hdr, (tab, cam_vec, light_vec, stab, recs, rid_base)


def _attach_bwd(config, interpret, resids, g):
    tab, cam_vec, light_vec, stab, recs, rid_base = resids
    n_prims = tab.shape[1]
    num_spheres = 1 if tab.shape[0] == NDIF_SPH else 0
    # Shard-local cotangent ([H, W, 3] single-device; flat [local, 3] under
    # shard_map).
    local_n = g.shape[0] * (g.shape[1] if g.ndim == 3 else 1)
    n_padded = ((local_n + pm.TILE - 1) // pm.TILE) * pm.TILE

    gs = g.reshape(-1, 3)
    gs = jnp.pad(gs, ((0, n_padded - local_n), (0, 0)))
    g_planes = tuple(gs[:, c] for c in range(3))
    d_tab, dscal = _bwd_pallas(config, n_prims, num_spheres, g_planes, recs,
                               tab, cam_vec, light_vec, stab, interpret,
                               rid_base=rid_base, local_n=local_n)
    # d_tab: [ndif, P]; is_em/is_sphere rows are zero.
    d_cam = dscal[0:NCAM].reshape(1, NCAM)
    d_light = dscal[NCAM:NSCAL].reshape(1, NLIGHT)
    d_stab = jnp.zeros_like(stab)        # stop-gradient'd RNG draws
    d_recs = jax.tree.map(
        lambda x: np.zeros(x.shape, jax.dtypes.float0), recs)
    d_rid = np.zeros(rid_base.shape, jax.dtypes.float0)
    return g, d_tab, d_cam, d_light, d_stab, d_recs, d_rid


_attach_grad_mis.defvjp(_attach_fwd, _attach_bwd)


def _pack_diff_inputs_mis(scene: Scene, config: RenderConfig):
    """Differentiable jnp packing of the backward kernel's parameter views —
    cotangents chain back to the scene pytree (verts via compile_scene,
    camera via camera_basis, light frame via build_orthonormal_basis,
    sphere center/radius directly). Column order matches the trace kernel's
    record encoding: triangles first, then spheres."""
    compiled = compile_scene(scene.triangles, lane_pad=1)
    tab = jnp.stack([
        compiled.n[:, 0], compiled.n[:, 1], compiled.n[:, 2], compiled.c0,
        compiled.diffuse[:, 0], compiled.diffuse[:, 1], compiled.diffuse[:, 2],
        compiled.metallic, compiled.roughness,
        compiled.is_emissive.astype(_F32),
    ])  # [NDIF, T]
    sp = scene.spheres
    if sp.num_spheres:
        n_t = scene.triangles.num_triangles
        n_s = sp.num_spheres
        sph_is_em = (jnp.linalg.norm(sp.emissive, axis=-1)
                     > 0.0).astype(_F32)
        sph_cols = jnp.concatenate([
            jnp.zeros((4, n_s), _F32),               # n, c0 (computed)
            sp.diffuse.T,
            sp.metallic.reshape(1, -1), sp.roughness.reshape(1, -1),
            sph_is_em.reshape(1, -1),
        ], axis=0)                                   # [NDIF, S]
        extra = jnp.concatenate([                    # rows 10-14
            jnp.zeros((5, n_t), _F32),
            jnp.concatenate([sp.center.T, sp.radius.reshape(1, -1),
                             jnp.ones((1, n_s), _F32)], axis=0),
        ], axis=1)                                   # [5, T + S]
        tab = jnp.concatenate(
            [jnp.concatenate([tab, sph_cols], axis=1), extra],
            axis=0)                                  # [NDIF_SPH, T + S]

    light = scene.light
    lnorm = jnp.asarray(light.normal, _F32)
    lt, lb = smp.build_orthonormal_basis(lnorm)
    light_vec = jnp.concatenate([
        jnp.asarray(light.center, _F32).reshape(-1),
        jnp.asarray(light.emitted_radiance, _F32).reshape(-1),
        jnp.asarray(light.width, _F32).reshape(1),
        jnp.asarray(light.depth, _F32).reshape(1),
        lnorm.reshape(-1), lt.reshape(-1), lb.reshape(-1),
    ]).reshape(1, NLIGHT)
    return tab, camera_vec(scene, config), light_vec


def _sample_tables(config: RenderConfig):
    """The kernel's pixel-independent sample tables, EXTENDED with the
    derived direction-sampling scalars [NTAB_EXT, s_per].

    Rows 0-9 are the shared draws (sampling.mis_sample_table_rows — same
    as the forward kernel and oracle). Rows 10-15 precompute the cosine /
    VNDF direction chains' per-sample transcendentals host-side:
    w0 = cos(2πu0)·sinθ, w1 = sin(2πu0)·sinθ, cosθ (cosine strategy) and
    k0, k1, cosθ_v (VNDF strategy). The values are pure functions of the
    static table, so the kernel reads them as scalars instead of
    evaluating 8 cos/sin/sqrt per sample. Computed with the same f32 jnp
    ops the oracle uses."""
    rows = smp.mis_sample_table_rows(config.mis_samples, config.sampler)
    u_c0, u_c1 = rows[TAB_CU0], rows[TAB_CU1]
    phi = _F32(2.0 * PI) * u_c0
    cth = jnp.sqrt(u_c1)
    sth = jnp.sqrt(jnp.maximum(1.0 - u_c1, 0.0))
    w0 = jnp.cos(phi) * sth
    w1 = jnp.sin(phi) * sth
    vphi = _F32(2.0 * PI) * rows[TAB_VU0]
    ctm = _F32(1.0 / math.sqrt(2.0))
    vct = ctm + (1.0 - ctm) * rows[TAB_VU1]
    vst = jnp.sqrt(jnp.maximum(0.0, 1.0 - vct * vct))
    k0 = jnp.cos(vphi) * vst
    k1 = jnp.sin(vphi) * vst
    return jnp.concatenate(
        [rows, jnp.stack([w0, w1, cth, k0, k1, vct])], axis=0)


def render_mis_fused(scene: Scene, config: RenderConfig,
                     interpret=None, occluders=None) -> jnp.ndarray:
    """Variant-A differentiable MIS render at megakernel speed: the trace
    kernel's hdr with the record-replay backward attached. Handles
    triangle and sphere scenes (sphere lanes replay the analytic
    quadratic with hand-derived reverses — center/radius gradients at
    kernel speed) at any triangle count (the backward is record-driven).
    Returns [H, W, 3] raw accumulated HDR.
    ``occluders``: optional ``intersect.potential_occluders(scene,
    config)`` static tuple culling provably-non-occluding triangles from
    the light probes."""
    interpret = route.interpret_mode(interpret)
    hdr, recs = _render_mis_impl(jax.lax.stop_gradient(scene), config,
                                 interpret=interpret, emit_records=True,
                                 occluders=occluders)
    tab, cam_vec, light_vec = _pack_diff_inputs_mis(scene, config)
    stab = _sample_tables(config)
    return _attach_grad_mis(config, interpret, hdr, tab, cam_vec, light_vec,
                            stab, tuple(recs), jnp.zeros((1, 1), jnp.int32))


def render_mis_fused_local(scene: Scene, config: RenderConfig, local_n,
                           rid_base, interpret=None, occluders=None):
    """Shard-local fused MIS render for use inside ``shard_map``
    (parallel/fast.render_mis_fused_sharded): renders the pixels
    [rid_base, rid_base + local_n) and returns flat [local_n, 3] hdr with
    the hand-written backward attached. Cotangents for the replicated
    scene parameters are per-shard partials — shard_map's transpose
    inserts the psum."""
    interpret = route.interpret_mode(interpret)
    hdr, recs = _render_mis_impl(jax.lax.stop_gradient(scene), config,
                                 interpret=interpret, emit_records=True,
                                 occluders=occluders, local_n=local_n,
                                 rid_base=rid_base, flat_output=True)
    tab, cam_vec, light_vec = _pack_diff_inputs_mis(scene, config)
    stab = _sample_tables(config)
    return _attach_grad_mis(config, interpret, hdr, tab, cam_vec, light_vec,
                            stab, tuple(recs), rid_base)


def render_mis_decoupled(scene: Scene, config: RenderConfig,
                         occluders=None) -> jnp.ndarray:
    """Fast differentiable variant-A render: the trace kernel forward with
    the record-replay backward, for every scene type. Value matches the
    megakernel/oracle; gradients match jax.grad of the oracle."""
    return render_mis_fused(scene, config, occluders=occluders)

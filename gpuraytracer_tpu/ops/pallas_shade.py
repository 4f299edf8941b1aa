"""Hand-written Pallas backward for the decoupled path tracer.

The trace kernel (pallas_path.py, ``emit_records=True``) writes one int32
visibility record per (sample, bounce, ray); with the random draws (read
from pregenerated planes or regenerated here) those records fix every
discrete decision of the forward. This module attaches a ``custom_vjp``
whose forward is the trace kernel's hdr, unchanged, and whose backward is
one Pallas kernel (Triton route) that recomputes each sample's path from
the records on chip and walks the bounces in reverse, accumulating:

  * per-primitive cotangents (normal, plane constant, diffuse, emissive,
    and sphere center/radius) into this program's own block of a
    [programs, rows, P] partial-sum array, by one-hot sums over the
    primitives the program's lanes hit (route.accumulate_rows); the blocks
    are added afterwards by ``jnp.sum`` — deterministic, no atomics;
  * camera cotangents (position, prescaled basis) and light cotangents
    (center, color, normal) as per-lane partial sums, reduced once per
    program into its row of a [programs, NSCAL] array.

The reverse-mode math mirrors the jnp replay (ops/decoupled.py)
expression-for-expression (same clip gates with >=/<= bounds, same
normalize-by-divide chains), so gradients match ``jax.grad`` of the replay
— and therefore of the jnp oracle renderer — to fp32 rounding (asserted in
tests/test_pallas_shade.py).

Scope: triangle AND sphere scenes. Sphere hits replay the analytic quadratic
(reference: intersectSphere, shaders_old.metal:108-136) and its hand-derived
reverse, so sphere-center/radius cotangents flow at kernel speed (BASELINE
config 4's inverse-rendering workload); visibility stays piecewise-constant
exactly like the oracle's AD. Reference for the forward being
differentiated: RTrace/raytrace.metal:11-111.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..intersect import compile_scene
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from . import pallas_path as pp
from . import route
from .pallas_path import (OCC_BIT, _halton_tile, _render_pallas_impl,
                          camera_jitter, camera_vec)

_F32 = jnp.float32
_I32 = jnp.int32
_U32 = jnp.uint32

# Differentiable table rows: n(3), c0, diffuse(3), emissive(3) — plus, for
# sphere scenes, center(3) and radius. The packed table additionally carries
# the non-differentiable is_emissive (and is_sphere) selector rows.
NTAB = 10
NTAB_SPH = 14
NROWS_TAB = 11
NROWS_TAB_SPH = 16
NSCAL = 21  # pos(3) hu(3) hv(3) wb(3) lc(3) lcol(3) ln(3)
NSCAL_PAD = 32


def _shade_bwd_kernel(config: RenderConfig, n_pixels: int, num_prims: int,
                      num_spheres: int, recompute_rng: bool, blocked: bool,
                      *refs):
    """One program: recompute every sample's path for TILE rays from the
    records, then reverse the bounce chain accumulating parameter
    cotangents.

    ``recompute_rng``: the trace pass emitted only the int32 records
    (records_only mode — BASELINE config 5's memory fix); the jitter and
    NEE/cosine draws are regenerated here from the RNG offsets with the
    same f32 Halton digits as the trace kernel — zero extra HBM planes.

    The replay is record-driven: attribute fetches are gathers and the
    cotangent sums cover only the primitives this program's lanes hit, so
    the cost is O(1) in scene size apart from those sums."""
    if recompute_rng:
        (g_r_ref, g_g_ref, g_b_ref, rec_ref, off_ref, rid_base_ref,
         table_ref, cam_ref, light_ref, dpart_ref, dscal_ref) = refs
        nee0_ref = nee1_ref = cos0_ref = cos1_ref = jx_ref = jy_ref = None
    else:
        (g_r_ref, g_g_ref, g_b_ref, rec_ref, nee0_ref, nee1_ref, cos0_ref,
         cos1_ref, jx_ref, jy_ref, rid_base_ref, table_ref, cam_ref,
         light_ref, dpart_ref, dscal_ref) = refs
        off_ref = None
    TILE = pp.TILE
    W = config.width
    H = config.height
    B = config.bounces
    P = num_prims
    nrows = NROWS_TAB_SPH if num_spheres else NROWS_TAB
    ntab = NTAB_SPH if num_spheres else NTAB
    he = _F32(config.area_light_half_extent)

    pid = pl.program_id(0)
    lane = jax.lax.broadcasted_iota(_I32, (TILE,), 0)
    # Global pixel id (rid_base = shard's first pixel under shard_map).
    rid = rid_base_ref[0, 0] + pid * TILE + lane
    if blocked:
        # Pixel-tile mapping — must mirror the trace kernel's
        # (pallas_path._path_kernel) so the replayed camera rays match the
        # recorded decisions bit-for-bit.
        nbx = W // pp.BLOCK_W
        blk = rid_base_ref[0, 0] // TILE + pid
        px = ((blk % nbx) * pp.BLOCK_W + lane % pp.BLOCK_W).astype(_F32)
        py = ((blk // nbx) * (TILE // pp.BLOCK_W)
              + lane // pp.BLOCK_W).astype(_F32)
    else:
        px = (rid % W).astype(_F32)
        py = (rid // W).astype(_F32)
    in_image = rid < n_pixels

    cam = [cam_ref[0, k] for k in range(12)]
    pos, hu, hv, wb = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    lc = [light_ref[0, k] for k in range(3)]
    lcol = [light_ref[0, 3 + k] for k in range(3)]
    ln = [light_ref[0, 6 + k] for k in range(3)]

    # Upstream hdr cotangent for this program (already scaled by 1/spp).
    g_r = g_r_ref[...]
    g_g = g_g_ref[...]
    g_b = g_b_ref[...]

    zero = px * 0.0
    route.zero_partials(dpart_ref, ntab, dpart_ref.shape[2])

    # The replay only consumes n, c0, diffuse, is_em (+ the sphere rows) —
    # the emissive values never appear in the reverse sweep (their
    # cotangent d_em is just a hit_light-masked g).
    fetch_rows = list(range(0, 7)) + list(range(10, nrows))

    off = off_ref[...] if recompute_rng else None

    def one_sample(n_i32, dscal):
        if recompute_rng:
            # Regenerate the trace kernel's draws (same f32 Halton digits).
            ih = off + n_i32.astype(_U32)
            jx, jy = camera_jitter(ih, config)
        else:
            js = pl.ds(n_i32 * TILE, TILE)
            jx = jx_ref[js]
            jy = jy_ref[js]

        # ---------------- forward recompute (saving residuals) -----------
        s = ((px + jx) / _F32(W)) * 2.0 - 1.0
        t = -(((py + jy) / _F32(H)) * 2.0 - 1.0)
        rx = s * hu[0] + t * hv[0] - wb[0]
        ry = s * hu[1] + t * hv[1] - wb[1]
        rz = s * hu[2] + t * hv[2] - wb[2]
        rn = jnp.sqrt(rx * rx + ry * ry + rz * rz)
        ox, oy, oz = zero + pos[0], zero + pos[1], zero + pos[2]
        dx, dy, dz = rx / rn, ry / rn, rz / rn

        col = [zero + 1.0, zero + 1.0, zero + 1.0]
        alive = in_image
        res = []
        for b in range(B):
            bs = pl.ds((n_i32 * B + b) * TILE, TILE)
            code = rec_ref[bs]
            occ = code >= OCC_BIT
            prim = code % OCC_BIT - 1
            hit = prim >= 0
            # Miss lanes gather primitive 0; every consumer is gated.
            pc = jnp.clip(prim, 0, P - 1)
            at = [table_ref[r, pc] for r in fetch_rows]
            # Table normal (zeros in sphere columns) vs the effective shading
            # normal nh (sphere columns override it below).
            tnx, tny, tnz, c0 = at[0], at[1], at[2], at[3]
            df = at[4:7]
            is_em = at[7] > 0.5

            den = dx * tnx + dy * tny + dz * tnz
            ok = jnp.abs(den) >= 1e-12
            sden = jnp.where(ok, den, 1.0)
            num = c0 - (ox * tnx + oy * tny + oz * tnz)
            tt = num / sden

            nhx, nhy, nhz = tnx, tny, tnz
            sph = None
            if num_spheres:
                # Analytic sphere replay (decoupled.shade_replay mirror;
                # same op order as intersect._sphere_candidates).
                scx, scy, scz, srad = at[8], at[9], at[10], at[11]
                is_sph = at[12] > 0.5
                ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
                a_q = dx * dx + dy * dy + dz * dz
                b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
                c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - srad * srad
                disc = b_q * b_q - 4.0 * a_q * c_q
                pos_d = disc > 0.0
                sq = jnp.sqrt(jnp.where(pos_d, disc, 1.0))
                t1 = (-b_q - sq) / (2.0 * a_q)
                t2 = (-b_q + sq) / (2.0 * a_q)
                t1_ok = (t1 > 1e-3) & (t1 < 1e3)
                t_sph = jnp.where(t1_ok, t1, t2)
                tt = jnp.where(is_sph, t_sph, tt)
                sel = hit & is_sph
                t_ns = jnp.where(sel, tt, 0.0)
                thx = ox + dx * t_ns - scx
                thy = oy + dy * t_ns - scy
                thz = oz + dz * t_ns - scz
                qn = thx * thx + thy * thy + thz * thz
                inv_n = jax.lax.rsqrt(jnp.maximum(qn, 1e-6))
                nhx = jnp.where(sel, thx * inv_n, nhx)
                nhy = jnp.where(sel, thy * inv_n, nhy)
                nhz = jnp.where(sel, thz * inv_n, nhz)
                sph = dict(
                    is_sph=is_sph, sel=sel, oc=(ocx, ocy, ocz), srad=srad,
                    a_q=a_q, b_q=b_q, c_q=c_q, pos_d=pos_d, sq=sq,
                    t1=t1, t2=t2, t1_ok=t1_ok, t_ns=t_ns,
                    th=(thx, thy, thz), qn_ok=qn >= 1e-6, inv_n=inv_n)

            active = alive & hit
            hit_light = active & is_em
            surf = active & ~is_em
            ts = jnp.where(surf, tt, 0.0)
            hx = ox + dx * ts + nhx * 1e-3
            hy = oy + dy * ts + nhy * 1e-3
            hz = oz + dz * ts + nhz * 1e-3

            if recompute_rng:
                w0 = _halton_tile(ih, 2 + b * 5 + 0) * 2.0 - 1.0
                w1 = _halton_tile(ih, 2 + b * 5 + 1) * 2.0 - 1.0
            else:
                w0 = nee0_ref[bs] * 2.0 - 1.0
                w1 = nee1_ref[bs] * 2.0 - 1.0
            tlx = (lc[0] + he * w0) - hx
            tly = lc[1] - hy
            tlz = (lc[2] + he * w1) - hz
            q = tlx * tlx + tly * tly + tlz * tlz
            dist = jnp.sqrt(jnp.maximum(q, 0.0))
            invd = 1.0 / jnp.maximum(dist, 1e-3)
            ldx, ldy, ldz = tlx * invd, tly * invd, tlz * invd
            cl_raw = -(ldx * ln[0] + ldy * ln[1] + ldz * ln[2])
            cs_raw = nhx * ldx + nhy * ldy + nhz * ldz
            cos_l = jnp.clip(cl_raw, 0.0, 1.0)
            cos_s = jnp.clip(cs_raw, 0.0, 1.0)
            invd2 = invd * invd
            gain = (invd2 * cos_l) * cos_s
            contrib = surf & ~occ

            colp = col
            col = [jnp.where(surf, colp[c] * df[c], colp[c]) for c in range(3)]

            # Cosine bounce direction.
            if recompute_rng:
                u0 = _halton_tile(ih, 2 + b * 5 + 2)
                u1 = _halton_tile(ih, 2 + b * 5 + 3)
            else:
                u0 = cos0_ref[bs]
                u1 = cos1_ref[bs]
            phi = _F32(2.0 * math.pi) * u0
            cth = jnp.sqrt(u1)
            sth = jnp.sqrt(1.0 - cth * cth)
            sxl = sth * jnp.cos(phi)
            syl = cth
            szl = sth * jnp.sin(phi)
            ax, ay, az = _F32(0.0072), _F32(1.0), _F32(0.0034)
            crx = nhy * az - nhz * ay
            cry = nhz * ax - nhx * az
            crz = nhx * ay - nhy * ax
            crn = jnp.sqrt(crx * crx + cry * cry + crz * crz)
            crxn, cryn, crzn = crx / crn, cry / crn, crz / crn

            res.append(dict(
                pc=pc, hit=hit, tn=(tnx, tny, tnz),
                nh=(nhx, nhy, nhz), df=df,
                ok=ok, sden=sden, tt=tt, ts=ts,
                o=(ox, oy, oz), d=(dx, dy, dz),
                surf=surf, hit_light=hit_light, contrib=contrib,
                tlx=tlx, tly=tly, tlz=tlz, dist=dist, invd=invd,
                cl_raw=cl_raw, cs_raw=cs_raw, cos_l=cos_l, cos_s=cos_s,
                gain=gain, colp=colp, col=col,
                sxl=sxl, syl=syl, szl=szl,
                crn=crn, crxn=crxn, cryn=cryn, crzn=crzn,
                sph=sph,
            ))
            if b < B - 1:
                fwx = cryn * nhz - crzn * nhy
                fwy = crzn * nhx - crxn * nhz
                fwz = crxn * nhy - cryn * nhx
                sdx = sxl * crxn + syl * nhx + szl * fwx
                sdy = sxl * cryn + syl * nhy + szl * fwy
                sdz = sxl * crzn + syl * nhz + szl * fwz
                ox = jnp.where(surf, hx, ox)
                oy = jnp.where(surf, hy, oy)
                oz = jnp.where(surf, hz, oz)
                dx = jnp.where(surf, sdx, dx)
                dy = jnp.where(surf, sdy, dy)
                dz = jnp.where(surf, sdz, dz)
            alive = surf

        # ---------------- reverse sweep ----------------------------------
        (d_pos, d_hu, d_hv, d_wb, d_lc, d_lcol, d_ln) = (
            list(dscal[0:3]), list(dscal[3:6]), list(dscal[6:9]),
            list(dscal[9:12]), list(dscal[12:15]), list(dscal[15:18]),
            list(dscal[18:21]))

        d_a = [g_r, g_g, g_b]
        d_o = [zero, zero, zero]
        d_d = [zero, zero, zero]
        d_col = [zero, zero, zero]

        for b in reversed(range(B)):
            r = res[b]
            nhx, nhy, nhz = r["nh"]
            tnx, tny, tnz = r["tn"]
            surf = r["surf"]
            d_nh = [zero, zero, zero]  # effective-normal cotangent

            # (D) o/d updates + (9) cosine-direction chain (absent for the
            # last bounce: its o/d die unused).
            if b < B - 1:
                d_h = [jnp.where(surf, d_o[c], 0.0) for c in range(3)]
                d_o = [jnp.where(surf, 0.0, d_o[c]) for c in range(3)]
                d_sd = [jnp.where(surf, d_d[c], 0.0) for c in range(3)]
                d_d = [jnp.where(surf, 0.0, d_d[c]) for c in range(3)]

                sxl, syl, szl = r["sxl"], r["syl"], r["szl"]
                crxn, cryn, crzn, crn = (r["crxn"], r["cryn"], r["crzn"],
                                         r["crn"])
                d_crxn = sxl * d_sd[0]
                d_cryn = sxl * d_sd[1]
                d_crzn = sxl * d_sd[2]
                d_nh[0] += syl * d_sd[0]
                d_nh[1] += syl * d_sd[1]
                d_nh[2] += syl * d_sd[2]
                d_fw = [szl * d_sd[0], szl * d_sd[1], szl * d_sd[2]]
                # fw = cr_n x nh
                d_cryn += nhz * d_fw[0]
                d_nh[2] += cryn * d_fw[0]
                d_crzn -= nhy * d_fw[0]
                d_nh[1] -= crzn * d_fw[0]
                d_crzn += nhx * d_fw[1]
                d_nh[0] += crzn * d_fw[1]
                d_crxn -= nhz * d_fw[1]
                d_nh[2] -= crxn * d_fw[1]
                d_crxn += nhy * d_fw[2]
                d_nh[1] += crxn * d_fw[2]
                d_cryn -= nhx * d_fw[2]
                d_nh[0] -= cryn * d_fw[2]
                # normalize reverse
                s_dot = crxn * d_crxn + cryn * d_cryn + crzn * d_crzn
                d_crx = (d_crxn - crxn * s_dot) / crn
                d_cry = (d_cryn - cryn * s_dot) / crn
                d_crz = (d_crzn - crzn * s_dot) / crn
                # cr = nh x axis (axis = (0.0072, 1, 0.0034))
                ax, ay, az = _F32(0.0072), _F32(1.0), _F32(0.0034)
                d_nh[1] += az * d_crx
                d_nh[2] -= ay * d_crx
                d_nh[2] += ax * d_cry
                d_nh[0] -= az * d_cry
                d_nh[0] += ay * d_crz
                d_nh[1] -= ax * d_crz
            else:
                d_h = [zero, zero, zero]

            # (C) reverse: a += where(contrib, (lcol*gain)*col)
            contrib = r["contrib"]
            gain = r["gain"]
            col = r["col"]
            d_gain = zero
            for c in range(3):
                gated = jnp.where(contrib, d_a[c], 0.0)
                d_lcol[c] += gain * col[c] * gated
                d_gain += lcol[c] * col[c] * gated
                d_col[c] += lcol[c] * gain * gated

            # (B) reverse: col = where(surf, colp*df, colp)
            colp, df = r["colp"], r["df"]
            d_df = [jnp.where(surf, d_col[c] * colp[c], 0.0) for c in range(3)]
            d_col = [jnp.where(surf, d_col[c] * df[c], d_col[c])
                     for c in range(3)]

            # (6) NEE reverse
            invd, dist = r["invd"], r["dist"]
            cos_l, cos_s = r["cos_l"], r["cos_s"]
            cl_raw, cs_raw = r["cl_raw"], r["cs_raw"]
            tlx, tly, tlz = r["tlx"], r["tly"], r["tlz"]
            invd2 = invd * invd
            d_invd2 = cos_l * cos_s * d_gain
            d_cos_l = invd2 * cos_s * d_gain
            d_cos_s = invd2 * cos_l * d_gain
            d_cs_raw = jnp.where((cs_raw >= 0.0) & (cs_raw <= 1.0),
                                 d_cos_s, 0.0)
            d_cl_raw = jnp.where((cl_raw >= 0.0) & (cl_raw <= 1.0),
                                 d_cos_l, 0.0)
            ldx, ldy, ldz = tlx * invd, tly * invd, tlz * invd
            # cs_raw = nh . ld ; cl_raw = -(ld . ln)
            d_nh[0] += ldx * d_cs_raw
            d_nh[1] += ldy * d_cs_raw
            d_nh[2] += ldz * d_cs_raw
            d_ld = [nhx * d_cs_raw - ln[0] * d_cl_raw,
                    nhy * d_cs_raw - ln[1] * d_cl_raw,
                    nhz * d_cs_raw - ln[2] * d_cl_raw]
            d_ln[0] -= ldx * d_cl_raw
            d_ln[1] -= ldy * d_cl_raw
            d_ln[2] -= ldz * d_cl_raw
            d_invd = 2.0 * invd * d_invd2
            d_invd += tlx * d_ld[0] + tly * d_ld[1] + tlz * d_ld[2]
            d_tl = [invd * d_ld[0], invd * d_ld[1], invd * d_ld[2]]
            d_maxd = -(invd * invd) * d_invd
            d_dist = jnp.where(dist >= 1e-3, d_maxd, 0.0)
            d_q = d_dist / (2.0 * dist)
            d_tl[0] += 2.0 * tlx * d_q
            d_tl[1] += 2.0 * tly * d_q
            d_tl[2] += 2.0 * tlz * d_q
            d_lc[0] += d_tl[0]
            d_lc[1] += d_tl[1]
            d_lc[2] += d_tl[2]
            d_h[0] -= d_tl[0]
            d_h[1] -= d_tl[1]
            d_h[2] -= d_tl[2]

            # (5) h reverse: h = o + d*ts + nh*1e-3
            ox, oy, oz = r["o"]
            dx, dy, dz = r["d"]
            ts = r["ts"]
            d_o[0] += d_h[0]
            d_o[1] += d_h[1]
            d_o[2] += d_h[2]
            d_d[0] += ts * d_h[0]
            d_d[1] += ts * d_h[1]
            d_d[2] += ts * d_h[2]
            d_ts = dx * d_h[0] + dy * d_h[1] + dz * d_h[2]
            d_nh[0] += _F32(1e-3) * d_h[0]
            d_nh[1] += _F32(1e-3) * d_h[1]
            d_nh[2] += _F32(1e-3) * d_h[2]

            # (A) reverse: a = where(hit_light, em, a)
            hit_light = r["hit_light"]
            d_em = [jnp.where(hit_light, d_a[c], 0.0) for c in range(3)]
            d_a = [jnp.where(hit_light, 0.0, d_a[c]) for c in range(3)]

            # (4s) effective-normal select + sphere-normal chain:
            # nh = where(sel, th * inv_n, tn).
            d_tt_extra = zero
            if num_spheres:
                s_r = r["sph"]
                sel = s_r["sel"]
                thx, thy, thz = s_r["th"]
                inv_n = s_r["inv_n"]
                d_nh_s = [jnp.where(sel, d_nh[c], 0.0) for c in range(3)]
                d_tn = [jnp.where(sel, 0.0, d_nh[c]) for c in range(3)]
                d_th = [inv_n * d_nh_s[c] for c in range(3)]
                d_inv_n = (thx * d_nh_s[0] + thy * d_nh_s[1]
                           + thz * d_nh_s[2])
                # inv_n = rsqrt(max(qn, 1e-6))
                d_qn = jnp.where(s_r["qn_ok"],
                                 -0.5 * inv_n * inv_n * inv_n * d_inv_n, 0.0)
                d_th[0] += 2.0 * thx * d_qn
                d_th[1] += 2.0 * thy * d_qn
                d_th[2] += 2.0 * thz * d_qn
                # th = o + d * t_ns - sc
                t_ns = s_r["t_ns"]
                d_o[0] += d_th[0]
                d_o[1] += d_th[1]
                d_o[2] += d_th[2]
                d_d[0] += t_ns * d_th[0]
                d_d[1] += t_ns * d_th[1]
                d_d[2] += t_ns * d_th[2]
                d_sc = [-d_th[c] for c in range(3)]
                d_srad = zero
                # t_ns = where(sel, tt, 0)
                d_tt_extra = jnp.where(
                    sel, dx * d_th[0] + dy * d_th[1] + dz * d_th[2], 0.0)
            else:
                d_tn = d_nh

            # (2) reverse: tt select + plane / sphere-quadratic chains.
            tt, sden, ok = r["tt"], r["sden"], r["ok"]
            d_tt = jnp.where(surf, d_ts, 0.0) + d_tt_extra
            if num_spheres:
                s_r = r["sph"]
                is_sph = s_r["is_sph"]
                d_tsph = jnp.where(is_sph, d_tt, 0.0)
                d_tt = jnp.where(is_sph, 0.0, d_tt)
                # t_sph = where(t1_ok, t1, t2); t1/t2 = (-b -+ sq)/(2a)
                t1_ok = s_r["t1_ok"]
                a_q, b_q, c_q = s_r["a_q"], s_r["b_q"], s_r["c_q"]
                d_t1 = jnp.where(t1_ok, d_tsph, 0.0)
                d_t2 = jnp.where(t1_ok, 0.0, d_tsph)
                inv2a = 1.0 / (2.0 * a_q)
                d_b_q = -(d_t1 + d_t2) * inv2a
                d_sq = (d_t2 - d_t1) * inv2a
                d_a_q = -(s_r["t1"] * d_t1 + s_r["t2"] * d_t2) / a_q
                # sq = sqrt(where(pos_d, disc, 1)); disc = b^2 - 4ac
                d_disc = jnp.where(s_r["pos_d"],
                                   d_sq / (2.0 * s_r["sq"]), 0.0)
                d_b_q += 2.0 * b_q * d_disc
                d_a_q += -4.0 * c_q * d_disc
                d_c_q = -4.0 * a_q * d_disc
                # c_q = oc.oc - r^2 ; b_q = 2 oc.d ; a_q = d.d
                ocx, ocy, ocz = s_r["oc"]
                d_oc = [2.0 * ocx * d_c_q + 2.0 * dx * d_b_q,
                        2.0 * ocy * d_c_q + 2.0 * dy * d_b_q,
                        2.0 * ocz * d_c_q + 2.0 * dz * d_b_q]
                d_srad += -2.0 * s_r["srad"] * d_c_q
                d_d[0] += 2.0 * ocx * d_b_q + 2.0 * dx * d_a_q
                d_d[1] += 2.0 * ocy * d_b_q + 2.0 * dy * d_a_q
                d_d[2] += 2.0 * ocz * d_b_q + 2.0 * dz * d_a_q
                # oc = o - sc
                d_o[0] += d_oc[0]
                d_o[1] += d_oc[1]
                d_o[2] += d_oc[2]
                d_sc[0] -= d_oc[0]
                d_sc[1] -= d_oc[1]
                d_sc[2] -= d_oc[2]
            # Plane chain: tt = (c0 - o.tn) / sden.
            d_num = d_tt / sden
            d_sden = -(tt * d_tt) / sden
            d_den = jnp.where(ok, d_sden, 0.0)
            d_c0 = d_num
            d_o[0] -= tnx * d_num
            d_o[1] -= tny * d_num
            d_o[2] -= tnz * d_num
            d_tn[0] -= ox * d_num
            d_tn[1] -= oy * d_num
            d_tn[2] -= oz * d_num
            d_d[0] += tnx * d_den
            d_d[1] += tny * d_den
            d_d[2] += tnz * d_den
            d_tn[0] += dx * d_den
            d_tn[1] += dy * d_den
            d_tn[2] += dz * d_den

            # (1) per-primitive cotangents into this program's partials.
            rows = [d_tn[0], d_tn[1], d_tn[2], d_c0,
                    d_df[0], d_df[1], d_df[2],
                    d_em[0], d_em[1], d_em[2]]
            if num_spheres:
                rows += [d_sc[0], d_sc[1], d_sc[2], d_srad]
            route.accumulate_rows(dpart_ref, r["pc"], r["hit"], rows, P)

        # Camera reverse (bounce-0 entry o/d are the camera ray).
        d_pos[0] += d_o[0]
        d_pos[1] += d_o[1]
        d_pos[2] += d_o[2]
        dx0, dy0, dz0 = res[0]["d"]
        s_dot = dx0 * d_d[0] + dy0 * d_d[1] + dz0 * d_d[2]
        d_r = [(d_d[0] - dx0 * s_dot) / rn,
               (d_d[1] - dy0 * s_dot) / rn,
               (d_d[2] - dz0 * s_dot) / rn]
        for c in range(3):
            d_hu[c] += s * d_r[c]
            d_hv[c] += t * d_r[c]
            d_wb[c] -= d_r[c]

        return tuple(d_pos + d_hu + d_hv + d_wb + d_lc + d_lcol + d_ln)

    dscal = jax.lax.fori_loop(0, config.spp, one_sample,
                              tuple(zero for _ in range(NSCAL)))
    for k, p in enumerate(dscal):
        dscal_ref[0, k] = jnp.sum(p)


def _bwd_pallas(config: RenderConfig, n_pixels: int, num_prims: int,
                num_spheres: int, g_planes, aux_planes, table, cam_vec,
                light_vec, interpret: bool, rid_base, n_local: int,
                offsets=None, blocked: bool = False):
    """Run the backward kernel; returns (d_table [ntab, P], d_scal
    [NSCAL]) summed over programs."""
    TILE = pp.TILE
    n_padded = pp.padded_len(n_local)
    n_tiles = n_padded // TILE
    recompute_rng = offsets is not None
    nsb = config.spp * config.bounces
    ntab = NTAB_SPH if num_spheres else NTAB
    p_pad = route.padded_prims(num_prims)
    table = jnp.pad(table, ((0, route.next_pow2(table.shape[0])
                             - table.shape[0]),
                            (0, p_pad - table.shape[1])))

    ray_spec = pl.BlockSpec((TILE,), lambda i: (i,))
    sb_spec = pl.BlockSpec((nsb * TILE,), lambda i: (i,))
    s_spec = pl.BlockSpec((config.spp * TILE,), lambda i: (i,))
    if recompute_rng:
        aux_specs = [sb_spec, ray_spec]           # records + RNG offsets
        aux_inputs = (*aux_planes, offsets)
    else:
        aux_specs = [sb_spec] * 5 + [s_spec] * 2  # records + uv + jitter
        aux_inputs = aux_planes
    kernel = partial(_shade_bwd_kernel, config, n_pixels, num_prims,
                     num_spheres, recompute_rng, blocked)
    dpart, dscal = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[ray_spec, ray_spec, ray_spec, *aux_specs]
        + [pl.no_block_spec] * 4,
        out_specs=(pl.BlockSpec((1, ntab, p_pad), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, NSCAL_PAD), lambda i: (i, 0))),
        out_shape=(jax.ShapeDtypeStruct((n_tiles, ntab, p_pad), _F32),
                   jax.ShapeDtypeStruct((n_tiles, NSCAL_PAD), _F32)),
        backend="triton",
        compiler_params=route.compiler_params(),
        interpret=interpret,
        name="path_backward",
    )(*g_planes, *aux_inputs, rid_base, table, route.pad_pow2(cam_vec),
      route.pad_pow2(light_vec))
    return (jnp.sum(dpart, axis=0)[:, :num_prims],
            jnp.sum(dscal, axis=0)[:NSCAL])


# ---------------------------------------------------------------------------
# custom_vjp wrapper: forward = the trace kernel's own hdr (identity);
# backward = the kernel above.
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _attach_grad(config: RenderConfig, interpret, blocked, hdr, table,
                 cam_vec, light_vec, aux_planes, rid_base, offsets):
    return hdr


def _attach_fwd(config, interpret, blocked, hdr, table, cam_vec, light_vec,
                aux_planes, rid_base, offsets):
    return hdr, (table, cam_vec, light_vec, aux_planes, rid_base, offsets)


def _attach_bwd(config, interpret, blocked, resids, g):
    table, cam_vec, light_vec, aux_planes, rid_base, offsets = resids
    n_local = g.shape[0] * (g.shape[1] if g.ndim == 3 else 1)
    n_padded = pp.padded_len(n_local)
    num_prims = table.shape[1]
    has_spheres = table.shape[0] == NROWS_TAB_SPH

    # hdr cotangent ([H, W, 3] or flat [local, 3]) -> padded planes,
    # pre-scaled by 1/spp (hdr = sum_samples acc / spp). Blocked mode
    # permutes the cotangent into the pixel-tile order the record planes
    # were written in.
    gs = (g * _F32(1.0 / config.spp)).reshape(-1, 3)
    if blocked:
        gs = pp.to_blocked(gs, config)
    gs = jnp.pad(gs, ((0, n_padded - n_local), (0, 0)))
    g_planes = tuple(gs[:, c] for c in range(3))

    if offsets is not None and len(aux_planes) == 1:
        off_plane = jnp.pad(offsets, (0, n_padded - n_local))
    else:
        off_plane = None
    dtab, dscal = _bwd_pallas(config, config.num_pixels, num_prims,
                              1 if has_spheres else 0, g_planes,
                              aux_planes, table, cam_vec, light_vec,
                              interpret, rid_base, n_local,
                              offsets=off_plane, blocked=blocked)
    zrow = jnp.zeros((1, num_prims), _F32)
    if has_spheres:
        # [n(3), c0, df(3), em(3)] + is_em(0) + [center(3), radius] + is_sph(0)
        d_table = jnp.concatenate(
            [dtab[:NTAB], zrow, dtab[NTAB:NTAB_SPH], zrow], axis=0)
    else:
        d_table = jnp.concatenate([dtab, zrow], axis=0)  # +is_em row
    d_cam = dscal[0:12].reshape(1, 12)
    d_light = dscal[12:21].reshape(1, 9)

    # Aux planes are non-differentiable (int records / stop-gradient'd RNG
    # draws): int inputs take float0 cotangents, float inputs zero arrays
    # (DCE'd — they feed a stop_gradient upstream).
    d_aux = jax.tree.map(
        lambda x: (np.zeros(x.shape, jax.dtypes.float0)
                   if jnp.issubdtype(x.dtype, jnp.integer)
                   else jnp.zeros_like(x)),
        aux_planes)
    d_rid = np.zeros(rid_base.shape, jax.dtypes.float0)
    d_off = (None if offsets is None
             else np.zeros(offsets.shape, jax.dtypes.float0))
    return g, d_table, d_cam, d_light, d_aux, d_rid, d_off


_attach_grad.defvjp(_attach_fwd, _attach_bwd)


def _pack_diff_inputs(scene: Scene, config: RenderConfig):
    """Differentiable jnp packing of the kernel's parameter views — grads
    chain from the kernel's cotangents back to the scene pytree (verts via
    compile_scene, camera via camera_basis, sphere center/radius directly,
    light fields directly). Column order matches the trace kernel's record
    encoding: triangles first, then spheres."""
    compiled = compile_scene(scene.triangles, lane_pad=1)
    tri_rows = [
        compiled.n[:, 0], compiled.n[:, 1], compiled.n[:, 2], compiled.c0,
        compiled.diffuse[:, 0], compiled.diffuse[:, 1], compiled.diffuse[:, 2],
        compiled.emissive[:, 0], compiled.emissive[:, 1],
        compiled.emissive[:, 2],
        compiled.is_emissive.astype(_F32),
    ]
    sp = scene.spheres
    if sp.num_spheres:
        n_t = scene.triangles.num_triangles
        zt = jnp.zeros((n_t,), _F32)
        zs = jnp.zeros((sp.num_spheres,), _F32)
        sph_rows = [
            zs, zs, zs, zs,                                     # n, c0
            sp.diffuse[:, 0], sp.diffuse[:, 1], sp.diffuse[:, 2],
            sp.emissive[:, 0], sp.emissive[:, 1], sp.emissive[:, 2],
            (jnp.linalg.norm(sp.emissive, axis=-1) > 0.0).astype(_F32),
        ]
        rows = [jnp.concatenate([t, s]) for t, s in zip(tri_rows, sph_rows)]
        rows += [
            jnp.concatenate([zt, sp.center[:, 0]]),
            jnp.concatenate([zt, sp.center[:, 1]]),
            jnp.concatenate([zt, sp.center[:, 2]]),
            jnp.concatenate([zt, sp.radius]),
            jnp.concatenate([zt, jnp.ones((sp.num_spheres,), _F32)]),
        ]
        table = jnp.stack(rows)  # [NROWS_TAB_SPH, T + S]
    else:
        table = jnp.stack(tri_rows)  # [NROWS_TAB, T]

    light = scene.light
    light_vec = jnp.concatenate([
        jnp.asarray(light.center, _F32).reshape(-1),
        jnp.asarray(light.color, _F32).reshape(-1),
        jnp.asarray(light.normal, _F32).reshape(-1),
    ]).reshape(1, 9)
    return table, camera_vec(scene, config), light_vec


def _auto_records_only(config: RenderConfig, n_pixels=None) -> bool:
    """records_only when the six f32 draw planes would take more than a
    quarter of the device's memory (BASELINE config 5, 1024^2 x 256 spp,
    needs ~18 GB of them); regenerating the draws in the backward kernel
    costs a few Halton evaluations per (sample, bounce) instead.
    ``n_pixels`` is the pixel count this device actually renders (the
    shard-local count under shard_map)."""
    if n_pixels is None:
        n_pixels = config.num_pixels
    nsb = n_pixels * config.spp * config.bounces
    draw_bytes = nsb * 4 * 4 + n_pixels * config.spp * 2 * 4
    return draw_bytes > route.device_memory_bytes() // 4


def render_path_decoupled_fused(scene: Scene, config: RenderConfig,
                                interpret=None, records_only=None,
                                draws=None, occluders=None) -> jnp.ndarray:
    """Variant-B differentiable render at megakernel forward speed: the
    trace kernel's hdr with the hand-written backward attached. Handles
    triangle and sphere scenes (the backward replays the analytic sphere
    quadratic — interior gradients identical to oracle AD).

    ``draws``: optional ``pallas_path.pregen_draws(config)`` result. The
    draws are step-invariant; pass them from OUTSIDE a training/bench loop
    to hoist their generation out of every step.

    ``occluders``: optional ``intersect.potential_occluders(scene, config)``
    tuple — statically culls provably-non-occluding triangles from the
    shadow loops (~1/3 of the Cornell shadow work; decisions unchanged).
    Compute it on the concrete scene and rebuild it if geometry moves."""
    interpret = route.interpret_mode(interpret)
    if records_only is None:
        records_only = _auto_records_only(config)
    blocked = pp.use_blocked_tiles(config, False)
    hdr, aux = _render_pallas_impl(jax.lax.stop_gradient(scene), config,
                                   interpret=interpret, emit_records=True,
                                   raw_records=True,
                                   records_only=records_only, draws=draws,
                                   occluders=occluders)
    table, cam_vec, light_vec = _pack_diff_inputs(scene, config)
    offsets = pixel_rng_offsets(config) if records_only else None
    if blocked and offsets is not None:
        offsets = pp.to_blocked(offsets, config)
    return _attach_grad(config, interpret, blocked, hdr, table, cam_vec,
                        light_vec, tuple(aux), jnp.zeros((1, 1), jnp.int32),
                        offsets)


def render_path_fused_local(scene: Scene, config: RenderConfig,
                            local_offsets, rid_base, interpret=None,
                            records_only=None, draws=None, occluders=None):
    """Shard-local fused render for use inside ``shard_map`` (see
    parallel/fast.py): renders the pixels [rid_base, rid_base + len(offsets))
    and returns flat [local, 3] hdr with the hand-written backward attached.
    Cotangents for the replicated scene parameters are per-shard partials —
    shard_map's transpose inserts the psum."""
    interpret = route.interpret_mode(interpret)
    if records_only is None:
        records_only = _auto_records_only(config, local_offsets.shape[0])
    hdr, aux = _render_pallas_impl(jax.lax.stop_gradient(scene), config,
                                   interpret=interpret, emit_records=True,
                                   raw_records=True,
                                   records_only=records_only,
                                   local_offsets=local_offsets,
                                   rid_base=rid_base, flat_output=True,
                                   draws=draws, occluders=occluders)
    table, cam_vec, light_vec = _pack_diff_inputs(scene, config)
    offsets = local_offsets if records_only else None
    # Sharded path: linear pixel mapping (shards slice the linear pixel
    # range).
    return _attach_grad(config, interpret, False, hdr, table, cam_vec,
                        light_vec, tuple(aux), rid_base, offsets)

"""Decoupled shading: fast differentiable fwd+bwd rendering.

The monolithic megakernel (pallas_path.py) is the fastest *forward*, but
Pallas kernels are not differentiable by jax AD. Instead of hand-deriving a
backward kernel, the renderer is split at the discrete/continuous boundary:

  1. **Trace (Pallas kernel, non-differentiable by construction):** the kernel
     replays the full path trace and emits, per (sample, bounce, pixel), one
     int32 *visibility record* (winning primitive id + shadow-occlusion bit)
     plus the raw random draws (NEE / cosine / jitter uv). The records are
     exactly the discrete decisions AD treats as constants anyway (argmin
     winners and boolean visibility are piecewise constant); the uv planes
     save the replay from recomputing Halton digits — the dominant cost of a
     jnp replay (u32 div/mod chains on [rays]-sized arrays).

  2. **Shade (jnp, differentiable):** radiance is recomputed from the
     records: hit distance from the recorded primitive's plane equation
     (differentiable w.r.t. geometry), NEE falloff/cos from the recomputed
     hit position, per-primitive attributes by small-table gathers — the
     same math as the jnp oracle minus all [rays, triangles] intersection
     work and all RNG.

Layout: all shading math runs on [chunk, N] f32 planes (never [..., 3]
vectors or packed [..., attrs] rows), and per-primitive attributes are
fetched by a one-hot contraction attrs[A, rays] = table[A, P] @
onehot[P, rays] whose transpose is the table's cotangent scatter-add.

Gradients from AD over the shade pass are IDENTICAL to jax.grad of the jnp
reference renderer (asserted in tests), because the reference's gradient also
treats visibility as piecewise constant: every arithmetic expression below
mirrors the oracle's op-for-op (same associativity, same normalize-by-divide
vs rsqrt choices), so values and cotangents match to fp32 rounding. The
sample axis is processed in vectorized chunks (scan over chunks, samples
dense inside) with rematerialization — bounded live memory at high spp.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..intersect import compile_scene
from ..render import pixel_coords
from ..types import RenderConfig, Scene
from .pallas_path import OCC_BIT, TraceAux, _render_pallas_impl

_F32 = jnp.float32


def trace_records(scene: Scene, config: RenderConfig, interpret=None):
    """Run the megakernel emitting visibility records + random draws.
    Returns (hdr [H, W, 3], TraceAux). Non-differentiable — callers
    stop_gradient the scene."""
    return _render_pallas_impl(jax.lax.stop_gradient(scene), config,
                               interpret=interpret, emit_records=True)


def _sample_chunk(config: RenderConfig):
    """Largest divisor of spp not exceeding the configured chunk."""
    c = min(config.replay_sample_chunk, config.spp)
    while config.spp % c:
        c -= 1
    return c


def shade_replay(scene: Scene, aux: TraceAux,
                 config: RenderConfig) -> jnp.ndarray:
    """Differentiable radiance from trace records. Mirrors
    render._path_trace_chunk with closest-hit/any-hit replaced by record
    decode + per-primitive takes, and all RNG replaced by the recorded
    draws. All arrays are [C, N] planes (C = sample chunk)."""
    compiled = compile_scene(scene.triangles, lane_pad=1)
    light = scene.light
    cam = scene.camera
    px_i, py_i = pixel_coords(config)
    px = px_i.astype(_F32)
    py = py_i.astype(_F32)

    # Per-primitive attribute table [NATTR, P] (triangles then spheres),
    # fetched per ray as a one-hot matmul with P on the CONTRACTED/MAJOR
    # axis: attrs = table[A, P] @ onehot[P, rays] -> [A, rays], so neither
    # the one-hot nor the result ever puts a tiny dim minor-most (see module
    # docstring). Exact for f32: one-hot rows reconstruct table entries
    # bit-for-bit under HIGHEST precision, and the backward is the transpose
    # matmul (dense scatter-add into the table -> param grads).
    P_tri = compiled.padded_size
    sp = scene.spheres
    num_sph = sp.num_spheres
    P = P_tri + num_sph
    zs = jnp.zeros((num_sph,), _F32)
    zt = jnp.zeros((P_tri,), _F32)

    def cat(tri_col, sph_col):
        return jnp.concatenate([tri_col, sph_col], axis=0) if num_sph \
            else tri_col

    sph_is_em = (jnp.linalg.norm(sp.emissive, axis=-1) > 0.0).astype(_F32) \
        if num_sph else zs
    rows = [
        cat(compiled.n[:, 0], zs),                                    # 0 nx
        cat(compiled.n[:, 1], zs),                                    # 1 ny
        cat(compiled.n[:, 2], zs),                                    # 2 nz
        cat(compiled.c0, zs),                                         # 3 c0
        cat(compiled.diffuse[:, 0], sp.diffuse[:, 0] if num_sph else zs),
        cat(compiled.diffuse[:, 1], sp.diffuse[:, 1] if num_sph else zs),
        cat(compiled.diffuse[:, 2], sp.diffuse[:, 2] if num_sph else zs),
        cat(compiled.emissive[:, 0], sp.emissive[:, 0] if num_sph else zs),
        cat(compiled.emissive[:, 1], sp.emissive[:, 1] if num_sph else zs),
        cat(compiled.emissive[:, 2], sp.emissive[:, 2] if num_sph else zs),
        cat(compiled.is_emissive.astype(_F32), sph_is_em),            # 10
    ]
    if num_sph:
        rows += [
            cat(zt, sp.center[:, 0]),                                 # 11
            cat(zt, sp.center[:, 1]),                                 # 12
            cat(zt, sp.center[:, 2]),                                 # 13
            cat(zt, sp.radius),                                       # 14
            cat(zt, jnp.ones((num_sph,), _F32)),                      # 15
        ]
    table = jnp.stack(rows, axis=0)  # [NATTR, P]
    p_iota = jnp.arange(P, dtype=jnp.int32)

    def fetch_attrs(pc):
        """pc [C, N] int32 -> list of [C, N] attribute planes."""
        c_, n_ = pc.shape
        onehot = (p_iota[:, None] == pc.reshape(1, -1)).astype(_F32)
        at = jax.lax.dot_general(
            table, onehot, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)  # [NATTR, C*N]
        return [at[k].reshape(c_, n_) for k in range(table.shape[0])]

    # Camera constants (generate_camera_ray, sampling.py:213-236 — identical
    # expression tree, planar).
    res_x, res_y = config.resolution
    aspect = float(res_x // res_y) if config.integer_aspect else res_x / res_y
    half_width = jnp.tan(jnp.asarray(cam.horizontal_fov, _F32) / 2.0)
    half_height = half_width / aspect
    from .. import sampling as smp
    ub, vb, wb = smp.camera_basis(jnp.asarray(cam.direction, _F32),
                                  jnp.asarray(cam.up, _F32))
    hu = half_width * ub   # [3]
    hv = half_height * vb  # [3]
    lcx, lcy, lcz = light.center[0], light.center[1], light.center[2]
    lnx, lny, lnz = light.normal[0], light.normal[1], light.normal[2]
    lr, lg, lb = light.color[0], light.color[1], light.color[2]
    he = _F32(config.area_light_half_extent)

    chunk = _sample_chunk(config)
    n_chunks = config.spp // chunk

    def rs(x):  # [spp, ...] -> [n_chunks, chunk, ...]
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    def one_chunk(lum, xs):
        lum_r, lum_g, lum_b = lum
        code_b, nee0, nee1, cos0, cos1, jx, jy = xs  # [C, bounces?, N]

        # Camera ray (planar mirror of smp.generate_camera_ray).
        s = ((px[None, :] + jx) / _F32(res_x)) * 2.0 - 1.0
        t = -(((py[None, :] + jy) / _F32(res_y)) * 2.0 - 1.0)
        rx = s * hu[0] + t * hv[0] - wb[0]
        ry = s * hu[1] + t * hv[1] - wb[1]
        rz = s * hu[2] + t * hv[2] - wb[2]
        rn = jnp.sqrt(rx * rx + ry * ry + rz * rz)
        dx, dy, dz = rx / rn, ry / rn, rz / rn
        ox = jnp.zeros_like(dx) + cam.position[0]
        oy = jnp.zeros_like(dx) + cam.position[1]
        oz = jnp.zeros_like(dx) + cam.position[2]

        one = jnp.ones_like(dx)
        col_r, col_g, col_b = one, one, one
        a_r = jnp.zeros_like(dx)
        a_g, a_b = a_r, a_r
        alive = jnp.ones(dx.shape, bool)

        for bounce in range(config.bounces):
            code = code_b[:, bounce]
            occ = code >= OCC_BIT
            prim = code % OCC_BIT - 1
            hit = prim >= 0
            pc = jnp.clip(prim, 0, P - 1)

            at = fetch_attrs(pc)
            nhx, nhy, nhz, c0 = at[0], at[1], at[2], at[3]
            dfr, dfg, dfb = at[4], at[5], at[6]
            emr, emg, emb = at[7], at[8], at[9]
            is_em = at[10] > 0.5

            # Hit distance from the recorded primitive's plane equation —
            # differentiable w.r.t. the triangle's vertices.
            den = dx * nhx + dy * nhy + dz * nhz
            tt = (c0 - (ox * nhx + oy * nhy + oz * nhz)) / jnp.where(
                jnp.abs(den) < 1e-12, 1.0, den)

            if num_sph:
                scx, scy, scz = at[11], at[12], at[13]
                srad = at[14]
                is_sph = at[15] > 0.5
                # Sphere hit distance from the recorded sphere's quadratic
                # (same op order as intersect._sphere_candidates) —
                # differentiable w.r.t. center/radius.
                ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
                a_q = dx * dx + dy * dy + dz * dz
                b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
                c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - srad * srad
                disc = b_q * b_q - 4.0 * a_q * c_q
                sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
                t1 = (-b_q - sq) / (2.0 * a_q)
                t2 = (-b_q + sq) / (2.0 * a_q)
                t1_ok = (t1 > 1e-3) & (t1 < 1e3)
                t_sph = jnp.where(t1_ok, t1, t2)
                tt = jnp.where(is_sph, t_sph, tt)
                # Sphere normal from the recomputed hit point
                # (intersect.closest_hit sphere branch: rsqrt form).
                sel = hit & is_sph
                t_ns = jnp.where(sel, tt, 0.0)
                thx = ox + dx * t_ns - scx
                thy = oy + dy * t_ns - scy
                thz = oz + dz * t_ns - scz
                inv_n = jax.lax.rsqrt(jnp.maximum(
                    thx * thx + thy * thy + thz * thz, 1e-6))
                nhx = jnp.where(sel, thx * inv_n, nhx)
                nhy = jnp.where(sel, thy * inv_n, nhy)
                nhz = jnp.where(sel, thz * inv_n, nhz)

            active = alive & hit
            hit_light = active & is_em
            a_r = jnp.where(hit_light, emr, a_r)
            a_g = jnp.where(hit_light, emg, a_g)
            a_b = jnp.where(hit_light, emb, a_b)
            surf = active & ~is_em

            t_safe = jnp.where(surf, tt, 0.0)
            hx = ox + dx * t_safe + nhx * 1e-3
            hy = oy + dy * t_safe + nhy * 1e-3
            hz = oz + dz * t_safe + nhz * 1e-3

            # NEE (planar mirror of smp.sample_area_light: right=(he,0,0),
            # up=(0,0,he) => sample y == light center y exactly).
            w0 = nee0[:, bounce] * 2.0 - 1.0
            w1 = nee1[:, bounce] * 2.0 - 1.0
            tlx = (lcx + he * w0) - hx
            tly = lcy - hy
            tlz = (lcz + he * w1) - hz
            dist = jnp.sqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz,
                                        0.0))
            inv_d = 1.0 / jnp.maximum(dist, 1e-3)
            ldx, ldy, ldz = tlx * inv_d, tly * inv_d, tlz * inv_d
            # saturate(dot(-direction, light_normal)) then
            # saturate(dot(normal, ldir)) — oracle multiply order:
            # ((color * inv_d^2) * cos_light) * cos_surf.
            cos_l = jnp.clip(-(ldx * lnx + ldy * lny + ldz * lnz), 0.0, 1.0)
            cos_s = jnp.clip(nhx * ldx + nhy * ldy + nhz * ldz, 0.0, 1.0)
            inv_d2 = inv_d * inv_d

            col_r = jnp.where(surf, col_r * dfr, col_r)
            col_g = jnp.where(surf, col_g * dfg, col_g)
            col_b = jnp.where(surf, col_b * dfb, col_b)

            contrib = surf & ~occ
            gain = (inv_d2 * cos_l) * cos_s
            a_r = a_r + jnp.where(contrib, (lr * gain) * col_r, 0.0)
            a_g = a_g + jnp.where(contrib, (lg * gain) * col_g, 0.0)
            a_b = a_b + jnp.where(contrib, (lb * gain) * col_b, 0.0)

            # Cosine bounce (planar mirror of cosine_hemisphere_y_up +
            # align_hemisphere_with_normal).
            phi = _F32(2.0 * math.pi) * cos0[:, bounce]
            cth = jnp.sqrt(cos1[:, bounce])
            sth = jnp.sqrt(1.0 - cth * cth)
            sx = sth * jnp.cos(phi)
            sy = cth
            sz = sth * jnp.sin(phi)
            ax, ay, az = _F32(0.0072), _F32(1.0), _F32(0.0034)
            crx = nhy * az - nhz * ay
            cry = nhz * ax - nhx * az
            crz = nhx * ay - nhy * ax
            crn = jnp.sqrt(crx * crx + cry * cry + crz * crz)
            crx, cry, crz = crx / crn, cry / crn, crz / crn
            fwx = cry * nhz - crz * nhy
            fwy = crz * nhx - crx * nhz
            fwz = crx * nhy - cry * nhx
            sdx = sx * crx + sy * nhx + sz * fwx
            sdy = sx * cry + sy * nhy + sz * fwy
            sdz = sx * crz + sy * nhz + sz * fwz

            ox = jnp.where(surf, hx, ox)
            oy = jnp.where(surf, hy, oy)
            oz = jnp.where(surf, hz, oz)
            dx = jnp.where(surf, sdx, dx)
            dy = jnp.where(surf, sdy, dy)
            dz = jnp.where(surf, sdz, dz)
            alive = surf

        return (lum_r + jnp.sum(a_r, axis=0), lum_g + jnp.sum(a_g, axis=0),
                lum_b + jnp.sum(a_b, axis=0)), None

    xs = (rs(aux.records), rs(aux.nee_u0), rs(aux.nee_u1),
          rs(aux.cos_u0), rs(aux.cos_u1), rs(aux.jitter_x), rs(aux.jitter_y))
    zero = jnp.zeros(px.shape, _F32)
    # Rematerialized per chunk: the backward recomputes each chunk's
    # forward instead of storing its residuals, bounding live memory.
    (lum_r, lum_g, lum_b), _ = jax.lax.scan(
        jax.checkpoint(one_chunk), (zero, zero, zero), xs)
    inv_spp = _F32(1.0 / config.spp)
    hdr = jnp.stack([lum_r * inv_spp, lum_g * inv_spp, lum_b * inv_spp],
                    axis=-1)
    return hdr.reshape(config.height, config.width, 3)


def render_path_decoupled(scene: Scene, config: RenderConfig,
                          draws=None, occluders=None) -> jnp.ndarray:
    """Fast differentiable variant-B render. Value matches the
    megakernel/oracle; gradients match jax.grad of the oracle.

    Both triangle and sphere scenes take the fused path (trace kernel
    forward + the hand-written backward kernel, ops/pallas_shade.py — the
    backward replays the analytic sphere quadratic in-kernel). The jnp
    ``shade_replay`` remains as the slow parity oracle for the record
    format (tests/test_decoupled.py). ``draws``: optional step-invariant
    ``pallas_path.pregen_draws(config)`` planes — pass from outside a
    training loop to amortize their generation."""
    from .pallas_shade import render_path_decoupled_fused
    return render_path_decoupled_fused(scene, config, draws=draws,
                                       occluders=occluders)

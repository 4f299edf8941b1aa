"""Record-replay Pallas backward for the MIS megakernel
(ops/pallas_mis_bwd.py): forward values are the trace kernel's own output;
gradients must match jax.grad of the jnp oracle across every parameter group
(light photometry/geometry, triangle materials/geometry, camera). Interpret
mode on CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer_tpu.ops.pallas_mis_bwd import (render_mis_decoupled,
                                                 render_mis_fused)
from gpuraytracer_tpu.render import render_mis
from gpuraytracer_tpu.scene import cornell_box, cornell_box_with_spheres
from gpuraytracer_tpu.types import RenderConfig

_CFG = RenderConfig(width=16, height=8, integrator="mis", camera_rays=2,
                    mis_samples=6, pixel_chunk=128)


@pytest.fixture(scope="module")
def scene():
    return cornell_box(resolution=(16, 8))


@pytest.fixture(scope="module")
def grads(scene):
    g_f = jax.grad(lambda s: jnp.mean(render_mis_fused(s, _CFG)),
                   allow_int=True)(scene)
    g_o = jax.grad(lambda s: jnp.mean(render_mis(s, _CFG).hdr),
                   allow_int=True)(scene)
    return g_f, g_o


@pytest.mark.smoke
def test_mis_fused_value_matches_oracle(scene):
    out = np.asarray(render_mis_fused(scene, _CFG))
    oracle = np.asarray(render_mis(scene, _CFG).hdr)
    np.testing.assert_allclose(out, oracle, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("group", [
    "light.emitted_radiance", "light.center", "light.normal",
    "light.width", "light.depth",
    "triangles.verts", "triangles.diffuse", "triangles.metallic",
    "triangles.roughness",
    "camera.position", "camera.direction", "camera.up",
])
def test_mis_fused_grads_match_oracle(grads, group):
    g_f, g_o = grads
    obj_f, obj_o = g_f, g_o
    for part in group.split("."):
        obj_f = getattr(obj_f, part)
        obj_o = getattr(obj_o, part)
    a, b = np.asarray(obj_f), np.asarray(obj_o)
    assert np.abs(b).max() > 0.0, f"oracle grad for {group} is all-zero"
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, atol=1e-5 * max(scale, 1.0), rtol=2e-4)


@pytest.fixture(scope="module")
def sphere_scene():
    return cornell_box_with_spheres(resolution=(16, 8))


@pytest.fixture(scope="module")
def sphere_grads(sphere_scene):
    g_f = jax.grad(lambda s: jnp.mean(render_mis_fused(s, _CFG)),
                   allow_int=True)(sphere_scene)
    g_o = jax.grad(lambda s: jnp.mean(render_mis(s, _CFG).hdr),
                   allow_int=True)(sphere_scene)
    return g_f, g_o


@pytest.mark.smoke
def test_mis_fused_sphere_value_matches_oracle(sphere_scene):
    out = np.asarray(render_mis_fused(sphere_scene, _CFG))
    oracle = np.asarray(render_mis(sphere_scene, _CFG).hdr)
    np.testing.assert_allclose(out, oracle, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("group", [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "triangles.verts", "triangles.diffuse",
    "light.emitted_radiance", "light.center", "camera.position",
])
def test_mis_fused_sphere_grads_match_oracle(sphere_grads, group):
    """Almost-everywhere-tight comparison: the sphere scene has isolated
    gate-boundary pixels where f32-ulp value differences between the
    independently compiled replay and oracle flip a clip/max gate in
    reverse mode, giving a bodily different — individually valid —
    subgradient for ONE primitive at that pixel (measured round 5: 3 of
    108 vert elements at ~2e-4 of max-norm, the rest at 1e-7; the same
    phenomenon as accelerator-vs-oracle decision flips). Assert
    the tight bound on all but a bounded handful of elements, and a
    1e-3-of-max-norm cap on those."""
    g_f, g_o = sphere_grads
    obj_f, obj_o = g_f, g_o
    for part in group.split("."):
        obj_f = getattr(obj_f, part)
        obj_o = getattr(obj_o, part)
    a, b = np.asarray(obj_f), np.asarray(obj_o)
    assert np.abs(b).max() > 0.0, f"oracle grad for {group} is all-zero"
    scale = np.abs(b).max()
    d = np.abs(a - b)
    tight = 1e-5 * max(scale, 1.0) + 2e-4 * np.abs(b)
    n_out = int((d > tight).sum())
    assert n_out <= max(3, a.size // 20), (group, n_out, a.size)
    assert d.max() <= 1e-3 * max(scale, 1.0), (group, float(d.max()), scale)


def test_mis_decoupled_routes_sphere_scenes_fused(sphere_scene):
    """render_mis_decoupled is the fused path for every scene type now."""
    out = np.asarray(render_mis_decoupled(sphere_scene, _CFG))
    oracle = np.asarray(render_mis(sphere_scene, _CFG).hdr)
    np.testing.assert_allclose(out, oracle, atol=5e-4, rtol=1e-3)


def test_mis_occluder_culling_preserves_render(scene, sphere_scene):
    """The MIS kernel's light-probe occluder culling (including the culled
    light-panel/hull triangles) changes no visibility decision: masked and
    full-loop renders agree to compilation-variance ulps on both triangle
    and sphere scenes (ADVICE r3 — this path was previously exercised only
    by bench.py/CLI)."""
    from gpuraytracer_tpu.intersect import potential_occluders

    for s in (scene, sphere_scene):
        occ = potential_occluders(s, _CFG)
        assert not all(occ), "expected at least one culled triangle"
        a = np.asarray(render_mis_fused(s, _CFG, occluders=occ))
        b = np.asarray(render_mis_fused(s, _CFG))
        np.testing.assert_allclose(a, b, atol=5e-8, rtol=1e-6)


def test_handwritten_reverse_helpers():
    """The hand-written reverse sweep (round 5) == jax.vjp of its own
    forward, pair by pair and for the full per-sample orchestration —
    both triangle-only and sphere paths, on random well-conditioned
    tiles. This is the unit tier beneath the oracle-parity tests above:
    a failure here localizes a derivative bug to one helper."""
    import math

    import gpuraytracer_tpu.ops.pallas_mis_bwd as M

    rng = np.random.default_rng(7)
    SHP = (4, 8)

    def P(lo=0.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, SHP), jnp.float32)

    def V3():
        v = rng.normal(size=(3,) + SHP)
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        return tuple(jnp.asarray(v[i], jnp.float32) for i in range(3))

    def B(p=0.5):
        return jnp.asarray(rng.random(SHP) > p)

    def close(name, a, b, tol=3e-3):
        a = np.asarray(jnp.stack(jax.tree.leaves(a)), np.float64)
        b = np.asarray(jnp.stack(jax.tree.leaves(b)), np.float64)
        scale = max(np.abs(b).max(), 1e-6)
        assert np.abs(a - b).max() / scale < tol, name

    def make_lightp():
        lc = [P(-0.5, 0.5), P(1.5, 2.0), P(-0.5, 0.5)]
        le = [P(5, 10) for _ in range(3)]
        lw, ld = P(0.3, 0.8), P(0.3, 0.8)
        return tuple(lc + le + [lw, ld] + list(V3()) + list(V3())
                     + list(V3()))

    def make_cs():
        d3 = V3()
        p3 = (P(-1, 1), P(0, 1), P(-1, 1))
        nh3 = V3()
        df3 = (P(), P(), P())
        met, rgh = P(0, 1), P(0.05, 1)
        alpha = rgh * rgh
        off3 = tuple(p3[c] + nh3[c] * 1e-4 for c in range(3))
        v3 = tuple(-d3[c] for c in range(3))
        cndv_raw = sum(nh3[c] * v3[c] for c in range(3))
        cndv = jnp.abs(cndv_raw) + 1e-5
        comm = 1.0 - met
        f0 = tuple(0.04 * comm + df3[c] * met for c in range(3))
        cargv = jnp.maximum((-cndv * alpha + cndv) * cndv + alpha, 1e-12)
        vndv = jnp.abs(cndv_raw)
        inv_nv2 = 1.0 / jnp.maximum(vndv * vndv, 1e-12)
        g1v = 2.0 / (1.0 + jnp.sqrt(1.0 + alpha * alpha
                                    * (inv_nv2 - 1.0)))
        return (d3 + p3 + nh3 + df3 + (met, rgh) + V3() + V3() + V3()
                + V3() + V3() + (alpha,) + off3 + v3
                + (cndv, jnp.sqrt(cargv)) + f0
                + (comm, g1v, vndv))

    def make_at2(ns):
        at = list(V3()) + [P(-1, 1), P(), P(), P(), P(0, 1), P(0.05, 1)]
        at += [jnp.asarray(rng.random(SHP) > 0.7, jnp.float32)]
        if ns:
            at += [P(-1, 1), P(0, 1), P(-1, 1), P(0.2, 0.6),
                   jnp.asarray(rng.random(SHP) > 0.5, jnp.float32)]
        return tuple(at)

    s_per_f = jnp.float32(2.0)
    su0, su1 = jnp.float32(0.41), jnp.float32(0.13)
    cs = make_cs()
    lightp = make_lightp()

    # bv pair
    l3 = V3()
    out, pdf, res = M._fwd_bv(cs, l3)
    d_out = tuple(P(-1, 1) for _ in range(3))
    d_pdf = P(-1, 1)
    _, vjp = jax.vjp(lambda c_, l_: M._fwd_bv(c_, l_)[:2], cs, l3)
    w_cs, w_l = vjp((d_out, d_pdf))
    bv = M._rev_bv(res, d_out, d_pdf)
    got_cs = [jnp.zeros(SHP, jnp.float32) for _ in range(M.NCS)]
    for c in range(3):
        got_cs[M.CS_V + c] = bv["d_v"][c]
        got_cs[M.CS_NH + c] = bv["d_n"][c]
        got_cs[M.CS_DF + c] = bv["d_df"][c]
        got_cs[M.CS_F0 + c] = bv["d_f0"][c]
    for k, slot in (("d_rgh", M.CS_RGH), ("d_a", M.CS_ALPHA),
                    ("d_ndv", M.CS_CNDV), ("d_sqv", M.CS_CSQV),
                    ("d_omm", M.CS_OMM), ("d_g1", M.CS_G1),
                    ("d_vndv", M.CS_VNDV)):
        got_cs[slot] = bv[k]
    close("bv.cs", got_cs, list(w_cs))
    close("bv.l", bv["d_l"], list(w_l))

    # generic brdf pair (secondary-surface sites)
    v3, n3, df3 = V3(), V3(), (P(), P(), P())
    met, rgh = P(0, 1), P(0.05, 1)
    outb, resb = M._fwd_brdf(v3, n3, df3, met, rgh, l3)
    d_outb = tuple(P(-1, 1) for _ in range(3))
    _, vjp = jax.vjp(lambda *a: M._fwd_brdf(*a)[0],
                     v3, n3, df3, met, rgh, l3)
    want = vjp(d_outb)
    got = M._rev_brdf(resb, d_outb)
    for i in range(6):
        close(f"brdf[{i}]", got[i], want[i])

    # bounce pair + full sample sweep, both scene types
    for ns in (0, 1):
        ndif = M.NDIF_SPH if ns else M.NDIF
        at_c, at_v = make_at2(ns), make_at2(ns)
        hit_c, hit_v = B(0.3), B(0.3)
        reach1, reach2, reach3, surf = B(0.4), B(0.4), B(0.4), B(0.3)
        tabsc = [jnp.float32(rng.uniform(0.05, 0.95))
                 for _ in range(M.NTAB)]
        ph = 2.0 * math.pi * float(tabsc[M.TAB_CU0])
        u1 = float(tabsc[M.TAB_CU1])
        sth = math.sqrt(max(1.0 - u1, 0.0))
        vph = 2.0 * math.pi * float(tabsc[M.TAB_VU0])
        ctm = 1.0 / math.sqrt(2.0)
        vct = ctm + (1.0 - ctm) * float(tabsc[M.TAB_VU1])
        vst = math.sqrt(max(0.0, 1.0 - vct * vct))
        tabsc += [jnp.float32(x) for x in
                  (math.cos(ph) * sth, math.sin(ph) * sth, math.sqrt(u1),
                   math.cos(vph) * vst, math.sin(vph) * vst, vct)]
        gs = tuple(P(-1, 1) for _ in range(3))

        def sample_primal(cs_, lp_, atc_, atv_):
            nh_ = cs_[M.CS_NH:M.CS_NH + 3]
            d_ = cs_[M.CS_D:M.CS_D + 3]
            p_ = cs_[M.CS_P:M.CS_P + 3]
            off_ = cs_[M.CS_OFF:M.CS_OFF + 3]
            le = (lp_[M.L_E], lp_[M.L_E + 1], lp_[M.L_E + 2])
            total = 0.0
            ld1, _ = M._fwd_lsample(lp_, off_, tabsc[M.TAB_LU0],
                                    tabsc[M.TAB_LU1])
            pl1, _ = M._fwd_lightpdf(lp_, p_, ld1)
            b1, pv1, _ = M._fwd_bv(cs_, ld1)
            pc1, _ = M._fwd_cospdf(nh_, ld1)
            w1, _ = M._fwd_ph3(pl1, pc1, pv1, s_per_f)
            g1_ = surf & reach1
            total += sum(jnp.sum(gs[c] * jnp.where(
                g1_, b1[c] * le[c] * (1.0 / pl1) * w1, 0.0))
                for c in range(3))
            for at2, hit2, reach, tu, tsu in (
                    (atc_, hit_c, reach2,
                     (M.TAB_W0C, M.TAB_W1C, M.TAB_CTH),
                     (M.TAB_CSU0, M.TAB_CSU1)),):
                w0, w1c, cth = (tabsc[tu[0]], tabsc[tu[1]], tabsc[tu[2]])
                t_ = cs_[M.CS_T:M.CS_T + 3]
                bb_ = cs_[M.CS_B:M.CS_B + 3]
                raw = tuple(t_[c] * w0 + bb_[c] * w1c + nh_[c] * cth
                            for c in range(3))
                cd, _ = M._fwd_norm3(*raw, 1e-12)
                pc, _ = M._fwd_cospdf(nh_, cd)
                pl, _ = M._fwd_lightpdf(lp_, p_, cd)
                b2, pv, _ = M._fwd_bv(cs_, cd)
                wc, _ = M._fwd_ph3(pc, pl, pv, s_per_f)
                o2, _ = M._fwd_bounce(cs_, lp_, at2, hit2, reach, cd, pc,
                                      wc, tabsc[tsu[0]], tabsc[tsu[1]],
                                      surf, s_per_f, ns, b2)
                total += sum(jnp.sum(gs[c] * o2[c]) for c in range(3))
            k0, k1, vc = (tabsc[M.TAB_K0V], tabsc[M.TAB_K1V],
                          tabsc[M.TAB_VCT])
            t1_ = cs_[M.CS_T1:M.CS_T1 + 3]
            t2_ = cs_[M.CS_T2:M.CS_T2 + 3]
            ve_ = cs_[M.CS_VE:M.CS_VE + 3]
            hraw = tuple(t1_[c] * k0 + t2_[c] * k1 + ve_[c] * vc
                         for c in range(3))
            h3, _ = M._fwd_norm3(*hraw, 1e-12)
            nl3, _ = M._fwd_norm3(cs_[M.CS_ALPHA] * h3[0],
                                  cs_[M.CS_ALPHA] * h3[1],
                                  jnp.maximum(0.0, h3[2]), 1e-12)
            t_ = cs_[M.CS_T:M.CS_T + 3]
            bb_ = cs_[M.CS_B:M.CS_B + 3]
            whraw = tuple(t_[c] * nl3[0] + bb_[c] * nl3[1]
                          + nh_[c] * nl3[2] for c in range(3))
            wh3, _ = M._fwd_norm3(*whraw, 1e-12)
            ddh = sum(d_[c] * wh3[c] for c in range(3))
            vd = tuple(d_[c] - 2.0 * ddh * wh3[c] for c in range(3))
            b2v, pv2, _ = M._fwd_bv(cs_, vd)
            pl2, _ = M._fwd_lightpdf(lp_, p_, vd)
            pc2, _ = M._fwd_cospdf(nh_, vd)
            wv, _ = M._fwd_ph3(pv2, pl2, pc2, s_per_f)
            o3, _ = M._fwd_bounce(cs_, lp_, atv_, hit_v, reach3, vd, pv2,
                                  wv, tabsc[M.TAB_VSU0],
                                  tabsc[M.TAB_VSU1], surf, s_per_f, ns,
                                  b2v)
            total += sum(jnp.sum(gs[c] * o3[c]) for c in range(3))
            return total

        want = jax.grad(sample_primal, argnums=(0, 1, 2, 3))(
            cs, lightp, at_c, at_v)
        d_cs = [jnp.zeros(SHP, jnp.float32) for _ in range(M.NCS)]
        d_lp = [jnp.zeros(SHP, jnp.float32) for _ in range(17)]
        d_atc = [jnp.zeros(SHP, jnp.float32) for _ in range(ndif)]
        d_atv = [jnp.zeros(SHP, jnp.float32) for _ in range(ndif)]
        M._sample_fwd_rev(cs, lightp, tabsc, reach1, reach2, reach3,
                          hit_c, list(at_c), hit_v, list(at_v), surf, gs,
                          s_per_f, d_cs, d_lp, d_atc, d_atv, ns)
        close(f"sample{ns}.cs", d_cs, list(want[0]))
        close(f"sample{ns}.lp", d_lp, list(want[1]))
        close(f"sample{ns}.atc", d_atc, list(want[2]))
        close(f"sample{ns}.atv", d_atv, list(want[3]))

"""Batched ray-scene intersection — the jnp oracle's acceleration structure.

Replaces the reference's driver-built BVH + hardware ``intersector``
(setupAccelerationStructures, RTrace/computeShader.swift:45-97; traversal at
RTrace/raytrace.metal:48-49,83-85 and shaders.metal:459-509). JAX cannot
reach ray-tracing hardware and the reference scene is 34 triangles, so the
oracle is a brute-force *vectorized* test of every ray against every
triangle ([rays, triangles] arrays, triangles padded to ``lane_pad``), and
closest-hit is an argmin over triangles. ``compile_scene`` is the analog of the
accel-structure build step: it precomputes per-triangle constants so one
ray-triangle test is 6 broadcasted dot products plus elementwise math.

Everything here is differentiable w.r.t. geometry: the hit distance ``t`` and
barycentrics are smooth functions of the verts of the *selected* triangle
(the discrete argmin winner is treated as constant, which is the correct
piecewise gradient away from visibility edges — SURVEY.md §7 hard parts).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .sampling import dot, cross
from .types import CompiledScene, Spheres, TriangleScene

RAY_TMIN = 1e-3
RAY_TMAX = 1e3
_BIG = 1e30


def _broadcast_limits(t_min, t_max):
    """Give per-ray t limits a trailing primitive axis."""
    t_min = jnp.asarray(t_min)
    t_max = jnp.asarray(t_max)
    if t_min.ndim:
        t_min = t_min[..., None]
    if t_max.ndim:
        t_max = t_max[..., None]
    return t_min, t_max


def _pad_to(x: jnp.ndarray, p: int, value=0.0) -> jnp.ndarray:
    t = x.shape[0]
    if t == p:
        return x
    pad_width = [(0, p - t)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value)


def compile_scene(tri: TriangleScene, lane_pad: int = 128) -> CompiledScene:
    """Precompute intersection constants; pad the triangle axis to a multiple
    of ``lane_pad`` so [rays, T] arrays have a regular shape. Padding triangles are flagged invalid and use a far-away plane so
    they can never win the argmin."""
    v0 = tri.verts[:, 0, :]
    e1 = tri.verts[:, 1, :] - v0
    e2 = tri.verts[:, 2, :] - v0
    n_raw = cross(e1, e2)
    n = n_raw * jax.lax.rsqrt(jnp.maximum(dot(n_raw, n_raw), 1e-30))[..., None]
    c0 = dot(n, v0)

    # Dual basis of (e1, e2) in the triangle plane: u = (h - v0) . s1 etc.
    e11 = dot(e1, e1)
    e22 = dot(e2, e2)
    e12 = dot(e1, e2)
    denom = jnp.maximum(e11 * e22 - e12 * e12, 1e-30)
    s1 = (e22[..., None] * e1 - e12[..., None] * e2) / denom[..., None]
    s2 = (e11[..., None] * e2 - e12[..., None] * e1) / denom[..., None]
    c1 = dot(v0, s1)
    c2 = dot(v0, s2)

    t = tri.num_triangles
    p = max(lane_pad, ((t + lane_pad - 1) // lane_pad) * lane_pad)
    valid = _pad_to(jnp.ones((t,), bool), p, False)
    emissive = _pad_to(tri.emissive, p)

    return CompiledScene(
        n=_pad_to(n, p),
        c0=_pad_to(c0, p, _BIG),
        s1=_pad_to(s1, p),
        s2=_pad_to(s2, p),
        c1=_pad_to(c1, p),
        c2=_pad_to(c2, p),
        valid=valid,
        diffuse=_pad_to(tri.diffuse, p),
        metallic=_pad_to(tri.metallic, p),
        roughness=_pad_to(tri.roughness, p),
        emissive=emissive,
        is_emissive=jnp.linalg.norm(emissive, axis=-1) > 0.0,
    )


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays. ``hit`` False => miss.

    ``prim`` indexes the padded triangle array (or, for sphere hits,
    tri_count + sphere index). Shading attributes are pre-gathered so callers
    never index scene arrays with traced ids (mirrors
    ``materials[intersection.primitive_id]``, raytrace.metal:55)."""

    hit: jnp.ndarray        # [...] bool
    t: jnp.ndarray          # [...] f32 (BIG on miss)
    prim: jnp.ndarray       # [...] i32
    normal: jnp.ndarray     # [..., 3] f32 geometric normal
    diffuse: jnp.ndarray    # [..., 3] f32
    metallic: jnp.ndarray   # [...] f32
    roughness: jnp.ndarray  # [...] f32
    emissive: jnp.ndarray   # [..., 3] f32
    is_emissive: jnp.ndarray  # [...] bool


def _triangle_candidates(
    scene: CompiledScene, origin: jnp.ndarray, direction: jnp.ndarray,
    t_min, t_max,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-pairs ray/triangle test. origin/direction are [..., 3]; returns
    (t_vals[..., P], valid[..., P]). Written as broadcasted multiply-adds
    (full-f32 elementwise work; no reduced-precision matmul for K=3 dots).
    t_min/t_max may be scalars or per-ray arrays [...]."""
    t_min, t_max = _broadcast_limits(t_min, t_max)
    o = origin[..., None, :]   # [..., 1, 3]
    d = direction[..., None, :]

    n = scene.n                # [P, 3]
    den = jnp.sum(d * n, axis=-1)                    # [..., P]
    num = scene.c0 - jnp.sum(o * n, axis=-1)         # [..., P]
    # Where the ray is parallel, force a miss via t outside [t_min, t_max].
    safe_den = jnp.where(jnp.abs(den) < 1e-12, 1.0, den)
    t = num / safe_den
    # Barycentric u, v: affine in (o, t*d).
    a1 = jnp.sum(o * scene.s1, axis=-1)
    b1 = jnp.sum(d * scene.s1, axis=-1)
    a2 = jnp.sum(o * scene.s2, axis=-1)
    b2 = jnp.sum(d * scene.s2, axis=-1)
    u = a1 + t * b1 - scene.c1
    v = a2 + t * b2 - scene.c2

    valid = (
        (jnp.abs(den) >= 1e-12)
        & (t > t_min)
        & (t < t_max)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & scene.valid
    )
    return t, valid


def _sphere_candidates(
    spheres: Spheres, origin: jnp.ndarray, direction: jnp.ndarray,
    t_min, t_max,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic quadratic ray/sphere test (intersectSphere,
    shaders_old.metal:108-136). Differentiable w.r.t. centers/radii. The
    reference accepts min(t1, t2) whenever either root is positive — meaning a
    ray starting inside a sphere "hits" behind itself; we instead take the
    smallest root within [t_min, t_max], the fixed behavior (hits from inside
    use the far root)."""
    t_min, t_max = _broadcast_limits(t_min, t_max)
    oc = origin[..., None, :] - spheres.center        # [..., S, 3]
    d = direction[..., None, :]
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - spheres.radius * spheres.radius
    disc = b * b - 4.0 * a * c
    # Double-where: sqrt'(0) is inf and would leak NaN into reverse-mode
    # gradients of *masked-out* rays (0 * inf); keep the unselected branch
    # finite and differentiable.
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t1_ok = (t1 > t_min) & (t1 < t_max)
    t2_ok = (t2 > t_min) & (t2 < t_max)
    t = jnp.where(t1_ok, t1, t2)
    valid = (disc > 0.0) & (t1_ok | t2_ok)
    return t, valid


def closest_hit(
    scene: CompiledScene, origin: jnp.ndarray, direction: jnp.ndarray,
    t_min: float = RAY_TMIN, t_max: float = RAY_TMAX,
    spheres: Optional[Spheres] = None,
) -> Hit:
    """Closest-hit query over triangles (+ optional spheres): argmin over the
    primitive lane axis. Equivalent of ``i.intersect(r, accel)`` closest-hit
    (raytrace.metal:48-49) / ``getClosestIntersection`` (shaders.metal:459)."""
    t_tri, valid_tri = _triangle_candidates(scene, origin, direction, t_min, t_max)
    t_all, valid_all = t_tri, valid_tri
    num_tri = t_tri.shape[-1]

    has_spheres = spheres is not None and spheres.num_spheres > 0
    if has_spheres:
        t_sph, valid_sph = _sphere_candidates(spheres, origin, direction,
                                              t_min, t_max)
        t_all = jnp.concatenate([t_tri, t_sph], axis=-1)
        valid_all = jnp.concatenate([valid_tri, valid_sph], axis=-1)

    t_masked = jnp.where(valid_all, t_all, _BIG)
    prim = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    hit = jnp.take_along_axis(valid_all, prim[..., None], axis=-1)[..., 0]
    # Differentiable t of the winning primitive (argmin index is piecewise
    # constant; gradient flows through the selected candidate's t).
    t_hit = jnp.take_along_axis(t_all, prim[..., None], axis=-1)[..., 0]
    t_hit = jnp.where(hit, t_hit, _BIG)

    take = lambda arr, idx: jnp.take(arr, idx, axis=0)
    if not has_spheres:
        normal = take(scene.n, prim)
        diffuse = take(scene.diffuse, prim)
        emissive = take(scene.emissive, prim)
        metallic = take(scene.metallic, prim)
        roughness = take(scene.roughness, prim)
        is_em = take(scene.is_emissive, prim)
    else:
        is_sphere = prim >= num_tri
        sph_idx = jnp.clip(prim - num_tri, 0, spheres.num_spheres - 1)
        tri_idx = jnp.clip(prim, 0, num_tri - 1)
        # Sphere normal: (hit_point - center) / radius — differentiable
        # w.r.t. center (shaders_old.metal:122-123). t is clamped to 0 on
        # misses before use so the unselected branch stays finite in both
        # primal and reverse mode (t_hit is BIG on miss).
        t_safe = jnp.where(hit & is_sphere, t_hit, 0.0)
        hit_point = origin + t_safe[..., None] * direction
        center = take(spheres.center, sph_idx)
        to_hit = hit_point - center
        sph_normal = to_hit * jax.lax.rsqrt(
            jnp.maximum(dot(to_hit, to_hit), 1e-6)
        )[..., None]
        sel = is_sphere[..., None]
        normal = jnp.where(sel, sph_normal, take(scene.n, tri_idx))
        diffuse = jnp.where(sel, take(spheres.diffuse, sph_idx),
                            take(scene.diffuse, tri_idx))
        emissive = jnp.where(sel, take(spheres.emissive, sph_idx),
                             take(scene.emissive, tri_idx))
        metallic = jnp.where(is_sphere, take(spheres.metallic, sph_idx),
                             take(scene.metallic, tri_idx))
        roughness = jnp.where(is_sphere, take(spheres.roughness, sph_idx),
                              take(scene.roughness, tri_idx))
        is_em = jnp.linalg.norm(emissive, axis=-1) > 0.0

    return Hit(hit=hit, t=t_hit, prim=prim, normal=normal, diffuse=diffuse,
               metallic=metallic, roughness=roughness, emissive=emissive,
               is_emissive=is_em)


def any_hit(
    scene: CompiledScene, origin: jnp.ndarray, direction: jnp.ndarray,
    t_min: float = RAY_TMIN, t_max=RAY_TMAX,
    spheres: Optional[Spheres] = None,
) -> jnp.ndarray:
    """Shadow-ray occlusion query: ``accept_any_intersection(true)`` with a
    max distance (raytrace.metal:79-85) becomes a masked ``any`` reduction —
    no early-out needed at bounded scene sizes (SURVEY.md §2.3)."""
    _, valid = _triangle_candidates(scene, origin, direction, t_min, t_max)
    occluded = jnp.any(valid, axis=-1)
    if spheres is not None and spheres.num_spheres > 0:
        _, valid_s = _sphere_candidates(spheres, origin, direction, t_min, t_max)
        occluded = occluded | jnp.any(valid_s, axis=-1)
    return occluded


def potential_occluders(scene, config=None, tol_scale: float = 1e-6,
                        sphere_slack: float = 0.0):
    """Static shadow-probe culling mask: ``mask[t]`` is False when triangle
    t provably CANNOT occlude any segment between a scene surface point and
    an area-light sample point, because every such endpoint lies in one
    closed half-space of t's plane (a segment with both endpoints on one
    side of a plane never crosses it; endpoint-grazing hits fall outside the
    probes' open t-window). In the Cornell box this culls the 10 convex-hull
    wall triangles and the 2 light-panel triangles from every NEE/visibility
    probe — ~1/3 of the kernels' shadow-loop work — while the box and sphere
    primitives (whose planes cut through the scene) are kept.

    Runs EAGERLY on host numpy — call it once per concrete scene and pass
    the resulting tuple to the render entry points (like
    ``pallas_path.pregen_draws``); it cannot be computed under jit tracing.
    The mask is tied to the scene geometry it was computed from: rebuild it
    if triangle/sphere/light geometry moves by more than ``tol_scale`` times
    the scene scale. Endpoint set covered: every triangle vertex, every
    sphere's center +- radius along each plane normal, the light quad
    corners (true frame) AND the variant-B hardcoded half-extent square
    (sampling.metal:208-213 quirk). Returns a tuple of bools, True = keep
    in the shadow loop. Reference behavior being preserved: the occlusion
    tests of RTrace/raytrace.metal:79-85 / shaders.metal:519-541 (decisions
    are bit-identical — culled triangles could never flip them).

    ``tol_scale``: slack on the half-space test, absorbing ONLY the f32->f64
    conversion noise of the endpoint coordinates (~1e-7 relative). It MUST
    stay well below the kernels' geometric epsilons (1e-3 shadow-origin
    offset along the normal; 1e-3 t_max shrink) — a tol that exceeded those
    margins would let a segment genuinely cross a culled triangle's plane,
    silently changing visibility vs the full loop (asserted below).

    ``sphere_slack``: inflates every sphere's radius by this amount in the
    endpoint set, so the mask stays conservative while sphere CENTERS move
    by up to ``sphere_slack`` (in any direction) from the positions it was
    computed at — what an inverse-rendering loop optimizing centers needs to
    hoist the mask out of its scan (grad/inverse.py). Triangle and light
    geometry must still be exactly the geometry passed here."""
    import numpy as np

    verts = np.asarray(scene.triangles.verts, np.float64)  # [T, 3, 3]
    T = verts.shape[0]
    v0 = verts[:, 0]
    n = np.cross(verts[:, 1] - v0, verts[:, 2] - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)
    c0 = np.sum(n * v0, axis=-1)  # [T]

    pts = [verts.reshape(-1, 3)]
    light = scene.light
    lc = np.asarray(light.center, np.float64)
    ln = np.asarray(light.normal, np.float64)
    # True light frame corners.
    from .sampling import build_orthonormal_basis
    lt, lb = (np.asarray(x, np.float64)
              for x in build_orthonormal_basis(jnp.asarray(ln, jnp.float32)))
    w2 = float(light.width) / 2.0
    d2 = float(light.depth) / 2.0
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            pts.append((lc + sx * w2 * lt + sy * d2 * lb)[None])
    # Variant-B hardcoded half-extent square (x/z frame).
    he = float(config.area_light_half_extent) if config is not None else 0.25
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            pts.append((lc + np.array([sx * he, 0.0, sy * he]))[None])
    # Camera position: on non-surface lanes the kernels' (masked) shadow
    # probes originate at ~the camera (t_safe = 0 + the 1e-3 normal offset);
    # in the silhouette kernels that occ_s bit is decision-RELEVANT on
    # potential & ~sphere_front lanes (it feeds alpha_soft * (L_s - L_t)),
    # so the proof's endpoint hull must contain the camera too (ADVICE r4).
    pts.append(np.asarray(scene.camera.position, np.float64)[None])
    pts = np.concatenate(pts, axis=0)  # [P, 3]

    d = pts @ n.T - c0[None, :]  # [P, T] signed distances
    scale = max(1.0, np.abs(pts).max())
    tol = tol_scale * scale
    # The culling proof needs tol strictly inside the kernels' shadow-ray
    # epsilons (1e-3 origin offset / t_max shrink): an endpoint accepted up
    # to tol on the wrong side of a plane is then still outside the probes'
    # open t-window (ADVICE r3). For scenes with coordinate extent >= 100
    # units the default tol_scale would breach that bound — fall back to the
    # all-keep mask (culling is an optimization; keeping everything is
    # always correct) instead of hard-failing (ADVICE r4).
    if tol >= 1e-4:
        import warnings
        warnings.warn(
            f"potential_occluders: tol {tol:.3g} (scene extent {scale:.3g})"
            " would exceed the kernels' 1e-3 shadow epsilons; disabling"
            " static occluder culling for this scene", stacklevel=2)
        return tuple(True for _ in range(T))
    below = np.all(d <= tol, axis=0)
    above = np.all(d >= -tol, axis=0)
    sp = scene.spheres
    if sp.num_spheres:
        c = np.asarray(sp.center, np.float64)   # [S, 3]
        r = np.asarray(sp.radius, np.float64) + float(sphere_slack)  # [S]
        ds = c @ n.T - c0[None, :]              # [S, T]
        below &= np.all(ds + r[:, None] <= tol, axis=0)
        above &= np.all(ds - r[:, None] >= -tol, axis=0)
    return tuple(bool(x) for x in ~(below | above))

"""Legacy-tier integrator — the richest feature set of the reference.

Mirrors ``calculateLighting`` / ``recursiveLightingCalculation`` in
/root/reference/Sources/gpuRaytracer/shaders_old.metal:738-1250 (the legacy
kernel excluded from reference builds, SURVEY.md §2.2): a 3-strategy MIS
integrator (light / cosine / VNDF) with beta=2 power heuristic where the
cosine and VNDF strategies *recurse* into the same lighting calculation at
the bounce hit with a fixed nested sample count (the reference hardcodes 30,
shaders_old.metal:837,911).

What makes this tier distinct from the active variant-A MIS integrator
(render.render_mis):

  * sphere geometry and **sphere lights** are first-class, hit-tested
    analytically (intersectSphere :108-136, intersectLight :138-170);
  * **box lights** are supported as an NEE target via area-weighted 6-face
    sampling (sampleBoxLight :292-404) and a slab-test directional pdf
    (calculateBoxLightPdf :625-676);
  * power heuristic uses beta=2 (:748) instead of variant A's 1.0;
  * true recursion (depth ``legacy_bounces``) instead of variant A's fixed
    one-extra-NEE.

Restructured for JAX: GPU-thread recursion becomes a statically unrolled
depth-``legacy_bounces`` Python recursion over dense pixel arrays; per-thread
``continue``/sentinel branches become masks; sphere lights are hit-tested by
concatenating them into the sphere SoA as emissive spheres; box lights are
hit-tested as 12 emissive triangles appended by the scene constructor (the
arrays here drive sampling/pdf only). Randomness is a pure function of
(pixel, sample, strategy, depth) — shard-invariant (SURVEY.md §7). The
reference's per-sample loop becomes a ``lax.scan`` with rematerialization so
the backward pass stays memory-light.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from . import sampling as smp
from .brdf import brdf_contribution
from .intersect import RAY_TMAX, RAY_TMIN, closest_hit, compile_scene
from .render import RenderOutput, _chunked, _zeros3, pixel_coords
from .types import RenderConfig, Scene, Spheres

_F32 = jnp.float32
_U32 = jnp.uint32


def _combined_spheres(scene: Scene) -> Optional[Spheres]:
    """Sphere geometry + sphere lights as emissive spheres — the analog of
    the legacy ``getClosestIntersection`` looping spheres then lights
    (shaders_old.metal:172-200)."""
    sp = scene.spheres
    sl = scene.sphere_lights
    if sl.num_lights == 0:
        return sp if sp.num_spheres > 0 else None
    n = sl.num_lights
    lights_as_spheres = Spheres(
        center=sl.center,
        radius=sl.radius,
        diffuse=sl.color,
        metallic=jnp.zeros((n,), _F32),
        roughness=jnp.ones((n,), _F32),
        emissive=sl.emitted_radiance,
    )
    if sp.num_spheres == 0:
        return lights_as_spheres
    return jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                        sp, lights_as_spheres)


def _light_kind(scene: Scene) -> str:
    """Static (host-side) choice of the NEE target — the reference handles
    'only one light atm' (shaders_old.metal:743); precedence favors the
    legacy-specific types when present."""
    if scene.sphere_lights.num_lights > 0:
        return "sphere"
    if scene.box_lights.num_lights > 0:
        return "box"
    return "square"


def _rng2(px, py, sample_i, strategy: int, depth: int, draw: int):
    """[..., 2] uniforms, pure function of (pixel, sample, strategy, depth,
    draw) — the replacement of the legacy hashRandom stream
    (shaders_old.metal:749 ties sampleId to an 800-wide pixel stride; we key
    on indices directly so renders are resolution- and shard-invariant)."""
    c = (_U32(1 + draw)
         + jnp.asarray(sample_i).astype(_U32) * _U32(9)
         + _U32(strategy) * _U32(1 << 16)
         + _U32(depth) * _U32(1 << 20))
    return smp.hash_random_2d(px, py, c)


def _sample_light(scene: Scene, kind: str, point, u2, u3):
    """Draw an NEE direction + pdf from the scene's primary light."""
    if kind == "sphere":
        sl = scene.sphere_lights
        return smp.sample_sphere_light(sl.center[0], sl.radius[0], point, u2)
    if kind == "box":
        bl = scene.box_lights
        return smp.sample_box_light(bl.center[0], bl.width[0], bl.height[0],
                                    bl.depth[0], point, u3)
    light = scene.light
    ldir, _ = smp.direct_square_light_sample(
        point, light.center, light.width, light.depth, light.normal, u2)
    pdf = smp.square_light_pdf(point, light.center, light.width, light.depth,
                               light.normal, ldir)
    return ldir, pdf


def _light_pdf(scene: Scene, kind: str, point, direction):
    """Pdf of ``direction`` under the light strategy (the cross-strategy term
    in the MIS weights). Sphere lights use the direction-independent cone pdf
    — reference behavior (calculateLightPdf, shaders_old.metal:617-623)."""
    if kind == "sphere":
        sl = scene.sphere_lights
        return smp.sphere_light_pdf(sl.center[0], sl.radius[0], point)
    if kind == "box":
        bl = scene.box_lights
        return smp.box_light_pdf(bl.center[0], bl.width[0], bl.height[0],
                                 bl.depth[0], point, direction)
    light = scene.light
    return smp.square_light_pdf(point, light.center, light.width, light.depth,
                                light.normal, direction)


def _trace_radiance(compiled, spheres, origin, direction):
    """``traceTriangleLightRay`` (shaders_old.metal:20-51): offset the origin
    1e-4 along the ray, closest-hit, return (radiance, hit_light_mask). The
    sentinel (-1,-1,-1) return becomes a mask."""
    h = closest_hit(compiled, origin + direction * 1e-4, direction,
                    RAY_TMIN, RAY_TMAX, spheres)
    hit_light = h.hit & h.is_emissive
    return h.emissive, hit_light, h


def _calculate_lighting(
    compiled, spheres, scene: Scene, config: RenderConfig, kind: str,
    px, py, point, normal, in_dir, diffuse, metallic, roughness,
    active, samples: int, depth: int,
):
    """One level of ``calculateLighting`` (shaders_old.metal:738-921) over a
    dense pixel batch. Returns [..., 3] radiance. ``depth`` counts remaining
    bounces; the nested recursion at depth > 1 re-enters with
    ``legacy_bounce_samples`` exactly like the reference's hardcoded 30."""
    spb = max(samples // 3, 1)
    beta = 2.0  # shaders_old.metal:748

    mat = (diffuse, metallic, roughness)

    def strategy_light(i):
        u2 = _rng2(px, py, i, 0, depth, 0)
        u3 = jnp.concatenate([u2, _rng2(px, py, i, 0, depth, 1)[..., :1]],
                             axis=-1)
        ldir, pdf_l = _sample_light(scene, kind, point, u2, u3)
        pdf_c = smp.cosine_pdf(normal, ldir)
        pdf_v = smp.vndf_pdf(-in_dir, normal, ldir, roughness)
        radiance, hit_light, _ = _trace_radiance(compiled, spheres, point, ldir)
        w = smp.power_heuristic_3(pdf_l, pdf_c, pdf_v, spb, beta)
        brdf = brdf_contribution(in_dir, normal, *mat, ldir)
        term = brdf * radiance * (w / jnp.maximum(pdf_l, 1e-8))[..., None]
        return jnp.where((active & hit_light)[..., None], term, 0.0)

    def strategy_bsdf(i, strategy: int):
        """Shared cosine (strategy=1) / VNDF (strategy=2) body, including the
        nested bounce recursion (shaders_old.metal:769-841, 843-921)."""
        u2 = _rng2(px, py, i, strategy, depth, 0)
        if strategy == 1:
            sdir = smp.cosine_weighted_dir(normal, u2)
            pdf_self = smp.cosine_pdf(normal, sdir)
            pdf_o1 = _light_pdf(scene, kind, point, sdir)
            pdf_o2 = smp.vndf_pdf(-in_dir, normal, sdir, roughness)
        else:
            sdir = smp.vndf_dir(-in_dir, normal, roughness, u2)
            pdf_self = smp.vndf_pdf(-in_dir, normal, sdir, roughness)
            pdf_o1 = _light_pdf(scene, kind, point, sdir)
            pdf_o2 = smp.cosine_pdf(normal, sdir)

        radiance, hit_light, h = _trace_radiance(compiled, spheres, point, sdir)
        w = smp.power_heuristic_3(pdf_self, pdf_o1, pdf_o2, spb, beta)
        brdf = brdf_contribution(in_dir, normal, *mat, sdir)
        direct = brdf * radiance * (w / jnp.maximum(pdf_self, 1e-8))[..., None]
        direct = jnp.where((active & hit_light)[..., None], direct, 0.0)

        if depth <= 1:
            return direct, jnp.zeros_like(direct)

        # Nested recursion: non-emissive hit -> evaluate lighting at the
        # bounce point with legacy_bounce_samples, weighted by
        # brdf(bounce material, lightValue=1) / pdf (shaders_old.metal:
        # 824-839, 898-913; note the reference evaluates the BRDF with the
        # *bounce hit's* material at the incoming surface frame — replicated).
        hit_geo = active & h.hit & ~h.is_emissive
        t_safe = jnp.where(hit_geo, h.t, 0.0)
        bpoint = (point + sdir * 1e-4) + sdir * t_safe[..., None]
        bpoint = bpoint + h.normal * 1e-4
        nested = _calculate_lighting(
            compiled, spheres, scene, config, kind, px, py,
            bpoint, h.normal, sdir, h.diffuse, h.metallic, h.roughness,
            hit_geo, config.legacy_bounce_samples, depth - 1)
        brdf_b = brdf_contribution(in_dir, normal, h.diffuse, h.metallic,
                                   h.roughness, sdir)
        throughput = brdf_b / (pdf_self[..., None] + 1e-6)
        bounce = jnp.where(hit_geo[..., None], throughput * nested, 0.0)
        return direct, bounce

    def one_sample(carry, i):
        total, bounce = carry
        d0 = strategy_light(i)
        d1, b1 = strategy_bsdf(i, 1)
        d2, b2 = strategy_bsdf(i, 2)
        return (total + d0 + d1 + d2, bounce + b1 + b2), None

    init = (_zeros3(px), _zeros3(px))
    (total, bounce), _ = jax.lax.scan(
        jax.checkpoint(one_sample), init, jnp.arange(spb, dtype=jnp.uint32))
    # Normalization: totalLight / (3*spb) + bounceLight / (2*spb) — the
    # reference's literal /60 with spb=30 (shaders_old.metal:917).
    return total / _F32(3 * spb) + bounce / _F32(2 * spb)


def _legacy_chunk(compiled, spheres, scene: Scene, config: RenderConfig,
                  kind: str, px, py):
    """One pixel chunk through the legacy pipeline: center-of-pixel camera
    ray (the legacy kernel has no jitter, shaders_old.metal:1261-1286),
    closest hit, then Miss -> 0 / HitLight -> radiance / Hit ->
    calculateLighting."""
    cam = scene.camera
    uv = jnp.full(px.shape + (2,), 0.5, _F32)
    o, d = smp.generate_camera_ray(
        cam.position, cam.direction, cam.up, config.resolution,
        cam.horizontal_fov, px, py, uv, config.integer_aspect)
    h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)

    hit_light = h.hit & h.is_emissive
    surf = h.hit & ~h.is_emissive
    t_safe = jnp.where(surf, h.t, 0.0)
    point = o + d * t_safe[..., None] + h.normal * 1e-4

    lit = _calculate_lighting(
        compiled, spheres, scene, config, kind, px, py, point, h.normal, d,
        h.diffuse, h.metallic, h.roughness, surf,
        config.legacy_samples, config.legacy_bounces)
    out = jnp.where(hit_light[..., None], h.emissive, 0.0)
    return out + jnp.where(surf[..., None], lit, 0.0)


def render_legacy(scene: Scene, config: RenderConfig) -> RenderOutput:
    """Legacy integrator entry (drawTriangle, shaders_old.metal:1255-1409):
    1 camera ray/pixel, ``legacy_bounces`` recursion depth, sphere/box/square
    NEE target chosen from the scene's light arrays."""
    compiled = compile_scene(scene.triangles, config.lane_pad)
    spheres = _combined_spheres(scene)
    kind = _light_kind(scene)
    px, py = pixel_coords(config)
    hdr = _chunked(
        partial(_legacy_chunk, compiled, spheres, scene, config, kind),
        config.num_pixels, config.pixel_chunk, px, py)
    return RenderOutput(hdr=hdr.reshape(config.height, config.width, 3),
                        ldr=None)

"""Reference (pure-jnp) renderers — the allclose oracle for all kernels.

Two integrators, mirroring the reference's two active kernels:

  * ``path``   — variant B: iterative NEE + cosine-bounce path tracer
                 (``pathTrace``, RTrace/raytrace.metal:11-111).
  * ``mis``    — variant A: 3-strategy multiple importance sampling
                 (``drawTriangle`` + ``recursiveMultiImportanceSampling``,
                 Sources/gpuRaytracer/shaders.metal:543-707).
  * ``direct`` — BASELINE config 1: the path integrator at bounces=1
                 (NEE only, no indirect continuation).

Data-dependent control flow (per-thread ``break`` out of the bounce loop,
hit-type branches) becomes fixed-shape masked arithmetic: every lane computes
every bounce and masks decide what accumulates — the fixed-shape
restructuring called out in SURVEY.md §7. Pixels are processed in chunks via ``lax.map`` to
bound the [rays, triangles] working set; samples loop inside the chunk.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from . import sampling as smp
from .brdf import brdf_contribution
from .intersect import RAY_TMAX, RAY_TMIN, any_hit, closest_hit, compile_scene
from .types import CompiledScene, RenderConfig, Scene

_F32 = jnp.float32


class RenderOutput(NamedTuple):
    hdr: jnp.ndarray  # [H, W, 3] f32 linear radiance (pre-tonemap)
    ldr: Optional[jnp.ndarray]  # [H, W, 3] f32 in [0,1] (mis integrator only)


def _zeros3(ref: jnp.ndarray, dtype=_F32) -> jnp.ndarray:
    """[..., 3] zeros derived arithmetically from ``ref`` [...] so loop-carry
    initializers keep the same device-varying status as loop bodies under
    shard_map manual axes."""
    return jnp.broadcast_to((ref.astype(dtype) * 0.0)[..., None],
                            ref.shape + (3,))


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def pixel_coords(config: RenderConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flattened row-major pixel coordinates [N] (x fastest, like the
    reference's thread grid)."""
    idx = jnp.arange(config.num_pixels, dtype=jnp.int32)
    px = idx % config.width
    py = idx // config.width
    return px, py


def pixel_rng_offsets(config: RenderConfig) -> jnp.ndarray:
    """Per-pixel Halton index offsets, [N] uint32 in [0, 2^20).

    The reference seeds an r32Uint texture host-side with
    ``arc4random() % (1024*1024)`` (RTrace/renderer.swift:96-110) — i.e. a
    random per-pixel decorrelation offset. We keep the same range but derive
    it deterministically from (pixel index, config.seed) so renders are
    reproducible and shard-invariant."""
    idx = jnp.arange(config.num_pixels, dtype=jnp.uint32)
    seeded = smp.hash_u32(idx * jnp.uint32(9781) + jnp.uint32(config.seed) * jnp.uint32(0x9E3779B9))
    return seeded % jnp.uint32(1024 * 1024)


def _chunked(fn, n_pixels: int, chunk: int, *per_pixel_arrays):
    """Run ``fn(chunk_of_each_array) -> [chunk, 3]`` over pixel chunks via
    lax.map, returning [N, 3]. N must divide evenly or the tail is padded."""
    chunk = min(chunk, n_pixels)
    pad = (-n_pixels) % chunk
    padded = [jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in per_pixel_arrays]
    stacked = [a.reshape((-1, chunk) + a.shape[1:]) for a in padded]
    out = jax.lax.map(lambda args: fn(*args), tuple(stacked))
    return out.reshape(-1, 3)[:n_pixels]


# ---------------------------------------------------------------------------
# Variant B: iterative path tracer (pathTrace, raytrace.metal:11-111)
# ---------------------------------------------------------------------------

def _path_trace_chunk(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    px: jnp.ndarray, py: jnp.ndarray, offsets: jnp.ndarray,
) -> jnp.ndarray:
    """One chunk of pixels, all spp, fixed bounce loop. Returns [chunk, 3]."""
    cam = scene.camera
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None

    def one_sample(lum, n):
        # Per-sample jitter: Halton dims 0,1 at index offset+n
        # (raytrace.metal:37-40); stratified jitter grids the same draws
        # over spp cells (BASELINE config 3 sampler).
        i_halton = offsets + n
        if config.sampler == "stratified":
            uv = smp.stratified2(i_halton, 0, config.spp)
        else:
            uv = jnp.stack([smp.halton(i_halton, 0),
                            smp.halton(i_halton, 1)], axis=-1)
        o, d = smp.generate_camera_ray(
            cam.position, cam.direction, cam.up, config.resolution,
            cam.horizontal_fov, px, py, uv, config.integer_aspect,
        )

        color = jnp.ones(o.shape, o.dtype)
        acc = jnp.zeros(o.shape, o.dtype)
        alive = jnp.ones(px.shape, bool)

        for bounce in range(config.bounces):
            h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)
            active = alive & h.hit
            # Emissive hit REPLACES the accumulator and terminates — the
            # reference's `accumulatedColor = emissive; break`
            # (raytrace.metal:57-60), discarding prior NEE sums.
            hit_light = active & h.is_emissive
            acc = jnp.where(hit_light[..., None], h.emissive, acc)
            surf = active & ~h.is_emissive

            normal = h.normal
            # t clamped to 0 on dead lanes: their shading math still executes
            # (fixed-shape masking) and must stay finite so reverse-mode AD
            # doesn't pick up 0 * inf NaNs from overflowed positions.
            t_safe = jnp.where(surf, h.t, 0.0)
            point = o + d * t_safe[..., None] + normal * 1e-3

            # NEE: Halton dims 2 + bounce*5 + {0,1} (raytrace.metal:72-74).
            w = jnp.stack(
                [smp.halton(i_halton, 2 + bounce * 5 + 0),
                 smp.halton(i_halton, 2 + bounce * 5 + 1)], axis=-1)
            lcol, ldir, ldist = smp.sample_area_light(
                light.center, light.color, light.normal, point, w,
                config.area_light_half_extent,
            )
            lcol = lcol * smp.saturate(smp.dot(normal, ldir))[..., None]
            color = jnp.where(surf[..., None], color * h.diffuse, color)

            # Shadow ray: any-hit, max = lightDist - 1e-3, min unset (0)
            # (raytrace.metal:79-85).
            occluded = any_hit(compiled, point, ldir, 0.0, ldist - 1e-3, spheres)
            contrib = jnp.where((surf & ~occluded)[..., None], lcol * color, 0.0)
            acc = acc + contrib

            # Indirect bounce: cosine hemisphere, Halton dims {2,3} of the
            # same block (raytrace.metal:93-100).
            u = jnp.stack(
                [smp.halton(i_halton, 2 + bounce * 5 + 2),
                 smp.halton(i_halton, 2 + bounce * 5 + 3)], axis=-1)
            sdir = smp.align_hemisphere_with_normal(
                smp.cosine_hemisphere_y_up(u), normal)
            o = jnp.where(surf[..., None], point, o)
            d = jnp.where(surf[..., None], sdir, d)
            alive = surf

        return lum + acc, None

    # Scan over samples with rematerialization: without jax.checkpoint the
    # backward pass stores every bounce's [chunk, lanes] intermediates for
    # all spp iterations (~GBs at 512^2/16spp); with it, backward recomputes
    # each sample from the tiny carry (SURVEY.md §7 "Pallas backward at
    # speed-of-light" — same policy applies to the jnp path).
    lum, _ = jax.lax.scan(
        jax.checkpoint(one_sample), _zeros3(px, cam.position.dtype),
        jnp.arange(config.spp, dtype=jnp.uint32))
    return lum / _F32(config.spp)


def render_path(scene: Scene, config: RenderConfig) -> RenderOutput:
    compiled = compile_scene(scene.triangles, config.lane_pad)
    px, py = pixel_coords(config)
    offsets = pixel_rng_offsets(config)
    hdr = _chunked(
        partial(_path_trace_chunk, compiled, scene, config),
        config.num_pixels, config.pixel_chunk, px, py, offsets,
    )
    return RenderOutput(hdr=hdr.reshape(config.height, config.width, 3), ldr=None)


# ---------------------------------------------------------------------------
# Variant A: 3-strategy MIS (shaders.metal:519-707)
# ---------------------------------------------------------------------------

def _mis_sample_tables(config: RenderConfig):
    """The reference's per-sample randoms are *pixel-independent* Halton
    points (haltonRandom(i, d), shaders.metal:557,564,584,595,617) — so they
    are shared tables, precomputed once: [S, 2] each. Built from the shared
    row table (sampling.mis_sample_table_rows) so oracle and kernels agree;
    ``config.sampler`` selects halton (reference) or stratified (BASELINE
    config 3)."""
    rows = smp.mis_sample_table_rows(config.mis_samples, config.sampler)
    pair = lambda r: jnp.stack([rows[r], rows[r + 1]], axis=-1)
    return dict(
        light_u=pair(0),       # strategy 1
        cosine_u=pair(2),      # strategy 2
        cosine_sec_u=pair(4),  # strategy 2 bounce NEE
        vndf_u=pair(6),        # strategy 3
        vndf_sec_u=pair(8),    # strategy 3 bounce NEE
    )


def _direct_light_contribution(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    point, normal, in_dir, diffuse, metallic, roughness,
    u: jnp.ndarray, samples_per_strategy: int, use_power_heuristic: bool,
    active: jnp.ndarray,
):
    """``calculateDirectLightSamplingContribution`` (shaders.metal:519-541):
    sample the full light rectangle, trace toward it, and contribute iff the
    light is reached. Returns [..., 3].

    The reference classifies by closest-hit-is-emissive. We use the
    equivalent *occlusion* formulation — any non-light hit strictly short of
    the sample distance blocks the contribution — because the reference's
    very first Halton sample (halton(0, d) == 0) lands exactly on the light
    rectangle's corner, putting the closest-hit classification on an FP
    knife edge (hit/miss flips with compiler FMA/fusion choices). The two
    formulations agree everywhere except that measure-zero edge set, where
    the reference's own hardware intersector behavior is unspecified; the
    occlusion form is deterministic across jnp/Pallas backends."""
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    origin = point + normal * 1e-4
    ldir, ldist = smp.direct_square_light_sample(
        origin, light.center, light.width, light.depth, light.normal, u)
    pdf_l = smp.square_light_pdf(
        point, light.center, light.width, light.depth, light.normal, ldir)
    # Occluder window stops short of the light plane so the light itself
    # (hit at t ~= ldist) never registers as a blocker.
    occluded = any_hit(compiled, origin, ldir, RAY_TMIN, ldist * (1.0 - 1e-4),
                       spheres)
    hit_light = active & ~occluded
    brdf = brdf_contribution(in_dir, normal, diffuse, metallic, roughness, ldir)
    contrib = brdf * light.emitted_radiance / pdf_l[..., None]
    if use_power_heuristic:
        pdf_c = smp.cosine_pdf(normal, ldir)
        pdf_v = smp.vndf_pdf(-in_dir, normal, ldir, roughness)
        weight = smp.power_heuristic_3(pdf_l, pdf_c, pdf_v,
                                       samples_per_strategy, 1.0)
        contrib = contrib * weight[..., None]
    return jnp.where(hit_light[..., None], contrib, 0.0)


def _bounce_strategy(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    point, normal, in_dir, diffuse, metallic, roughness, active,
    sample_dir: jnp.ndarray, pdf_self: jnp.ndarray, weight: jnp.ndarray,
    sec_u: jnp.ndarray,
):
    """Shared body of the cosine/VNDF strategies (shaders.metal:562-623):
    trace the BSDF-sampled ray; if it hits the light, add the MIS-weighted
    light term; if it hits geometry, do one unweighted NEE at the bounce
    point (the reference's single-level 'recursion')."""
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    origin = point + normal * 1e-4
    h = closest_hit(compiled, origin, sample_dir, RAY_TMIN, RAY_TMAX, spheres)
    brdf = brdf_contribution(in_dir, normal, diffuse, metallic, roughness,
                             sample_dir)
    # Double-where reciprocal: the VNDF pdf is EXACTLY 0 on roughness-0
    # lanes (d_ggx's numerator is a^2), and 1/0 = inf there turns the
    # MIS-weighted product into 0 * inf = NaN — gated out of the primal
    # image but poisoning every gradient that flows through the product
    # (found by an accelerator gradient-parity run; the reference's per-thread
    # control flow never evaluates these lanes at all). pdf == 0 always
    # implies weight == 0, so the term is 0 by the estimator's 0*(x/0):=0
    # convention — inv_pdf := 0 realizes exactly that.
    pdf_ok = pdf_self > 0.0
    inv_pdf = jnp.where(pdf_ok, 1.0 / jnp.where(pdf_ok, pdf_self, 1.0),
                        0.0)[..., None]

    hit_light = active & h.hit & h.is_emissive
    light_term = weight[..., None] * brdf * light.emitted_radiance * inv_pdf

    hit_geo = active & h.hit & ~h.is_emissive
    bounce_point = origin + sample_dir * jnp.where(hit_geo, h.t, 0.0)[..., None]
    sec = _direct_light_contribution(
        compiled, scene, config, bounce_point, h.normal, sample_dir,
        h.diffuse, h.metallic, h.roughness, sec_u, 1, False, hit_geo,
    )
    geo_term = brdf * inv_pdf * sec
    return (jnp.where(hit_light[..., None], light_term, 0.0)
            + jnp.where(hit_geo[..., None], geo_term, 0.0))


def _mis_chunk(
    compiled: CompiledScene, scene: Scene, config: RenderConfig,
    tables: dict, px: jnp.ndarray, py: jnp.ndarray,
) -> jnp.ndarray:
    """One chunk of pixels through the full variant-A pipeline. Returns
    [chunk, 3] of raw accumulated color (pre exposure/tonemap) — the
    reference's debug/text-buffer value (shaders.metal:705)."""
    cam = scene.camera
    light = scene.light
    spheres = scene.spheres if scene.spheres.num_spheres > 0 else None
    s_per = config.mis_samples // 3

    accumulated = jnp.zeros(px.shape + (3,), cam.position.dtype)
    for i in range(config.camera_rays):
        jitter = smp.hash_random_2d(px, py, jnp.uint32(i))
        o, d = smp.generate_camera_ray(
            cam.position, cam.direction, cam.up, config.resolution,
            cam.horizontal_fov, px, py, jitter, config.integer_aspect,
        )
        h = closest_hit(compiled, o, d, RAY_TMIN, RAY_TMAX, spheres)
        # Camera ray hit the light directly: add emittedRadiance
        # (shaders.metal:667-671).
        cam_hit_light = h.hit & h.is_emissive
        accumulated = accumulated + jnp.where(
            cam_hit_light[..., None], light.emitted_radiance, 0.0)

        surf = h.hit & ~h.is_emissive
        # NOT normal-offset (shaders.metal:497); t clamped on dead lanes.
        point = o + d * jnp.where(surf, h.t, 0.0)[..., None]
        args = (point, h.normal, d, h.diffuse, h.metallic, h.roughness)

        def strategies(carry, per_sample):
            lu, cu, csu, vu, vsu = per_sample
            lu, cu, csu, vu, vsu = (jnp.broadcast_to(x, px.shape + (2,))
                                    for x in (lu, cu, csu, vu, vsu))
            point, normal, in_dir, diffuse, metallic, roughness = args
            # Strategy 1: light sampling (shaders.metal:553-560).
            direct = _direct_light_contribution(
                compiled, scene, config, *args, lu, s_per, True, surf)
            # Strategy 2: cosine (shaders.metal:562-591).
            cdir = smp.cosine_weighted_dir(normal, cu)
            pdf_c = smp.cosine_pdf(normal, cdir)
            pdf_l = smp.square_light_pdf(
                point, light.center, light.width, light.depth,
                light.normal, cdir)
            pdf_v = smp.vndf_pdf(-in_dir, normal, cdir, roughness)
            w_c = smp.power_heuristic_3(pdf_c, pdf_l, pdf_v, s_per, 1.0)
            cosine = _bounce_strategy(
                compiled, scene, config, *args, surf, cdir, pdf_c, w_c, csu)
            # Strategy 3: VNDF (shaders.metal:593-623).
            vdir = smp.vndf_dir(-in_dir, normal, roughness, vu)
            pdf_v2 = smp.vndf_pdf(-in_dir, normal, vdir, roughness)
            pdf_l2 = smp.square_light_pdf(
                point, light.center, light.width, light.depth,
                light.normal, vdir)
            pdf_c2 = smp.cosine_pdf(normal, vdir)
            w_v = smp.power_heuristic_3(pdf_v2, pdf_l2, pdf_c2, s_per, 1.0)
            vndf = _bounce_strategy(
                compiled, scene, config, *args, surf, vdir, pdf_v2, w_v, vsu)
            return carry + direct + cosine + vndf, None

        per_sample = (tables["light_u"], tables["cosine_u"],
                      tables["cosine_sec_u"], tables["vndf_u"],
                      tables["vndf_sec_u"])
        mis_sum, _ = jax.lax.scan(jax.checkpoint(strategies),
                                  _zeros3(px, cam.position.dtype), per_sample)
        sampled = mis_sum / _F32(s_per)
        accumulated = accumulated + jnp.where(surf[..., None], sampled, 0.0)

    return accumulated


def camera_exposure(ev100) -> jnp.ndarray:
    """1 / (1.2 * 2^ev100) (shaders.metal:145-150)."""
    return 1.0 / (1.2 * jnp.power(2.0, ev100))


def reinhard(color: jnp.ndarray) -> jnp.ndarray:
    """Reinhard + clamp, no gamma (shaders.metal:152-157)."""
    return jnp.clip(color / (color + 1.0), 0.0, 1.0)


def tonemap_mis(accumulated: jnp.ndarray, camera_rays: int, ev100) -> jnp.ndarray:
    """Variant-A in-kernel post: mean over camera rays, exposure, Reinhard,
    gamma 2.2 (shaders.metal:688-703)."""
    exposed = accumulated / _F32(camera_rays) * camera_exposure(ev100)
    tone = reinhard(exposed)
    return jnp.power(tone, 1.0 / 2.2)


def render_mis(scene: Scene, config: RenderConfig) -> RenderOutput:
    compiled = compile_scene(scene.triangles, config.lane_pad)
    tables = _mis_sample_tables(config)
    px, py = pixel_coords(config)
    acc = _chunked(
        partial(_mis_chunk, compiled, scene, config, tables),
        config.num_pixels, config.pixel_chunk, px, py,
    )
    acc = acc.reshape(config.height, config.width, 3)
    ldr = tonemap_mis(acc, config.camera_rays, scene.camera.ev100)
    return RenderOutput(hdr=acc, ldr=ldr)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def render(scene: Scene, config: RenderConfig) -> RenderOutput:
    """Render with the configured integrator. jit-compatible: ``config`` is
    static, ``scene`` is a pytree of arrays."""
    if config.integrator == "path":
        return render_path(scene, config)
    if config.integrator == "direct":
        return render_path(scene, config.replace(bounces=1))
    if config.integrator == "mis":
        return render_mis(scene, config)
    if config.integrator == "legacy":
        from .render_legacy import render_legacy
        return render_legacy(scene, config)
    raise ValueError(f"unknown integrator: {config.integrator!r}")


render_jit = jax.jit(render, static_argnums=(1,))

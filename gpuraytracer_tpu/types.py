"""Core pytree types for the path tracer.

Struct-of-arrays scene representation with fixed dtypes. This is the JAX
equivalent of the reference's host<->device ABI structs
(/root/reference/RTrace/shaderTypes.h:13-96): instead of an array-of-structs
marshalled into Metal buffers, every field is a dense jnp array so the whole
scene is a pytree that can be jitted over, differentiated through, replicated
across a device mesh, and fed to Pallas kernels.

All geometry/shading math is float32; images accumulate in float32 end-to-end
and are quantized to uint8 only at the PNG boundary (image.py). The
reference's rgba16Float intermediate render target
(/root/reference/RTrace/renderer.swift:74-82) has no analog here — its
precision loss was a GPU-texture-format constraint, not a feature, so this
framework keeps the HDR buffer at full f32 (strictly more precision at
the same uint8 output).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls):
    """Register a frozen dataclass as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, name) for name in fields), None

    def flatten_with_keys(obj):
        return (
            tuple((jax.tree_util.GetAttrKey(n), getattr(obj, n)) for n in fields),
            None,
        )

    def unflatten(_, children):
        return cls(**dict(zip(fields, children)))

    jax.tree_util.register_pytree_with_keys(
        cls, flatten_with_keys, unflatten, flatten)
    return cls


@_pytree_dataclass
class Camera:
    """Pinhole camera (reference: Camera struct, RTrace/scene.swift:290-301)."""

    position: jnp.ndarray  # [3] f32
    direction: jnp.ndarray  # [3] f32, normalized
    up: jnp.ndarray  # [3] f32
    resolution: jnp.ndarray  # [2] i32 (width, height)
    horizontal_fov: jnp.ndarray  # scalar f32, radians
    ev100: jnp.ndarray  # scalar f32


@_pytree_dataclass
class SquareLight:
    """Rectangular area light (reference: SquareLightGPU, shaderTypes.h:56-62).

    ``color`` is the light material's diffuse rgb (used by the variant-B
    ``sampleAreaLight``, RTrace/sampling.metal:226) while ``emitted_radiance``
    is the photometric luminance (used by the variant-A MIS integrator,
    Sources/gpuRaytracer/shaders.metal:535). The reference hardcodes the
    light's frame inside its samplers; we store it explicitly.
    """

    center: jnp.ndarray  # [3] f32
    color: jnp.ndarray  # [3] f32  (material diffuse rgb)
    emitted_radiance: jnp.ndarray  # [3] f32 (photometric cd/m^2)
    width: jnp.ndarray  # scalar f32
    depth: jnp.ndarray  # scalar f32
    normal: jnp.ndarray  # [3] f32 (reference hardcodes (0,-1,0))


@_pytree_dataclass
class TriangleScene:
    """SoA triangle soup + per-triangle materials.

    Reference equivalent: ``[Triangle]`` marshalled to vertex+material buffers
    (RTrace/computeShader.swift:13-31). ``verts[t, k, :]`` is vertex k of
    triangle t; material fields are indexed by primitive id exactly like
    ``materials[intersection.primitive_id]`` (RTrace/raytrace.metal:55).
    """

    verts: jnp.ndarray  # [T, 3, 3] f32
    diffuse: jnp.ndarray  # [T, 3] f32
    metallic: jnp.ndarray  # [T] f32
    roughness: jnp.ndarray  # [T] f32
    emissive: jnp.ndarray  # [T, 3] f32

    @property
    def num_triangles(self) -> int:
        return self.verts.shape[0]


@_pytree_dataclass
class Spheres:
    """SoA spheres (reference: SphereGPU, shaderTypes.h:25-29; intersected by
    the legacy analytic kernel, shaders_old.metal:108-136). First-class here
    because sphere geometry is the differentiable-geometry workload
    (inverse rendering recovers sphere centers)."""

    center: jnp.ndarray  # [S, 3] f32
    radius: jnp.ndarray  # [S] f32
    diffuse: jnp.ndarray  # [S, 3] f32
    metallic: jnp.ndarray  # [S] f32
    roughness: jnp.ndarray  # [S] f32
    emissive: jnp.ndarray  # [S, 3] f32

    @property
    def num_spheres(self) -> int:
        return self.center.shape[0]


@_pytree_dataclass
class SphereLights:
    """SoA sphere lights (reference: SphereLightGPU, shaderTypes.h:40-45;
    sampled by visible-cone sampling in the legacy kernel,
    shaders_old.metal:406-451, and hit-tested analytically by
    ``intersectLight``, shaders_old.metal:138-170)."""

    center: jnp.ndarray  # [L, 3] f32
    radius: jnp.ndarray  # [L] f32
    color: jnp.ndarray  # [L, 3] f32 (material diffuse rgb)
    emitted_radiance: jnp.ndarray  # [L, 3] f32

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]


@_pytree_dataclass
class BoxLights:
    """SoA axis-aligned box lights (reference: BoxLightGPU,
    shaderTypes.h:47-54; area-weighted 6-face sampling at
    shaders_old.metal:292-404, slab-test pdf at :625-676)."""

    center: jnp.ndarray  # [L, 3] f32
    width: jnp.ndarray  # [L] f32 (x extent)
    height: jnp.ndarray  # [L] f32 (y extent)
    depth: jnp.ndarray  # [L] f32 (z extent)
    color: jnp.ndarray  # [L, 3] f32
    emitted_radiance: jnp.ndarray  # [L, 3] f32

    @property
    def num_lights(self) -> int:
        return self.center.shape[0]


@_pytree_dataclass
class Scene:
    """Full scene: camera + primary light + geometry (RTrace/scene.swift:8-12),
    extended with the legacy tier's sphere geometry and sphere/box lights
    (shaders_old.metal scene model: spheres + sphere lights, with box lights
    as the alternate NEE target)."""

    camera: Camera
    light: SquareLight
    triangles: TriangleScene
    spheres: Spheres  # may be empty (S == 0)
    sphere_lights: SphereLights  # may be empty (L == 0)
    box_lights: BoxLights  # may be empty (L == 0)


@_pytree_dataclass
class CompiledScene:
    """Intersection-ready scene: per-triangle plane + barycentric projectors,
    padded to a multiple of ``lane_pad``.

    This is the oracle's replacement for the driver-built BVH
    (``setupAccelerationStructures``, RTrace/computeShader.swift:45-97): at
    reference scene sizes (34 triangles) a brute-force vectorized
    intersection over all triangles needs no traversal structure, so
    "compiling" a scene means precomputing, for each triangle:

      n       geometric normal (normalized cross(e1,e2))
      c0      dot(n, v0)                    -> t = (c0 - o.n) / (d.n)
      s1, s2  dual basis of (e1, e2)        -> u = (h - v0).s1, v = (h - v0).s2
      c1, c2  dot(v0, s1), dot(v0, s2)

    so a ray-triangle test is 6 broadcasted dot products + elementwise math
    on [rays, T] tiles — pure VPU work with T padded to the 128-lane width.
    """

    # Padded triangle data, [P >= T] where P is a multiple of the lane width.
    n: jnp.ndarray  # [P, 3] f32 normalized geometric normal
    c0: jnp.ndarray  # [P] f32
    s1: jnp.ndarray  # [P, 3] f32
    s2: jnp.ndarray  # [P, 3] f32
    c1: jnp.ndarray  # [P] f32
    c2: jnp.ndarray  # [P] f32
    valid: jnp.ndarray  # [P] bool (False for padding)
    # Shading data, padded identically.
    diffuse: jnp.ndarray  # [P, 3] f32
    metallic: jnp.ndarray  # [P] f32
    roughness: jnp.ndarray  # [P] f32
    emissive: jnp.ndarray  # [P, 3] f32
    is_emissive: jnp.ndarray  # [P] bool (length(emissive) > 0)

    @property
    def padded_size(self) -> int:
        return self.n.shape[0]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration. Hashable; passed as a static jit arg.

    The reference hardcodes all of these (spp=400/bounces=3 in
    RTrace/raytrace.metal:24-25; camera_rays=6/mis_samples=300/bounces=2 in
    Sources/gpuRaytracer/shaders.metal:644-649; resolution 800x600 in
    scene.swift:18). Here they are one frozen config so every BASELINE
    workload is expressible without editing kernels.

    Compat flags replicate reference quirks bit-for-bit (SURVEY.md §7):
      integer_aspect      aspect = float(resx // resy)  (sampling.metal:132)
      area_light_half_extent  hardcoded 0.25 half-extents in sampleAreaLight
                              (sampling.metal:208-213) regardless of the
                              scene's actual 1x1 light.
    """

    width: int = 800
    height: int = 600
    integrator: str = "path"  # "path" (variant B) | "mis" (variant A) | "direct"
    spp: int = 400  # variant B samples per pixel
    bounces: int = 3  # variant B bounce count
    camera_rays: int = 6  # variant A camera rays per pixel
    mis_samples: int = 300  # variant A total MIS samples (split across 3 strategies)
    # (The variant-A bounce structure — one extra NEE at the BSDF-strategy
    # hit — is fixed by the reference, shaders.metal:543-625; there is
    # deliberately no knob for it.)
    # Legacy integrator (shaders_old.metal calculateLighting, :738-921):
    # total samples split /3 across strategies; nested bounce recursion uses
    # legacy_bounce_samples (the reference hardcodes 30, :837,:911).
    legacy_samples: int = 30
    legacy_bounces: int = 2
    legacy_bounce_samples: int = 30
    # Sample-sequence choice: "halton" replicates the reference's
    # low-discrepancy draws; "stratified" jitter-grids the path tracer's
    # camera subpixel samples (over spp cells) and the MIS integrator's
    # strategy tables (over samples/strategy cells) — BASELINE config 3.
    # Square sample counts required for "stratified".
    sampler: str = "halton"
    seed: int = 0
    # Compat flags (reference quirks, on by default so the oracle matches).
    integer_aspect: bool = True
    area_light_half_extent: float = 0.25
    # Performance knobs.
    lane_pad: int = 128  # pad triangle axis to a multiple of this
    pixel_chunk: int = 16384  # pixels per lax.map step in the jnp reference path
    replay_sample_chunk: int = 16  # samples vectorized per decoupled-replay step

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def empty_spheres() -> Spheres:
    """Host-side empty sphere set (numpy leaves transfer lazily at jit entry)."""
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return Spheres(center=z3, radius=z1, diffuse=z3, metallic=z1, roughness=z1,
                   emissive=z3)


def empty_sphere_lights() -> SphereLights:
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return SphereLights(center=z3, radius=z1, color=z3, emitted_radiance=z3)


def empty_box_lights() -> BoxLights:
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return BoxLights(center=z3, width=z1, height=z1, depth=z1, color=z3,
                     emitted_radiance=z3)


def as_f32(x: Any) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


def vec3(x: float, y: float, z: float) -> jnp.ndarray:
    return jnp.array([x, y, z], dtype=jnp.float32)


def normalize(v: jnp.ndarray, axis: int = -1, eps: float = 0.0) -> jnp.ndarray:
    """Normalize along an axis. eps guards degenerate vectors when > 0."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n

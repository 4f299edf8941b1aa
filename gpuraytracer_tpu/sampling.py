"""Low-discrepancy sampling, PRNG, samplers and PDFs.

Pure-jnp re-implementations of the reference's device sampling library:
  - RTrace/sampling.metal (hash PRNG, Halton, camera rays, light sampling)
  - Sources/gpuRaytracer/shaders.metal:22-516 (Halton/Hammersley, MIS
    heuristics, cosine/VNDF samplers and PDFs)

Every function is vectorized over arbitrary leading batch dimensions; vectors
use a trailing axis of size 3. All randomness is a pure function of
(pixel, sample, bounce, dimension) — never of device id — which is what makes
sharded rendering bit-identical to single-device rendering (SURVEY.md §7).
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

# Prime bases for the Halton sequence (sampling.metal:97-104).
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37,
          41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89)

_U32 = jnp.uint32
_F32 = jnp.float32
INV_2_32 = float(1.0 / 4294967296.0)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector dot over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    # 1e-12 floor (not 1e-30): rsqrt's VJP is -0.5 u^-1.5, which OVERFLOWS
    # f32 at u = 1e-30 (1e45 -> inf, and 0 * inf = NaN on masked lanes in
    # reverse mode). At 1e-12 the VJP stays finite; live vectors have
    # |v|^2 >= ~1e-8, so values are identical. Kernels use the same floor
    # (pallas_path._normalize3) — oracle/kernel parity.
    return v * jax.lax.rsqrt(jnp.maximum(dot(v, v), 1e-12))[..., None]


def saturate(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Hash PRNG (xorshift-multiply; sampling.metal:68-79, shaders.metal:58-69)
# ---------------------------------------------------------------------------

def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(_U32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def random_float(seed: jnp.ndarray) -> jnp.ndarray:
    """hash(seed) / 2^32 in f32 (sampling.metal:77-79: the divisor
    float(0xffffffffU) + 1.0 rounds to exactly 2^32)."""
    return hash_u32(seed).astype(_F32) * _F32(INV_2_32)


def hash_random_2d(x: jnp.ndarray, y: jnp.ndarray, i,
                   stride_x: int = 800, stride_y: int = 600) -> jnp.ndarray:
    """Variant-A per-pixel jitter, ``hashRandom`` (shaders.metal:71-85).
    The strides are the literal 800/600 baked into the reference kernel —
    kept as defaults regardless of actual resolution for oracle parity.
    Returns [..., 2] in [0, 1)."""
    x = jnp.asarray(x).astype(_U32)
    y = jnp.asarray(y).astype(_U32)
    i = jnp.asarray(i).astype(_U32)
    sample_id = (y * _U32(stride_x) + x) * i
    seed1 = hash_u32(x + y * _U32(stride_x) + sample_id)
    seed2 = hash_u32(y + x * _U32(stride_y) + sample_id + _U32(12345))
    u1 = seed1.astype(_F32) * _F32(INV_2_32)
    u2 = seed2.astype(_F32) * _F32(INV_2_32)
    return jnp.stack([u1, u2], axis=-1)


def hash_random_3d(index_xyz: Tuple, i) -> jnp.ndarray:
    """``hashRandom3D`` (sampling.metal:81-95). Unused by the active kernels
    but part of the library surface."""
    ix, iy, iz = (jnp.asarray(v).astype(_U32) for v in index_xyz)
    i = jnp.asarray(i).astype(_U32)
    sample_id = (iz * _U32(1013) + iy * _U32(809) + ix) * i
    seed1 = ix + iy * _U32(809) + iz * _U32(929) + sample_id
    seed2 = iz + ix * _U32(613) + iy * _U32(743) + sample_id + _U32(12345)
    return jnp.stack([random_float(seed1), random_float(seed2)], axis=-1)


# ---------------------------------------------------------------------------
# Halton / radical inverse / Hammersley
# ---------------------------------------------------------------------------

def _halton_digits(base: int) -> int:
    """Digits needed to exhaust a uint32 index in the given base."""
    return int(math.ceil(32.0 / math.log2(base)))


def halton(i: jnp.ndarray, d: int) -> jnp.ndarray:
    """Radical inverse of index ``i`` in base PRIMES[d]
    (sampling.metal:107-122). ``d`` is static; the data-dependent ``while
    i > 0`` becomes a fixed digit-count loop (extra iterations are no-ops:
    once i == 0 every digit contributes 0)."""
    b = PRIMES[d]
    i = jnp.asarray(i).astype(_U32)
    inv_b = _F32(1.0 / b)

    def body(_, carry):
        f, r, i = carry
        f = f * inv_b
        r = r + f * (i % _U32(b)).astype(_F32)
        return f, r, i // _U32(b)

    # Derive the initial carry from ``i`` so its device-varying status matches
    # the loop body's outputs under shard_map manual axes.
    r0 = i.astype(_F32) * 0.0
    f0 = r0 + 1.0
    _, r, _ = jax.lax.fori_loop(0, _halton_digits(b), body, (f0, r0, i),
                                unroll=True)
    return r


def halton2(i: jnp.ndarray, d: int) -> jnp.ndarray:
    """``haltonRandom``: adjacent-dimension pair (shaders.metal:49-56).
    Returns [..., 2]."""
    return jnp.stack([halton(i, d), halton(i, d + 1)], axis=-1)


def stratified2(i: jnp.ndarray, d: int, n_total: int) -> jnp.ndarray:
    """Stratified (jittered-grid) 2-D points: the unit square is split into
    sqrt(n) x sqrt(n) cells; sample ``i`` lands in cell ``i % n`` jittered by
    the Halton pair at dims (d, d+1). Returns [..., 2].

    The reference has no stratified sampler (BASELINE config 3 mandates
    one); this is the standard jittered grid, kept deterministic and
    pixel-offsettable exactly like ``halton`` so sharded rendering stays a
    pure function of the global sample index. ``n_total`` must be a perfect
    square."""
    k = int(round(math.sqrt(n_total)))
    if k * k != n_total:
        raise ValueError(f"stratified2 needs a square sample count, "
                         f"got {n_total}")
    i = jnp.asarray(i).astype(_U32)
    cell = (i % _U32(n_total)).astype(jnp.int32)
    cx = (cell % k).astype(_F32)
    cy = (cell // k).astype(_F32)
    inv_k = _F32(1.0 / k)
    ux = halton(i, d)
    uy = halton(i, d + 1)
    return jnp.stack([(cx + ux) * inv_k, (cy + uy) * inv_k], axis=-1)


def mis_sample_table_rows(mis_samples: int,
                          sampler: str = "halton") -> jnp.ndarray:
    """The MIS integrator's pixel-independent per-sample random table,
    [10, S] rows in kernel order: light (u0, u1), cosine, cosine-secondary,
    VNDF, VNDF-secondary. Shared by the jnp oracle
    (render._mis_sample_tables), the forward megakernel
    (ops/pallas_mis._pack_inputs) and the backward kernel
    (ops/pallas_mis_bwd) so the three can never drift.

    ``sampler``: "halton" replicates the reference's haltonRandom draws
    (shaders.metal:557,564,584,595,617); "stratified" jitter-grids the same
    index/dim layout (BASELINE config 3 — requires a square samples/strategy
    count)."""
    s = mis_samples // 3
    i = jnp.arange(s, dtype=_U32)
    pair = {"halton": halton2,
            "stratified": lambda idx, d: stratified2(idx, d, s)}[sampler]
    rows = [
        pair(i, 0),                     # light
        pair(i + _U32(s), 2),           # cosine
        pair(i, 6),                     # cosine secondary NEE
        pair(i + _U32(2 * s), 4),       # vndf
        pair(i + _U32(s), 6),           # vndf secondary NEE
    ]
    return jnp.concatenate([r.T for r in rows], axis=0)  # [10, S]


def shift_random_points(u: jnp.ndarray) -> jnp.ndarray:
    """Toroidal doubling shift: 2u mod 1 per component
    (shiftRandomPoints, shaders.metal:87-98 — unused by the reference's
    active kernels; implemented for library parity). ``u`` is [..., 2]."""
    r = jnp.asarray(u, _F32) * 2.0
    return jnp.where(r >= 1.0, r - 1.0, r)


def radical_inverse_2(bits: jnp.ndarray) -> jnp.ndarray:
    """Base-2 Van der Corput via bit reversal (shaders.metal:101-108)."""
    b = jnp.asarray(bits).astype(_U32)
    b = (b << 16) | (b >> 16)
    b = ((b & _U32(0x55555555)) << 1) | ((b & _U32(0xAAAAAAAA)) >> 1)
    b = ((b & _U32(0x33333333)) << 2) | ((b & _U32(0xCCCCCCCC)) >> 2)
    b = ((b & _U32(0x0F0F0F0F)) << 4) | ((b & _U32(0xF0F0F0F0)) >> 4)
    b = ((b & _U32(0x00FF00FF)) << 8) | ((b & _U32(0xFF00FF00)) >> 8)
    return b.astype(_F32) * _F32(2.3283064365386963e-10)


def hammersley_2d(i: jnp.ndarray, n: int) -> jnp.ndarray:
    """(i/N, radicalInverse2(i)) (shaders.metal:113-115). Returns [..., 2]."""
    i = jnp.asarray(i)
    return jnp.stack(
        [i.astype(_F32) / _F32(n), radical_inverse_2(i)], axis=-1
    )


def hammersley_float(index: jnp.ndarray, dimension: int, total: int) -> jnp.ndarray:
    """Scrambled radical inverse for dims >= 2 (shaders.metal:119-129).
    ``dimension`` is static."""
    index = jnp.asarray(index)
    if dimension == 0:
        return index.astype(_F32) / _F32(total)
    if dimension == 1:
        return radical_inverse_2(index)
    scrambled = hash_u32(index.astype(_U32) + _U32(dimension * 12345))
    return radical_inverse_2(scrambled)


def next_power_of_two(n: int) -> int:
    """Host-side helper (shaders.metal:174-184)."""
    return 1 if n == 0 else 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# MIS heuristics (shaders.metal:131-142, 511-516)
# ---------------------------------------------------------------------------

def power_heuristic_3(pdf1, pdf2, pdf3, samples_per_strategy, beta=1.0):
    """3-strategy power heuristic with per-strategy sample count
    (shaders.metal:132-137). The reference defines beta=2.0 as default but
    every call site passes 1.0 (shaders.metal:534,574,606).

    beta == 1 skips ``jnp.power`` entirely (value-identical: x^1 = x):
    power's VJP is beta*x^(beta-1), and x^0 can lower to exp(0 * log(x))
    on an accelerator — NaN at x = 0, which cosine_pdf produces on every
    backfacing lane (the CPU constant-folds the pow away)."""
    n = _F32(samples_per_strategy)
    if isinstance(beta, (int, float)) and float(beta) == 1.0:
        p1 = n * pdf1
        s = p1 + n * pdf2 + n * pdf3
    else:
        p1 = jnp.power(n * pdf1, beta)
        s = p1 + jnp.power(n * pdf2, beta) + jnp.power(n * pdf3, beta)
    return p1 / (s + 1e-6)


def power_heuristic_2(pdf1, pdf2, beta=2.0):
    """(shaders.metal:140-142)."""
    a = jnp.power(pdf1, beta)
    return a / (a + jnp.power(pdf2, beta) + 1e-6)


def balanced_heuristic_3(pdf1, pdf2, pdf3):
    """(shaders.metal:511-516)."""
    w = pdf1 / (pdf1 + pdf2 + pdf3)
    return jnp.where(pdf1 == 0.0, 0.0, w)


# ---------------------------------------------------------------------------
# Camera (generateCameraRay; sampling.metal:125-157, shaders.metal:214-246)
# ---------------------------------------------------------------------------

RAY_TMIN = 1e-3
RAY_TMAX = 1e3


def camera_basis(direction: jnp.ndarray, up: jnp.ndarray):
    w = -normalize(direction)
    u = normalize(cross(up, w))
    v = normalize(cross(w, u))
    return u, v, w


def generate_camera_ray(
    position: jnp.ndarray, direction: jnp.ndarray, up: jnp.ndarray,
    resolution: Tuple[int, int], horizontal_fov,
    px: jnp.ndarray, py: jnp.ndarray, jitter: jnp.ndarray,
    integer_aspect: bool = True,
):
    """Pinhole camera ray for pixel (px, py) with subpixel jitter [..., 2].

    ``integer_aspect`` replicates ``float(camera.resolution.x /
    camera.resolution.y)`` — integer division, so 800x600 gives aspect 1.0,
    not 1.333 (sampling.metal:132). Returns (origin[...,3], dir[...,3])."""
    res_x, res_y = resolution
    aspect = float(res_x // res_y) if integer_aspect else res_x / res_y
    half_width = jnp.tan(horizontal_fov / 2.0)
    half_height = half_width / aspect
    u, v, w = camera_basis(direction, up)

    s = ((px.astype(_F32) + jitter[..., 0]) / _F32(res_x)) * 2.0 - 1.0
    t = -(((py.astype(_F32) + jitter[..., 1]) / _F32(res_y)) * 2.0 - 1.0)
    d = normalize(
        s[..., None] * (half_width * u) + t[..., None] * (half_height * v) - w
    )
    origin = jnp.broadcast_to(position, d.shape)
    return origin, d


# ---------------------------------------------------------------------------
# Bases and hemisphere samplers
# ---------------------------------------------------------------------------

def align_hemisphere_with_normal(sample: jnp.ndarray, normal: jnp.ndarray):
    """Variant-B fixed-axis basis (sampling.metal:51-66): up = n, right =
    normalize(cross(n, (0.0072, 1, 0.0034))), forward = cross(right, up)."""
    up = normal
    axis = jnp.array([0.0072, 1.0, 0.0034], _F32)
    right = normalize(cross(normal, jnp.broadcast_to(axis, normal.shape)))
    forward = cross(right, up)
    return (sample[..., 0:1] * right + sample[..., 1:2] * up
            + sample[..., 2:3] * forward)


def build_orthonormal_basis(normal: jnp.ndarray):
    """Branching basis (sampling.metal:159-172): reference picks (0,1,0) when
    |n.x| > 0.9 else (1,0,0), then Gram-Schmidts. Returns (tangent, bitangent)."""
    ex = jnp.array([1.0, 0.0, 0.0], _F32)
    ey = jnp.array([0.0, 1.0, 0.0], _F32)
    a = jnp.where((jnp.abs(normal[..., 0]) > 0.9)[..., None], ey, ex)
    tangent = normalize(a - dot(a, normal)[..., None] * normal)
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def cosine_hemisphere_y_up(u: jnp.ndarray) -> jnp.ndarray:
    """Variant-B cosine sample in y-up local frame (sampling.metal:39-49)."""
    phi = 2.0 * math.pi * u[..., 0]
    cos_theta = jnp.sqrt(u[..., 1])
    sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
    return jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )


def cosine_weighted_dir(normal: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Variant-A cosine sample about ``normal`` via the branching basis
    (cosineWeightedRay, shaders.metal:355-374)."""
    phi = 2.0 * math.pi * u[..., 0]
    cos_theta = jnp.sqrt(u[..., 1])
    sin_theta = jnp.sqrt(1.0 - u[..., 1])
    tangent, bitangent = build_orthonormal_basis(normal)
    return normalize(
        tangent * (jnp.cos(phi) * sin_theta)[..., None]
        + bitangent * (jnp.sin(phi) * sin_theta)[..., None]
        + normal * cos_theta[..., None]
    )


def cosine_pdf(normal: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """cos(theta)/pi (shaders.metal:376-380)."""
    return jnp.maximum(0.0, dot(normal, direction)) / math.pi


def uniform_hemisphere_dir(normal: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Uniform hemisphere about ``normal`` (legacy sampleUniformHemisphere,
    shaders_old.metal:454-481). pdf = 1/(2 pi)."""
    cos_theta = u[..., 0]
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * math.pi * u[..., 1]
    tangent, bitangent = build_orthonormal_basis(normal)
    return normalize(
        tangent * (jnp.cos(phi) * sin_theta)[..., None]
        + bitangent * (jnp.sin(phi) * sin_theta)[..., None]
        + normal * cos_theta[..., None]
    )


# ---------------------------------------------------------------------------
# Area-light sampling
# ---------------------------------------------------------------------------

def sample_area_light(
    light_center: jnp.ndarray, light_color: jnp.ndarray,
    light_normal: jnp.ndarray, position: jnp.ndarray, u: jnp.ndarray,
    half_extent: float = 0.25,
):
    """Variant-B ``sampleAreaLight`` (sampling.metal:198-236).

    The reference hardcodes right=(0.25,0,0), up=(0,0,0.25) — a 0.5x0.5
    sampling rect even though the scene light is 1x1; ``half_extent`` keeps
    that quirk configurable (SURVEY.md §7 compat flags). Returns
    (light_color_falloff[...,3], light_dir[...,3], light_dist[...])."""
    uu = u * 2.0 - 1.0
    right = jnp.array([1.0, 0.0, 0.0], _F32) * _F32(half_extent)
    up = jnp.array([0.0, 0.0, 1.0], _F32) * _F32(half_extent)
    sample_pos = light_center + right * uu[..., 0:1] + up * uu[..., 1:2]
    to_light = sample_pos - position
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 0.0))
    inv_dist = 1.0 / jnp.maximum(dist, 1e-3)
    direction = to_light * inv_dist[..., None]
    color = light_color * (inv_dist * inv_dist)[..., None]
    color = color * saturate(dot(-direction, light_normal))[..., None]
    return color, direction, dist


def direct_square_light_sample(
    origin: jnp.ndarray, light_center: jnp.ndarray, light_width, light_depth,
    light_normal: jnp.ndarray, u: jnp.ndarray,
):
    """Variant-A ``directSquareLightRay`` (shaders.metal:291-313): uniform
    point on the full rectangle via the branching basis of the light normal.
    Returns (direction[...,3], distance[...])."""
    tangent, bitangent = build_orthonormal_basis(
        jnp.broadcast_to(light_normal, origin.shape)
    )
    x = (u[..., 0] - 0.5) * light_width
    y = (u[..., 1] - 0.5) * light_depth
    sample_pos = light_center + tangent * x[..., None] + bitangent * y[..., None]
    to_light = sample_pos - origin
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
    return to_light / dist[..., None], dist


def square_light_pdf(
    origin: jnp.ndarray, light_center: jnp.ndarray, light_width, light_depth,
    light_normal: jnp.ndarray, direction: jnp.ndarray,
):
    """Area-light pdf measured to the light *center*, not the actual hit point
    — a deliberate reference quirk (calculateSquareLightPdf,
    shaders.metal:315-326)."""
    to_light = light_center - origin
    dist2 = dot(to_light, to_light)
    cos_theta = jnp.maximum(0.0, dot(-direction, light_normal))
    area = light_width * light_depth
    return dist2 / (area * cos_theta + 1e-6)


# ---------------------------------------------------------------------------
# GGX / VNDF (shaders.metal:186-208, 382-445)
# ---------------------------------------------------------------------------

def smith_g1_ggx(n_dot_v: jnp.ndarray, roughness: jnp.ndarray) -> jnp.ndarray:
    a = roughness * roughness
    a2 = a * a
    # nv2 floor: AD-safety guard (value-identical away from exact grazing;
    # without it reverse mode picks up inf/0*inf on lanes where n.v == 0 —
    # masked lanes with the light material's roughness 0 hit this).
    nv2 = jnp.maximum(n_dot_v * n_dot_v, 1e-12)
    return 2.0 / (1.0 + jnp.sqrt(1.0 + a2 * (1.0 - nv2) / nv2))


def d_ggx(n_dot_h: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """GGX NDF. NOTE: the reference passes *roughness* (not roughness^2) as
    ``a`` at every call site (shaders.metal:273,442) — replicated.
    The +1e-12 keeps 0/0 (a == 0 with n.h == 1, reachable only on masked
    lanes) finite in primal AND reverse: the division's VJP squares the
    denominator, so a 1e-20 guard underflows to 0 there (inf, then
    0 * inf = NaN on masked lanes — same f32-overflow class as the
    normalize floors). Live lanes have pi*f^2 >= ~3e-8, so values are
    identical."""
    a2 = a * a
    f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (math.pi * f * f + 1e-12)


def f_schlick(l_dot_h: jnp.ndarray, f0: jnp.ndarray) -> jnp.ndarray:
    return f0 + (1.0 - f0) * jnp.power(1.0 - l_dot_h, 5.0)[..., None]


def v_smith_ggx_correlated(n_dot_v, n_dot_l, a):
    a2 = a * a
    # Guards (AD safety, value-preserving on live lanes): the sqrt args are
    # >= a2 >= 1e-4 for any real material, and the visibility denominator is
    # O(0.1); both reach exact 0 only on masked lanes (roughness-0 light
    # material with n.l == 0), where unguarded reverse mode yields 0*inf.
    ggx_l = n_dot_v * jnp.sqrt(jnp.maximum(
        (-n_dot_l * a2 + n_dot_l) * n_dot_l + a2, 1e-12))
    ggx_v = n_dot_l * jnp.sqrt(jnp.maximum(
        (-n_dot_v * a2 + n_dot_v) * n_dot_v + a2, 1e-12))
    return 0.5 / (ggx_v + ggx_l + 1e-7)


def fd_lambert() -> float:
    return 1.0 / math.pi


def _safe_normalize(v: jnp.ndarray) -> jnp.ndarray:
    """normalize with a 1e-12 norm floor — value-identical to plain
    normalize for any non-degenerate vector, but keeps 0/0 AND
    f32-overflowing sqrt VJPs (see ``normalize``) out of primal and
    reverse mode on masked lanes (same floor as the kernels'
    _normalize3)."""
    return v / jnp.sqrt(jnp.maximum(dot(v, v), 1e-12))[..., None]


def vndf_dir(view_dir: jnp.ndarray, normal: jnp.ndarray,
             roughness: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Heitz-style VNDF GGX sample: stretch view, sample spherical cap, unstretch,
    reflect (vndfRay, shaders.metal:382-435)."""
    alpha = (roughness * roughness)[..., None]
    tangent, bitangent = build_orthonormal_basis(normal)
    ve = _safe_normalize(
        jnp.concatenate(
            [
                alpha * dot(view_dir, tangent)[..., None],
                alpha * dot(view_dir, bitangent)[..., None],
                dot(view_dir, normal)[..., None],
            ],
            axis=-1,
        )
    )
    t1 = _safe_normalize(
        jnp.stack([ve[..., 2], jnp.zeros_like(ve[..., 0]), -ve[..., 0]], axis=-1)
    )
    t2 = cross(ve, t1)
    phi = 2.0 * math.pi * u[..., 0]
    # NB: the reference normalizes Ve then takes length(Ve) — len is 1, so
    # cosThetaMax = 1/sqrt(2); replicated by computing length after normalize.
    len_ve = jnp.sqrt(dot(ve, ve))
    cos_theta_max = len_ve / jnp.sqrt(1.0 + len_ve * len_ve)
    cos_theta = cos_theta_max + (1.0 - cos_theta_max) * u[..., 1]
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    h = _safe_normalize(
        t1 * (jnp.cos(phi) * sin_theta)[..., None]
        + t2 * (jnp.sin(phi) * sin_theta)[..., None]
        + ve * cos_theta[..., None]
    )
    nh = _safe_normalize(
        jnp.concatenate(
            [alpha * h[..., 0:1], alpha * h[..., 1:2],
             jnp.maximum(0.0, h[..., 2:3])],
            axis=-1,
        )
    )
    world_h = _safe_normalize(
        tangent * nh[..., 0:1] + bitangent * nh[..., 1:2] + normal * nh[..., 2:3]
    )
    return reflect(-view_dir, world_h)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def vndf_pdf(view_dir: jnp.ndarray, normal: jnp.ndarray,
             light_dir: jnp.ndarray, roughness: jnp.ndarray) -> jnp.ndarray:
    """D * G1 * VoH / (4 * NoV) (calculateVNDFPdf, shaders.metal:437-445).
    +1e-7 in the denominator: AD-safety at exact grazing (n.v == 0)."""
    h = _safe_normalize(view_dir + light_dir)
    n_dot_h = jnp.abs(dot(normal, h))
    v_dot_h = jnp.abs(dot(view_dir, h))
    n_dot_v = jnp.abs(dot(normal, view_dir))
    d = d_ggx(n_dot_h, roughness)
    g1 = smith_g1_ggx(n_dot_v, roughness)
    return (d * g1 * v_dot_h) / (4.0 * n_dot_v + 1e-7)


# ---------------------------------------------------------------------------
# Legacy light samplers (shaders_old.metal — sphere and box lights)
# ---------------------------------------------------------------------------

def sample_sphere_light(
    light_center: jnp.ndarray, light_radius, point: jnp.ndarray,
    u: jnp.ndarray,
):
    """Visible-cone sphere light sampling (sampleSphereLight,
    shaders_old.metal:406-451). Returns (direction, pdf)."""
    to_light = light_center - point
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
    light_dir = to_light / dist[..., None]
    sin_theta_max = jnp.minimum(light_radius / dist, 1.0)
    cos_theta_max = jnp.sqrt(1.0 - sin_theta_max * sin_theta_max)
    cos_theta = 1.0 - u[..., 0] * (1.0 - cos_theta_max)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * math.pi * u[..., 1]
    tangent, bitangent = build_orthonormal_basis(light_dir)
    direction = normalize(
        tangent * (jnp.cos(phi) * sin_theta)[..., None]
        + bitangent * (jnp.sin(phi) * sin_theta)[..., None]
        + light_dir * cos_theta[..., None]
    )
    pdf = 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))
    return direction, pdf


def sphere_light_pdf(light_center: jnp.ndarray, light_radius,
                     point: jnp.ndarray) -> jnp.ndarray:
    """Cone pdf (calculateLightPdf, shaders_old.metal:617-623)."""
    to_light = light_center - point
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
    sin_theta_max = jnp.minimum(light_radius / dist, 1.0)
    cos_theta_max = jnp.sqrt(1.0 - sin_theta_max * sin_theta_max)
    return 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))


def sample_box_light(
    light_center: jnp.ndarray, width, height, depth, point: jnp.ndarray,
    u3: jnp.ndarray,
):
    """Area-weighted 6-face box-light sampling (sampleBoxLight,
    shaders_old.metal:292-404). ``u3`` is [..., 3]; the third coordinate picks
    the face. Returns (direction, pdf) with pdf measured against *total* box
    area (reference behavior). Branchless: all six faces are computed and
    selected by mask."""
    u1, u2, uf = u3[..., 0], u3[..., 1], u3[..., 2]
    hw, hh, hd = width * 0.5, height * 0.5, depth * 0.5
    area_xy = width * height
    area_xz = width * depth
    area_yz = height * depth
    total = 2.0 * (area_xy + area_xz + area_yz)
    prob1 = (2.0 * area_xy) / total
    prob2 = prob1 + (2.0 * area_xz) / total

    ox = (u1 - 0.5) * width
    oy_h = (u2 - 0.5) * height
    oz_d = (u2 - 0.5) * depth
    oy_h1 = (u1 - 0.5) * height

    # Candidate points/normals for the six faces, in reference order.
    def mk(px, py, pz, nx, ny, nz):
        p = jnp.stack([px, py, pz], axis=-1)
        n = jnp.broadcast_to(jnp.array([nx, ny, nz], _F32), p.shape)
        return light_center + p, n

    front = mk(ox, oy_h, jnp.full_like(u1, hd), 0, 0, 1)
    back = mk(ox, oy_h, jnp.full_like(u1, -hd), 0, 0, -1)
    top = mk(ox, jnp.full_like(u1, hh), oz_d, 0, 1, 0)
    bottom = mk(ox, jnp.full_like(u1, -hh), oz_d, 0, -1, 0)
    right = mk(jnp.full_like(u1, hw), oy_h1, oz_d, 1, 0, 0)
    left = mk(jnp.full_like(u1, -hw), oy_h1, oz_d, -1, 0, 0)

    adj3 = (uf - prob2) / (1.0 - prob2)
    adj2 = (uf - prob1) / (prob2 - prob1)
    in_xy = uf < prob1
    in_xz = jnp.logical_and(~in_xy, uf < prob2)

    def sel(c, a, b):
        return (jnp.where(c[..., None], a[0], b[0]),
                jnp.where(c[..., None], a[1], b[1]))

    xy = sel(uf < prob1 * 0.5, front, back)
    xz = sel(adj2 < 0.5, top, bottom)
    yz = sel(adj3 < 0.5, right, left)
    pt, nrm = sel(in_xy, xy, sel(in_xz, xz, yz))

    to_light = pt - point
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
    direction = to_light / dist[..., None]
    cos_theta = jnp.maximum(0.0, dot(-direction, nrm))
    pdf = (dist * dist) / (total * cos_theta + 1e-6)
    return direction, pdf


def box_light_pdf(
    light_center: jnp.ndarray, width, height, depth,
    point: jnp.ndarray, direction: jnp.ndarray,
) -> jnp.ndarray:
    """Pdf of a given direction hitting an axis-aligned box light
    (calculateBoxLightPdf, shaders_old.metal:625-676): slab-test ray/box
    intersection, entering-face classification by boundary coordinate, pdf =
    d^2 / (total_area * cos_theta). Returns 0 where the ray misses the box.
    Branchless masked form of the reference's early returns."""
    half = jnp.stack([width * 0.5, height * 0.5, depth * 0.5], axis=-1)
    box_min = light_center - half
    box_max = light_center + half

    # inv_dir with the reference's 1e8 clamp for near-zero components
    # (shaders_old.metal:636-640).
    small = jnp.abs(direction) <= 1e-8
    inv_dir = jnp.where(small, 1e8, 1.0 / jnp.where(small, 1.0, direction))
    t1 = (box_min - point) * inv_dir
    t2 = (box_max - point) * inv_dir
    t_min = jnp.minimum(t1, t2)
    t_max = jnp.maximum(t1, t2)
    t_near = jnp.max(t_min, axis=-1)
    t_far = jnp.min(t_max, axis=-1)
    hit = (t_near <= t_far) & (t_far > 0.0)
    t = jnp.where(t_near > 0.0, t_near, t_far)
    hit = hit & (t > 0.0)

    hit_point = point + direction * t[..., None]
    # Entering-face normal: first boundary coordinate within 1e-5, in the
    # reference's fixed test order (-x, +x, -y, +y, -z, else +z).
    axes = jnp.eye(3, dtype=_F32)
    on_min = jnp.abs(hit_point - box_min) < 1e-5
    on_max = jnp.abs(hit_point - box_max) < 1e-5
    normal = jnp.broadcast_to(axes[2], hit_point.shape)  # default +z
    for axis in (2, 1, 0):  # apply in reverse priority so -x wins overall
        normal = jnp.where(on_max[..., axis, None], axes[axis], normal)
        normal = jnp.where(on_min[..., axis, None], -axes[axis], normal)

    cos_theta = jnp.abs(dot(-direction, normal))
    total_area = 2.0 * (width * height + width * depth + height * depth)
    pdf = (t * t) / (total_area * cos_theta + 1e-6)
    return jnp.where(hit, pdf, 0.0)

// gpurt_native — C++ host-runtime components.
//
// The reference's host runtime is native (Swift): buffer marshalling
// (computeShader.swift:13-41), accel-structure prep (:45-97), and CPU image
// post-processing + PNG output (image.swift:15-157). This library is the
// framework's native equivalent for the host-side stages that are not
// XLA work: tonemapping large HDR buffers, PNG encoding, scene flattening /
// intersection-constant precompute, and Halton table generation for
// host-side sampling. Exposed via a plain C ABI, consumed through ctypes
// (native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC gpurt_native.cpp -o libgpurt_native.so -lz
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Tonemap: value *= exposure; Reinhard v/(v+1); gamma 1/g; to uint8
// (image.swift:46-65). hdr: [n] float32 interleaved rgb; out: [n] uint8.
// ---------------------------------------------------------------------------
void gpurt_tonemap(const float* hdr, uint8_t* out, int64_t n,
                   float exposure, float gamma) {
  const float inv_g = 1.0f / gamma;
  for (int64_t i = 0; i < n; ++i) {
    float v = hdr[i] * exposure;
    v = v / (v + 1.0f);
    v = powf(v < 0.0f ? 0.0f : v, inv_g);
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    out[i] = (uint8_t)(v * 255.0f);
  }
}

// ---------------------------------------------------------------------------
// PNG encode (RGB8 / RGBA8, filter 0) — CGImage/ImageIO replacement
// (image.swift:68-99). Returns bytes written, or -1 on error / insufficient
// buffer. out_cap should be ~ raw size + raw/1000 + 1024.
// ---------------------------------------------------------------------------
static void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

static int64_t write_chunk(uint8_t* out, const char tag[4],
                           const uint8_t* data, uint32_t len) {
  put_u32(out, len);
  memcpy(out + 4, tag, 4);
  if (len) memcpy(out + 8, data, len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out + 4, len + 4);
  put_u32(out + 8 + len, crc);
  return 12 + (int64_t)len;
}

int64_t gpurt_png_encode(const uint8_t* rgb, int32_t width, int32_t height,
                         int32_t channels, uint8_t* out, int64_t out_cap) {
  if (channels != 3 && channels != 4) return -1;
  const int64_t stride = (int64_t)width * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (int32_t y = 0; y < height; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: none
    memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return -1;

  int64_t need = 8 + 25 + (12 + (int64_t)comp_cap) + 12;
  if (out_cap < need) return -1;

  int64_t pos = 0;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  memcpy(out, sig, 8); pos += 8;
  uint8_t ihdr[13];
  put_u32(ihdr, (uint32_t)width);
  put_u32(ihdr + 4, (uint32_t)height);
  ihdr[8] = 8;                              // bit depth
  ihdr[9] = channels == 3 ? 2 : 6;          // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  pos += write_chunk(out + pos, "IHDR", ihdr, 13);
  pos += write_chunk(out + pos, "IDAT", comp.data(), (uint32_t)comp_cap);
  pos += write_chunk(out + pos, "IEND", nullptr, 0);
  return pos;
}

// ---------------------------------------------------------------------------
// Scene compile: per-triangle intersection constants — the native analog of
// setupAccelerationStructures (computeShader.swift:45-97) feeding
// intersect.compile_scene's layout. verts: [t, 3, 3] f32. Outputs, each
// [t]-major: n (3), c0, s1 (3), c1, s2 (3), c2 packed as [t, 11].
// ---------------------------------------------------------------------------
void gpurt_compile_triangles(const float* verts, int64_t t, float* out11) {
  for (int64_t k = 0; k < t; ++k) {
    const float* v0 = verts + k * 9;
    const float* v1 = v0 + 3;
    const float* v2 = v0 + 6;
    float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    float inv = len > 1e-15f ? 1.0f / len : 0.0f;
    n[0] *= inv; n[1] *= inv; n[2] *= inv;
    float e11 = e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2];
    float e22 = e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2];
    float e12 = e1[0] * e2[0] + e1[1] * e2[1] + e1[2] * e2[2];
    float den = e11 * e22 - e12 * e12;
    if (den < 1e-30f) den = 1e-30f;
    float s1[3], s2[3];
    for (int i = 0; i < 3; ++i) {
      s1[i] = (e22 * e1[i] - e12 * e2[i]) / den;
      s2[i] = (e11 * e2[i] - e12 * e1[i]) / den;
    }
    float* o = out11 + k * 11;
    o[0] = n[0]; o[1] = n[1]; o[2] = n[2];
    o[3] = n[0] * v0[0] + n[1] * v0[1] + n[2] * v0[2];          // c0
    o[4] = s1[0]; o[5] = s1[1]; o[6] = s1[2];
    o[7] = s1[0] * v0[0] + s1[1] * v0[1] + s1[2] * v0[2];       // c1
    o[8] = s2[0]; o[9] = s2[1]; o[10] = s2[2];
    // c2 folded into caller via gpurt_compile_c2 (kept 11-wide for alignment)
  }
}

void gpurt_compile_c2(const float* verts, const float* out11, int64_t t,
                      float* c2) {
  for (int64_t k = 0; k < t; ++k) {
    const float* v0 = verts + k * 9;
    const float* s2 = out11 + k * 11 + 8;
    c2[k] = s2[0] * v0[0] + s2[1] * v0[1] + s2[2] * v0[2];
  }
}

// ---------------------------------------------------------------------------
// Halton table: radical inverse for indices [start, start+count) in base
// primes[d] (sampling.metal:107-122). For host-side precomputed sample
// tables (e.g. the variant-A pixel-independent MIS tables).
// ---------------------------------------------------------------------------
static const unsigned PRIMES[24] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31,
                                    37, 41, 43, 47, 53, 59, 61, 67, 71, 73,
                                    79, 83, 89};

void gpurt_halton_table(uint32_t start, int64_t count, int32_t dim,
                        float* out) {
  unsigned b = PRIMES[dim % 24];
  float inv_b = 1.0f / (float)b;
  for (int64_t i = 0; i < count; ++i) {
    uint32_t x = start + (uint32_t)i;
    float f = 1.0f, r = 0.0f;
    while (x > 0) {
      f *= inv_b;
      r += f * (float)(x % b);
      x /= b;
    }
    out[i] = r;
  }
}

// Row means of an [h, w, 3] HDR image -> [h, 3]
// (writeDebugArrayToFile, computeShader.swift:211-230).
void gpurt_row_means(const float* hdr, int32_t h, int32_t w, float* out) {
  for (int32_t y = 0; y < h; ++y) {
    double s[3] = {0, 0, 0};
    const float* row = hdr + (int64_t)y * w * 3;
    for (int32_t x = 0; x < w; ++x) {
      s[0] += row[x * 3];
      s[1] += row[x * 3 + 1];
      s[2] += row[x * 3 + 2];
    }
    out[y * 3] = (float)(s[0] / w);
    out[y * 3 + 1] = (float)(s[1] / w);
    out[y * 3 + 2] = (float)(s[2] / w);
  }
}

}  // extern "C"

// Device helpers shared by the fused metadata-volume forward
// (fused_volume.cu) and backward (fused_volume_bwd.cu) kernels: the
// 16-channel bilinear tap loads, the per-view warp of one (pixel, plane)
// point, its closed-form metadata and the fc0/fc1 row products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fv {

constexpr int C = 16;       // matching channels
constexpr int F = 128;      // MLP width
constexpr int NMETA = 6;    // live metadata rows per view: z, dot, angle, ray xyz

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back: the operand rounding of a bf16 matrix product
// (f32 accumulation), where the TPU kernels round
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// val[c] += w * p[c] for the 16 channels at p (16-byte aligned)
__device__ __forceinline__ void accum16(const float* p, float w, float* val) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = __ldg(q + i);
    val[4 * i + 0] += w * t.x;
    val[4 * i + 1] += w * t.y;
    val[4 * i + 2] += w * t.z;
    val[4 * i + 3] += w * t.w;
  }
}

__device__ __forceinline__ void accum16(const __nv_bfloat16* p, float w, float* val) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 t = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      val[8 * i + 2 * j + 0] += w * f.x;
      val[8 * i + 2 * j + 1] += w * f.y;
    }
  }
}

// sum_c val[c] * p[c]
template <typename T>
__device__ __forceinline__ float dot16(const T* p, const float* val) {
  float probe[C];
#pragma unroll
  for (int c = 0; c < C; ++c) probe[c] = 0.f;
  accum16(p, 1.f, probe);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += probe[c] * val[c];
  return s;
}

// h[f] += x * w[f] for one input, w a 16-byte aligned row of F floats in shared memory
__device__ __forceinline__ void axpy_row(float x, const float* w, float* h) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 t = w4[i];
    h[4 * i + 0] += x * t.x;
    h[4 * i + 1] += x * t.y;
    h[4 * i + 2] += x * t.z;
    h[4 * i + 3] += x * t.w;
  }
}

// sum_f w[f] * h[f], w a 16-byte aligned row of F floats in shared memory
__device__ __forceinline__ float dot_row(const float* w, const float* h) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 t = w4[i];
    a0 += t.x * h[4 * i + 0];
    a1 += t.y * h[4 * i + 1];
    a2 += t.z * h[4 * i + 2];
    a3 += t.w * h[4 * i + 3];
  }
  return (a0 + a1) + (a2 + a3);
}

// Source-view sample position of the point (uu, vv) = (u + .5, v + .5) on
// the plane at depth dep: z clamped at 1e-5 before the divide, coordinates
// clipped to +-2W / +-2H before the floor (index space, pixel i at i).
struct ViewSample {
  float z, x, y;
};

__device__ __forceinline__ ViewSample warp_point(const float* a, const float* bb, float uu,
                                                 float vv, float dep, int H, int W) {
  const float bx = a[0] * uu + (a[1] * vv + a[2]);
  const float by = a[3] * uu + (a[4] * vv + a[5]);
  const float bz = a[6] * uu + (a[7] * vv + a[8]);
  const float xr = dep * bx + bb[0];
  const float yr = dep * by + bb[1];
  ViewSample s;
  s.z = fmaxf(dep * bz + bb[2], 1e-5f);
  s.x = fminf(fmaxf(xr / s.z - 0.5f, -2.f * W), 2.f * W);
  s.y = fminf(fmaxf(yr / s.z - 0.5f, -2.f * H), 2.f * H);
  return s;
}

// val[c] = bilinear sample of the (H, W, C) map img at (x, y), zeros padding
template <typename T>
__device__ __forceinline__ void sample16(const T* img, float x, float y, int H, int W,
                                         float* val) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
  for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yi = y0 + dy;
    if (yi < 0 || yi >= H) continue;
    const float wy = dy ? fy : 1.f - fy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = x0 + dx;
      if (xi < 0 || xi >= W) continue;
      const float wx = dx ? fx : 1.f - fx;
      accum16(img + ((long long)yi * W + xi) * C, wx * wy, val);
    }
  }
}

// The closed-form metadata of one view besides z and dot:
// angle, then the source-ray unit vector (r d - o) / n.
__device__ __forceinline__ void view_rays(float r0, float r1, float r2, float rn2, float rinv,
                                          const float* o, float dep, float* m) {
  const float ro = r0 * o[0] + r1 * o[1] + r2 * o[2];
  const float oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  const float n2 = dep * dep * rn2 - 2.f * dep * ro + oo;
  const float invn = rsqrtf(fmaxf(n2, 1e-10f));
  m[0] = (dep * rn2 - ro) * rinv * invn;
  m[1] = (r0 * dep - o[0]) * invn;
  m[2] = (r1 * dep - o[1]) * invn;
  m[3] = (r2 * dep - o[2]) * invn;
}

}  // namespace fv

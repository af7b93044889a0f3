// Fused metadata volume for Hopper (sm_90a): plane-sweep warp + closed-form
// ray metadata + the 202 -> 128 -> 128 -> 1 LeakyReLU MLP, per output point.
//
// Replaces the TPU kernel implicit_depth_tpu/ops/fused_volume.py::_fused_kernel.
// Same contract: per (b, plane d, row v, column u) warp the K source feature
// maps to the plane (bilinear, zeros padding, z clamped at 1e-5 before the
// divide, coords clipped to +-2W / +-2H before the floor), compute the source
// depth z, <warped, cur>, the ray-angle cosine and the source-ray unit vector
// in closed form,
//     src_ray = (r d - o) / n,  n^2 = d^2 |r|^2 - 2 d <r, o> + |o|^2,
//     angle   = (d |r|^2 - <r, o>) / (|r| n),
// then fc0 = base + w_plane d + W_vis^T vis + W_meta^T meta, LeakyReLU(0.01),
// fc1 (128x128, + bias), LeakyReLU, fc2 -> one f32 per point.
//
// What bounds it: about 36 k multiply-adds per point (fc0 over K*(C+6) = 154
// live inputs x 128, fc1 128 x 128, fc2), against ~100 bytes of device
// traffic per point once the source maps sit in L2. At the flagship shape
// (B=1, K=7, C=16, H=96, W=128, D=64) that is ~57 GFLOP per frame: the kernel
// is compute-bound. Design: what the TPU kernel did to feed its matrix unit
// (one-hot gather matmuls, plane groups, lane padding, y-band chunks) does
// not carry over; a bilinear tap is a direct 16-channel vector load from the
// NHWC source. One thread owns one point and keeps its 128 hidden units in
// registers; all fc0/fc1 weights sit in shared memory as f32, so every weight
// read is a warp-wide broadcast (no bank conflicts) feeding four FMAs per
// 16-byte load. Persistent blocks (one per SM, 227 KB shared memory budget)
// stage the weights once and walk the points with a grid-stride loop.
// f32 FMA accumulation throughout; tensor-core MMAs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;       // matching channels
constexpr int F = 128;      // MLP width
constexpr int NMETA = 6;    // live metadata rows per view: z, dot, angle, ray xyz
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) fused_volume_kernel(
    const T* __restrict__ cur,         // (B, H, W, C)
    const T* __restrict__ src,         // (B, K, H, W, C)
    const float* __restrict__ A,       // (B, K, 3, 3)
    const float* __restrict__ bvec,    // (B, K, 3)
    const float* __restrict__ origins,  // (B, K, 3)
    const float* __restrict__ invK,    // (B, 3, 3)
    const float* __restrict__ planes,  // (D,)
    const float* __restrict__ base,    // (B, H, F, W)
    const T* __restrict__ w_visT,      // (F, K*C)
    const float* __restrict__ w_metaT,  // (F, K*8): [z, dot, angle, ray xyz, 0, 0] per view
    const float* __restrict__ w_plane,  // (F,)
    const T* __restrict__ w_fc1T,      // (F, F), row j = output j
    const float* __restrict__ b_fc1,   // (F,)
    const float* __restrict__ w_fc2,   // (F,)
    const float* __restrict__ b_fc2,   // (1,)
    float* __restrict__ out,           // (B, D, H, W)
    int B, int K, int H, int W, int D) {
  extern __shared__ float4 smem4[];
  float* s_vis = reinterpret_cast<float*>(smem4);  // [K*C][F]
  float* s_meta = s_vis + K * C * F;               // [K*NMETA][F]
  float* s_fc1 = s_meta + K * NMETA * F;           // [F][F]
  float* s_plane = s_fc1 + F * F;                  // [F]
  float* s_b1 = s_plane + F;                       // [F]
  float* s_w2 = s_b1 + F;                          // [F]

  // stage the weights once per block, fc0 transposed so that the F weights
  // of one input are contiguous
  for (int i = threadIdx.x; i < K * C * F; i += blockDim.x) {
    const int f = i % F, kc = i / F;
    s_vis[i] = to_float(w_visT[f * (K * C) + kc]);
  }
  for (int i = threadIdx.x; i < K * NMETA * F; i += blockDim.x) {
    const int f = i % F, r = i / F;
    s_meta[i] = w_metaT[f * (K * 8) + (r / NMETA) * 8 + (r % NMETA)];
  }
  for (int i = threadIdx.x; i < F * F; i += blockDim.x) s_fc1[i] = to_float(w_fc1T[i]);
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    s_plane[i] = w_plane[i];
    s_b1[i] = b_fc1[i];
    s_w2[i] = w_fc2[i];
  }
  __syncthreads();

  const float bias2 = b_fc2[0];
  const long long HW = (long long)H * W;
  const long long total = (long long)B * D * HW;
  const long long step = (long long)gridDim.x * blockDim.x;

  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total; p += step) {
    const int u = (int)(p % W);
    long long t = p / W;
    const int v = (int)(t % H);
    t /= H;
    const int d = (int)(t % D);
    const int bi = (int)(t / D);

    const float dep = planes[d];
    const float uu = u + 0.5f, vv = v + 0.5f;

    // current-view ray r = invK (u+.5, v+.5, 1)
    const float* ik = invK + bi * 9;
    const float r0 = ik[0] * uu + (ik[1] * vv + ik[2]);
    const float r1 = ik[3] * uu + (ik[4] * vv + ik[5]);
    const float r2 = ik[6] * uu + (ik[7] * vv + ik[8]);
    const float rn2 = r0 * r0 + r1 * r1 + r2 * r2;
    const float rinv = rsqrtf(rn2);

    float h[F];
    const float* bp = base + ((long long)(bi * H + v) * F) * W + u;
#pragma unroll
    for (int f = 0; f < F; ++f) h[f] = bp[(long long)f * W] + s_plane[f] * dep;

    const T* curp = cur + ((long long)(bi * H + v) * W + u) * C;

    for (int k = 0; k < K; ++k) {
      const int bk = bi * K + k;
      const float* a = A + bk * 9;
      const float* bb = bvec + bk * 3;
      const float* o = origins + bk * 3;

      const float bx = a[0] * uu + (a[1] * vv + a[2]);
      const float by = a[3] * uu + (a[4] * vv + a[5]);
      const float bz = a[6] * uu + (a[7] * vv + a[8]);
      const float xr = dep * bx + bb[0];
      const float yr = dep * by + bb[1];
      const float z = fmaxf(dep * bz + bb[2], 1e-5f);
      const float x = fminf(fmaxf(xr / z - 0.5f, -2.f * W), 2.f * W);
      const float y = fminf(fmaxf(yr / z - 0.5f, -2.f * H), 2.f * H);

      // bilinear taps with zeros padding
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const T* img = src + (long long)bk * HW * C;
      float val[C];
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

      // fc0 rows of the warped source visuals
      const float* wv = s_vis + k * C * F;
#pragma unroll
      for (int c = 0; c < C; ++c) axpy_row(val[c], wv + c * F, h);

      // closed-form metadata
      const float dotp = dot16(curp, val);
      const float ro = r0 * o[0] + r1 * o[1] + r2 * o[2];
      const float oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
      const float n2 = dep * dep * rn2 - 2.f * dep * ro + oo;
      const float invn = rsqrtf(fmaxf(n2, 1e-10f));
      const float angle = (dep * rn2 - ro) * rinv * invn;
      const float* wm = s_meta + k * NMETA * F;
      axpy_row(z, wm + 0 * F, h);
      axpy_row(dotp, wm + 1 * F, h);
      axpy_row(angle, wm + 2 * F, h);
      axpy_row((r0 * dep - o[0]) * invn, wm + 3 * F, h);
      axpy_row((r1 * dep - o[1]) * invn, wm + 4 * F, h);
      axpy_row((r2 * dep - o[2]) * invn, wm + 5 * F, h);
    }

#pragma unroll
    for (int f = 0; f < F; ++f) h[f] = h[f] > 0.f ? h[f] : 0.01f * h[f];

    // fc1 + LeakyReLU + fc2, one hidden unit of layer 2 at a time
    float acc = bias2;
#pragma unroll 1
    for (int j = 0; j < F; ++j) {
      const float4* w4 = reinterpret_cast<const float4*>(s_fc1 + j * F);
      float a0 = s_b1[j], a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < F / 4; ++i) {
        const float4 w = w4[i];
        a0 += w.x * h[4 * i + 0];
        a1 += w.y * h[4 * i + 1];
        a2 += w.z * h[4 * i + 2];
        a3 += w.w * h[4 * i + 3];
      }
      float h2 = (a0 + a1) + (a2 + a3);
      h2 = h2 > 0.f ? h2 : 0.01f * h2;
      acc += s_w2[j] * h2;
    }
    out[p] = acc;
  }
}

size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)K * (C + NMETA) * F + (size_t)F * F + 3 * F);
}

template <typename T>
int launch(const void* cur, const void* src, const void* A, const void* b, const void* origins,
           const void* invK, const void* planes, const void* base, const void* w_visT,
           const void* w_metaT, const void* w_plane, const void* w_fc1T, const void* b_fc1,
           const void* w_fc2, const void* b_fc2, void* out, int B, int K, int H, int W, int D,
           void* stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return 0;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(fused_volume_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (total + THREADS - 1) / THREADS;
  const int grid = (int)(need < sms ? need : sms);
  fused_volume_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
      (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
      (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
      (const float*)w_fc2, (const float*)b_fc2, (float*)out, B, K, H, W, D);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_VOLUME_ARGS                                                                 \
  const void *cur, const void *src, const void *A, const void *b, const void *origins,    \
      const void *invK, const void *planes, const void *base, const void *w_visT,         \
      const void *w_metaT, const void *w_plane, const void *w_fc1T, const void *b_fc1,    \
      const void *w_fc2, const void *b_fc2, void *out, int B, int K, int H, int W, int D, \
      void *stream

#define FUSED_VOLUME_PASS                                                                  \
  cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, \
      w_fc2, b_fc2, out, B, K, H, W, D, stream

// C entry points: return cudaGetLastError() of the launch (0 on success).
extern "C" int fused_metadata_volume_f32(FUSED_VOLUME_ARGS) {
  return launch<float>(FUSED_VOLUME_PASS);
}

extern "C" int fused_metadata_volume_bf16(FUSED_VOLUME_ARGS) {
  return launch<__nv_bfloat16>(FUSED_VOLUME_PASS);
}

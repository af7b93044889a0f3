// Ray-head MLP of the BD training query head for Hopper (sm_90a), forward
// and backward.
//
// Replaces the TPU kernels implicit_depth_tpu/ops/ray_head.py::_fwd_kernel /
// _fwd_kernel_noprior (forward) and _bwd_kernel / _bwd_kernel_noprior
// (backward). Per (ray, sample) row, with fp the per-ray fc0 term:
//     z = fp + d k0d [+ p k0p],  h = elu(z),  z2 = h W1 + b1,  h2 = elu(z2),
//     pred = h2 . w2 + b2.
// The backward recomputes h and h2 per row:
//     dz2 = ct w2 elu'(z2),  dh = W1 dz2,  dz = dh elu'(z),
//     dd = dz . k0d,  dp = dz . k0p,  dfp = sum of dz over a ray's S rows,
// and the weight gradients dW1 = sum h (x) dz2, db1, dw2, db2, dk0d, dk0p.
//
// What bounds it: ~16.5 k multiply-adds per row forward (W1 is 128 x 128) and
// ~49 k backward, against ~4 bytes of row traffic (fp is read once per ray):
// compute-bound. Design: one thread per row keeps h (128) in registers; W1
// (transposed, so that both z2 = W1^T h and dh = W1 dz2 read rows of 128
// contiguous floats) and the vectors sit in shared memory as f32 and are read
// as warp-wide broadcasts. The TPU kernel's one-hot selector matmuls and its
// 64-ray padding only worked around Mosaic's layouts and are gone; the ragged
// last tile is masked. The backward's blocks own whole rays, so dfp is summed
// inside the block; the weight gradients go into one f32 slab per block
// (dW1 through a register-tiled product of the tile's staged h and dz2), and
// a second kernel sums the slabs in a fixed order, so the sums are the same
// on every run. f32 math throughout; tensor-core MMAs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 128;
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 128;  // rows per backward tile at most; == F
constexpr int RS = F + 4;         // row stride of the staged tiles (conflict-free float4 rows)
constexpr int SLAB = F * F + 5 * F + 4;  // dW1 | db1 | dw2 | dk0d | dk0p | db2 (+ pad)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

__device__ __forceinline__ float elu(float z) { return z > 0.f ? z : expm1f(z); }

// row[f] for the F values at p (16-byte aligned)
__device__ __forceinline__ void load_row(const float* p, float* row) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 t = __ldg(q + i);
    row[4 * i + 0] = t.x;
    row[4 * i + 1] = t.y;
    row[4 * i + 2] = t.z;
    row[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* row) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < F / 8; ++i) {
    const uint4 t = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      row[8 * i + 2 * j + 0] = f.x;
      row[8 * i + 2 * j + 1] = f.y;
    }
  }
}

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s_w1T[j * F + i] = w1[i * F + j], plus the F-vectors, staged once per block
__device__ void stage_weights(const float* w1, const float* k0d, const float* k0p,
                              const float* b1, const float* w2, float* s_w1T, float* s_k0d,
                              float* s_k0p, float* s_b1, float* s_w2) {
  for (int i = threadIdx.x; i < F * F; i += blockDim.x) {
    const int j = i / F, r = i % F;
    s_w1T[i] = w1[r * F + j];
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    s_k0d[i] = k0d[i];
    s_k0p[i] = k0p != nullptr ? k0p[i] : 0.f;
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  __syncthreads();
}

// h = elu(fp + d k0d + p k0p) for one row
template <typename T>
__device__ __forceinline__ void first_layer(const T* fprow, float dv, float pv, bool prior,
                                            const float* s_k0d, const float* s_k0p, float* h) {
  load_row(fprow, h);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float z = h[f] + dv * s_k0d[f];
    if (prior) z += pv * s_k0p[f];
    h[f] = elu(z);
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 1) ray_head_fwd_kernel(
    const T* __restrict__ fp,      // (rays, F)
    const T* __restrict__ d,       // (rays, S)
    const T* __restrict__ p,       // (rays, S) or null
    const float* __restrict__ k0d, const float* __restrict__ k0p,  // (F,), k0p or null
    const float* __restrict__ w1,  // (F, F), (in, out)
    const float* __restrict__ b1, const float* __restrict__ w2,    // (F,)
    const float* __restrict__ b2,  // (1,)
    T* __restrict__ out,           // (rays, S)
    long long rows, int S) {
  extern __shared__ float4 smem4[];
  float* s_w1T = reinterpret_cast<float*>(smem4);
  float* s_k0d = s_w1T + F * F;
  float* s_k0p = s_k0d + F;
  float* s_b1 = s_k0p + F;
  float* s_w2 = s_b1 + F;
  stage_weights(w1, k0d, k0p, b1, w2, s_w1T, s_k0d, s_k0p, s_b1, s_w2);
  const bool prior = p != nullptr;
  const float bias2 = b2[0];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += step) {
    float h[F];
    first_layer(fp + (r / S) * F, to_float(d[r]), prior ? to_float(p[r]) : 0.f, prior, s_k0d,
                s_k0p, h);
    float acc = bias2;
#pragma unroll 1
    for (int j = 0; j < F; ++j) acc += s_w2[j] * elu(s_b1[j] + dot_row(s_w1T + j * F, h));
    from_float(acc, out + r);
  }
}

// slab[i][j] += sum_{q < BWD_THREADS} A[q][i] * B[q][j], F x F, 8x8 tiles per thread
__device__ void tile_outer(const float* A, const float* B, float* slab) {
  constexpr int NCH = F / 8;
  for (int c = threadIdx.x; c < NCH * NCH; c += BWD_THREADS) {
    const int m0 = (c / NCH) * 8, n0 = (c % NCH) * 8;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int q = 0; q < BWD_THREADS; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + q * RS + m0);
      const float4 a1 = *reinterpret_cast<const float4*>(A + q * RS + m0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(B + q * RS + n0);
      const float4 b1 = *reinterpret_cast<const float4*>(B + q * RS + n0 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) slab[(m0 + i) * F + n0 + j] += acc[i][j];
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1) ray_head_bwd_kernel(
    const T* __restrict__ fp, const T* __restrict__ d, const T* __restrict__ p,
    const T* __restrict__ ct,  // (rays, S) output cotangent
    const float* __restrict__ k0d, const float* __restrict__ k0p,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    float* __restrict__ dfp,    // (rays, F)
    float* __restrict__ dd,     // (rays, S)
    float* __restrict__ dp,     // (rays, S) or null
    float* __restrict__ slabs,  // (gridDim.x, SLAB), zeroed
    long long nrays, int S) {
  extern __shared__ float4 smem4[];
  float* s_w1T = reinterpret_cast<float*>(smem4);
  float* s_k0d = s_w1T + F * F;
  float* s_k0p = s_k0d + F;
  float* s_b1 = s_k0p + F;
  float* s_w2 = s_b1 + F;
  float* s_d = s_w2 + F;            // [BWD_THREADS]
  float* s_p = s_d + BWD_THREADS;   // [BWD_THREADS]
  float* Hs = s_p + BWD_THREADS;    // [BWD_THREADS][RS]: h, then dz
  float* Gs = Hs + BWD_THREADS * RS;  // [BWD_THREADS][RS]: dz2
  stage_weights(w1, k0d, k0p, b1, w2, s_w1T, s_k0d, s_k0p, s_b1, s_w2);

  const bool prior = p != nullptr;
  const int t = threadIdx.x, lane = t & 31;
  const int rays_per_tile = BWD_THREADS / S;
  const int rows_per_tile = rays_per_tile * S;
  const long long rows = nrays * S;
  const long long ntiles = (nrays + rays_per_tile - 1) / rays_per_tile;
  float* slab = slabs + (long long)blockIdx.x * SLAB;
  float* hrow = Hs + t * RS;
  float* grow = Gs + t * RS;

  float db1_acc[F / 32], dw2_acc[F / 32], db2_acc = 0.f, dk0d_acc = 0.f, dk0p_acc = 0.f;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) db1_acc[i] = dw2_acc[i] = 0.f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long ray0 = tile * rays_per_tile;
    const long long r = ray0 * S + t;
    const bool valid = t < rows_per_tile && r < rows;
    const float dv = valid ? to_float(d[r]) : 0.f;
    const float pv = valid && prior ? to_float(p[r]) : 0.f;
    const float cv = valid ? to_float(ct[r]) : 0.f;
    s_d[t] = dv;
    s_p[t] = pv;

    // ---- recompute h; z2 and h2 one unit at a time, backprop fc2
    float h[F];
#pragma unroll
    for (int f = 0; f < F; ++f) h[f] = 0.f;
    if (valid) first_layer(fp + (r / S) * F, dv, pv, prior, s_k0d, s_k0p, h);
#pragma unroll
    for (int f = 0; f < F; f += 4)
      *reinterpret_cast<float4*>(hrow + f) = make_float4(h[f], h[f + 1], h[f + 2], h[f + 3]);
#pragma unroll 1
    for (int j = 0; j < F; ++j) {
      const float z2 = s_b1[j] + dot_row(s_w1T + j * F, h);
      const float h2 = elu(z2);
      const float g = cv * s_w2[j] * (z2 > 0.f ? 1.f : h2 + 1.f);
      grow[j] = g;
      const float sw2 = warp_sum(h2 * cv);
      const float sb1 = warp_sum(g);
      if ((j & 31) == lane) {
        dw2_acc[j >> 5] += sw2;
        db1_acc[j >> 5] += sb1;
      }
    }
    db2_acc += warp_sum(cv);
    __syncthreads();

    // dW1[i][j] += sum_q h[q][i] dz2[q][j]
    tile_outer(Hs, Gs, slab);

    // ---- dh = W1 dz2 (own row), dz = dh elu'(z) with elu'(z) = h + 1 below 0
    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = 0.f;
#pragma unroll 1
    for (int j = 0; j < F; j += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(grow + j);
      axpy_row(y4.x, s_w1T + (j + 0) * F, g);
      axpy_row(y4.y, s_w1T + (j + 1) * F, g);
      axpy_row(y4.z, s_w1T + (j + 2) * F, g);
      axpy_row(y4.w, s_w1T + (j + 3) * F, g);
    }
    float ddv = 0.f, dpv = 0.f;
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hrow + f);
      g[f + 0] *= h4.x > 0.f ? 1.f : h4.x + 1.f;
      g[f + 1] *= h4.y > 0.f ? 1.f : h4.y + 1.f;
      g[f + 2] *= h4.z > 0.f ? 1.f : h4.z + 1.f;
      g[f + 3] *= h4.w > 0.f ? 1.f : h4.w + 1.f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      ddv += g[f] * s_k0d[f];
      dpv += g[f] * s_k0p[f];
    }
    if (valid) {
      dd[r] = ddv;
      if (prior) dp[r] = dpv;
    }
    __syncthreads();  // the product and all row reads of Hs, Gs are done
#pragma unroll
    for (int f = 0; f < F; f += 4)
      *reinterpret_cast<float4*>(hrow + f) = make_float4(g[f], g[f + 1], g[f + 2], g[f + 3]);
    __syncthreads();

    // ---- columns: thread t owns hidden unit t; dfp per ray, dk0d, dk0p
    for (int q = 0; q < rays_per_tile; ++q) {
      const long long ray = ray0 + q;
      if (ray >= nrays) break;
      float s = 0.f;
      for (int i = 0; i < S; ++i) s += Hs[(q * S + i) * RS + t];
      dfp[ray * F + t] = s;
    }
    for (int q = 0; q < rows_per_tile; ++q) {
      const float z = Hs[q * RS + t];
      dk0d_acc += z * s_d[q];
      dk0p_acc += z * s_p[q];
    }
    __syncthreads();  // Hs, Gs, s_d, s_p are rewritten by the next tile
  }

  // vector gradients: the four warps' partials combined in a fixed order
  float* s_red = Gs;  // [4][2][F] + [4]
  const int w = t >> 5;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    s_red[(w * 2 + 0) * F + lane + 32 * i] = db1_acc[i];
    s_red[(w * 2 + 1) * F + lane + 32 * i] = dw2_acc[i];
  }
  if (lane == 0) s_red[8 * F + w] = db2_acc;
  __syncthreads();
  float* vec = slab + F * F;
  float a = 0.f, b = 0.f;
  for (int ww = 0; ww < BWD_THREADS / 32; ++ww) {
    a += s_red[(ww * 2 + 0) * F + t];
    b += s_red[(ww * 2 + 1) * F + t];
  }
  vec[t] = a;
  vec[F + t] = b;
  vec[2 * F + t] = dk0d_acc;
  vec[3 * F + t] = dk0p_acc;
  if (t == 0) {
    float s = 0.f;
    for (int ww = 0; ww < BWD_THREADS / 32; ++ww) s += s_red[8 * F + ww];
    vec[4 * F] = s;
  }
}

__global__ void sum_slabs_kernel(const float* __restrict__ slabs, int nslabs, long long len,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int q = 0; q < nslabs; ++q) s += slabs[(long long)q * len + i];
  out[i] = s;
}

constexpr size_t FWD_SMEM = sizeof(float) * (F * F + 4 * F);
constexpr size_t BWD_SMEM = sizeof(float) * (F * F + 4 * F + 2 * BWD_THREADS + 2 * BWD_THREADS * RS);

template <typename T>
int launch_fwd(const void* fp, const void* d, const void* p, const void* k0d, const void* k0p,
               const void* w1, const void* b1, const void* w2, const void* b2, void* out,
               long long nrays, int S, int grid, void* stream) {
  const long long rows = nrays * S;
  if (rows == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(ray_head_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  ray_head_fwd_kernel<T><<<grid, FWD_THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const T*)fp, (const T*)d, (const T*)p, (const float*)k0d, (const float*)k0p,
      (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2, (T*)out, rows, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* fp, const void* d, const void* p, const void* ct, const void* k0d,
               const void* k0p, const void* w1, const void* b1, const void* w2, void* dfp,
               void* dd, void* dp, void* slabs, void* grads, long long nrays, int S, int nslabs,
               void* stream) {
  if (nrays == 0 || nslabs <= 0) return 0;
  if (S < 1 || S > BWD_THREADS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ray_head_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ray_head_bwd_kernel<T><<<nslabs, BWD_THREADS, BWD_SMEM, s>>>(
      (const T*)fp, (const T*)d, (const T*)p, (const T*)ct, (const float*)k0d,
      (const float*)k0p, (const float*)w1, (const float*)b1, (const float*)w2, (float*)dfp,
      (float*)dd, (float*)dp, (float*)slabs, nrays, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_slabs_kernel<<<(SLAB + 255) / 256, 256, 0, s>>>((const float*)slabs, nslabs, SLAB,
                                                      (float*)grads);
  return (int)cudaGetLastError();
}

}  // namespace

#define RAY_HEAD_FWD_ARGS                                                                  \
  const void *fp, const void *d, const void *p, const void *k0d, const void *k0p,           \
      const void *w1, const void *b1, const void *w2, const void *b2, void *out,           \
      long long nrays, int S, int grid, void *stream
#define RAY_HEAD_FWD_PASS fp, d, p, k0d, k0p, w1, b1, w2, b2, out, nrays, S, grid, stream

#define RAY_HEAD_BWD_ARGS                                                                   \
  const void *fp, const void *d, const void *p, const void *ct, const void *k0d,             \
      const void *k0p, const void *w1, const void *b1, const void *w2, void *dfp, void *dd, \
      void *dp, void *slabs, void *grads, long long nrays, int S, int nslabs, void *stream
#define RAY_HEAD_BWD_PASS \
  fp, d, p, ct, k0d, k0p, w1, b1, w2, dfp, dd, dp, slabs, grads, nrays, S, nslabs, stream

// C entry points: return cudaGetLastError() of the launches (0 on success).
// p and k0p are null without the prior. `grads` (ray_head_slab_len floats)
// receives dW1 (F*F, (in, out)) | db1 | dw2 | dk0d | dk0p | db2.
extern "C" int ray_head_fwd_f32(RAY_HEAD_FWD_ARGS) { return launch_fwd<float>(RAY_HEAD_FWD_PASS); }
extern "C" int ray_head_fwd_bf16(RAY_HEAD_FWD_ARGS) {
  return launch_fwd<__nv_bfloat16>(RAY_HEAD_FWD_PASS);
}
extern "C" int ray_head_bwd_f32(RAY_HEAD_BWD_ARGS) { return launch_bwd<float>(RAY_HEAD_BWD_PASS); }
extern "C" int ray_head_bwd_bf16(RAY_HEAD_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16>(RAY_HEAD_BWD_PASS);
}
extern "C" long long ray_head_slab_len() { return SLAB; }

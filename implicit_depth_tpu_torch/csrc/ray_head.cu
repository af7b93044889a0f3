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
// compute-bound. The TPU kernel's one-hot selector matmuls and its 64-ray
// padding only worked around Mosaic's layouts and are gone; the ragged last
// tile is masked.
//
// Numerics. f32 operands: f32 math throughout. bf16 operands: the JAX
// kernel's chain (its `_CDT` is bf16), f32 arithmetic rounded to bf16 where
// that kernel rounds: W1, w2, k0d, k0p; d k0d, the sum z, p k0p; the ELU
// outputs (exp(z) - 1 below 0) and their derivatives (1 or h + 1, from the
// rounded h); every h2 w2 product; the forward's output; h2 ct, ct w2, dz2;
// dh and dz; every dz k0d, dz d, dz p product and dd, dp. Products' sums and
// the weight gradients stay in f32.
//
// The f32 forward and backward run on CUDA cores: one thread per row keeps h
// (128) in registers; W1 (transposed, so that both z2 = W1^T h and dh = W1
// dz2 read rows of 128 contiguous floats) and the vectors sit in shared
// memory as f32 and are read as warp-wide broadcasts. The f32 backward's
// blocks own whole rays, so dfp is summed inside the block; the weight
// gradients go into one f32 slab per block (dW1 through a register-tiled
// product of the tile's staged h and dz2), and a second kernel sums the
// slabs in a fixed order, so the sums are the same on every run.
//
// The bf16 forward and backward run their 128 x 128 products per row (z2;
// the backward also dh and dW1) on tensor cores (namespace tc below), and
// share the chain's arithmetic (h_pair, h2_pair): the h and h2 the backward
// recomputes are the forward's, bit for bit. Between the products sit the
// roundings to bf16 and one exp per (row, unit) and layer, which the JAX
// kernel's function asks for; with 8 warps an SM, that elementwise work, not
// the products, takes most of their time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int F = 128;
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 128;  // rows per backward tile at most; == F
constexpr int RS = F + 4;         // row stride of the staged tiles (conflict-free float4 rows)
constexpr int SLAB = F * F + 5 * F + 4;  // dW1 | db1 | dw2 | dk0d | dk0p | db2 (+ pad)

__device__ __forceinline__ float elu(float z) { return z > 0.f ? z : expm1f(z); }

// x rounded to bf16 and back
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Roundings two values at a time, with one packed conversion
// (cvt.rn.bf16x2.f32): rnd2 returns the pair rounded and back, bf2 the
// bf16 pair itself (to store); elu2_bf16 the chain's ELU (exp(z) - 1 in f32
// below 0, rounded: the JAX kernel's _elu), delu2_bf16 its derivative from
// the rounded h: 1 or h + 1, rounded (_delu).
__device__ __forceinline__ __nv_bfloat162 bf2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 rnd2(float a, float b) { return __bfloat1622float2(bf2(a, b)); }
// Its exp is __expf (ex2.approx; a few f32 ulps, against expf's one or two
// at several times the instructions): either error is far below the bf16
// ulp the result is rounded to, and it moves a rounding to the other side
// as rarely.
__device__ __forceinline__ __nv_bfloat162 elu2_bf16(float a, float b) {
  return bf2(a > 0.f ? a : __expf(a) - 1.f, b > 0.f ? b : __expf(b) - 1.f);
}
__device__ __forceinline__ float2 delu2_bf16(float2 h) {
  return rnd2(h.x > 0.f ? 1.f : h.x + 1.f, h.y > 0.f ? 1.f : h.y + 1.f);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 chain of the tensor-core forward and backward, two adjacent
// units of a row at a time (the JAX kernel's _forward_tile):
// h = bf16(elu(bf16(bf16(fp + bf16(d k0d)) [+ bf16(p k0p)]))), with kd, kp
// the units' k0d, k0p already rounded to bf16,
__device__ __forceinline__ __nv_bfloat162 h_pair(__nv_bfloat162 fp, float dv, float pv,
                                                 float2 kd, float2 kp, bool prior) {
  const float2 x = __bfloat1622float2(fp);
  const float2 dk = rnd2(dv * kd.x, dv * kd.y);
  float2 z = rnd2(x.x + dk.x, x.y + dk.y);
  if (prior) {
    const float2 pk = rnd2(pv * kp.x, pv * kp.y);
    z = rnd2(z.x + pk.x, z.y + pk.y);
  }
  return elu2_bf16(z.x, z.y);
}
// and h2 = bf16(elu(z2 + b1)) from the f32 accumulators of z2 = h W1.
__device__ __forceinline__ float2 h2_pair(float z0, float z1, float2 b) {
  return __bfloat1622float2(elu2_bf16(z0 + b.x, z1 + b.y));
}

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
__device__ __forceinline__ void first_layer(const float* fprow, float dv, float pv, bool prior,
                                            const float* s_k0d, const float* s_k0p, float* h) {
  load_row(fprow, h);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float z = h[f] + dv * s_k0d[f];
    if (prior) z += pv * s_k0p[f];
    h[f] = elu(z);
  }
}

__global__ void __launch_bounds__(FWD_THREADS, 1) ray_head_fwd_kernel(
    const float* __restrict__ fp,  // (rays, F)
    const float* __restrict__ d,   // (rays, S)
    const float* __restrict__ p,   // (rays, S) or null
    const float* __restrict__ k0d, const float* __restrict__ k0p,  // (F,), k0p or null
    const float* __restrict__ w1,  // (F, F), (in, out)
    const float* __restrict__ b1, const float* __restrict__ w2,    // (F,)
    const float* __restrict__ b2,  // (1,)
    float* __restrict__ out,       // (rays, S)
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
    first_layer(fp + (r / S) * F, d[r], prior ? p[r] : 0.f, prior, s_k0d, s_k0p, h);
    float acc = bias2;
#pragma unroll 1
    for (int j = 0; j < F; ++j) acc += s_w2[j] * elu(s_b1[j] + dot_row(s_w1T + j * F, h));
    out[r] = acc;
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

__global__ void __launch_bounds__(BWD_THREADS, 1) ray_head_bwd_kernel(
    const float* __restrict__ fp, const float* __restrict__ d, const float* __restrict__ p,
    const float* __restrict__ ct,  // (rays, S) output cotangent
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
    const float dv = valid ? d[r] : 0.f;
    const float pv = valid && prior ? p[r] : 0.f;
    const float cv = valid ? ct[r] : 0.f;
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

// ---------------------------------------------------------------- bf16: tensor cores
//
// Both kernels hold W1 in shared memory once per block, as W1^T [j][i] in
// bf16 with rows LDH = F + 8 elements apart (272 bytes: ldmatrix and the
// epilogues' 4-byte accesses are conflict-free), and run z2 = h W1 on
// mma.sync m16n8k16 (bf16 in, f32 accumulation), each warp its 16 rows in
// two halves of 64 columns (32 live accumulators), the k-slices in the same
// order: the backward's z2 is the forward's, bit for bit.
//
// Forward. Persistent blocks of 8 warps (two an SM) walk tiles of TR = 128
// flat rows, one 16-row mma tile a warp; there is no sum over a ray, so a
// tile need not hold whole rays, each row reads fp at row / S, and S is not
// bounded. Per tile:
// 1. h straight into the warp's A fragments (lane (g, q) holds rows g, g+8
//    at columns 16s + 2q (+1), 16s + 2q + 8 (+9) of every k-slice s: 32
//    registers), from 4-byte fp loads, all issued before the chain; where
//    the warp's 16 rows lie in one ray, the 8 row groups read the same
//    addresses;
// 2. z2 = h W1 on tensor cores, B fragments from W1^T by ldmatrix;
// 3. pred = bf16(sum_j bf16(h2_j w2_j) + b2), h2 = bf16(elu(z2 + b1)): each
//    lane sums its columns in f32, the quad's lanes and the two halves are
//    added (the JAX kernel's _rowsum, in another order), and lane q = 0
//    stores the row.
//
// Backward. 8 warps walk tiles of TR = 128 rows, each tile floor(128 / S)
// whole rays (S <= 128), so a ray's dfp sum stays inside the block; rows
// past the tile's rays are pads with zero inputs and a zero cotangent, which
// add nothing to any gradient and are not stored. Blocks are persistent, at
// most one per SM (177,664 bytes of shared memory). Per tile:
// 1. every warp stages its 16 rows of d, p, ct and of h = bf16(elu z);
// 2. z2 = h W1 on mma.sync m16n8k16 (bf16 in, f32 accumulation), the warp's
//    16 rows in two halves of 64 columns; in registers h2, dz2, h2 ct; dz2
//    and bf16(h2 ct) go to their stages;
// 3. dh = dz2 W1^T the same way; dz = bf16(bf16(dh) elu'(h)) to its stage,
//    dd and dp summed across the quad's lanes and stored;
// 4. dW1 += h^T dz2 (A from the h stage by ldmatrix.trans): warp w owns rows
//    16w..16w+15 of dW1, whose 64 accumulators stay in registers across all
//    the block's tiles;
// 5. dfp per ray, f32 sums of the dz stage; the column sums of db1, dw2,
//    dk0d, dk0p and db2 in per-thread registers, also across tiles.
// At the end each block writes dW1 and its vector sums once to its slab.
// z2 reads W1^T by ldmatrix, dh by ldmatrix.trans; the stages' rows are LDH
// elements apart, as W1^T's.

namespace tc {

using namespace tcore;

constexpr int TR = 128;            // rows per tile
constexpr int WARPS = TR / 16;     // one 16-row mma tile per warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = F / 8;          // n-tiles of 8 across F
constexpr int KS = F / 16;         // k-slices of 16 across F
constexpr int LDH = F + 8;         // bf16 row stride of W1^T and the stages
constexpr int PARTS = THREADS / (F / 2);  // row parts of the column sums
constexpr size_t STAGE = 2 * (size_t)TR * LDH;  // bytes of one bf16 stage
// W1^T | h | dz2 | h2 ct | dz | k0d, k0p, b1, w2 (f32) | d, p, ct (f32)
constexpr size_t OFF_H = STAGE;
constexpr size_t OFF_DZ2 = 2 * STAGE;
constexpr size_t OFF_HC = 3 * STAGE;
constexpr size_t OFF_DZ = 4 * STAGE;
constexpr size_t OFF_VEC = 5 * STAGE;
constexpr size_t OFF_ROW = OFF_VEC + 4 * 4 * (size_t)F;
constexpr size_t SMEM = OFF_ROW + 3 * 4 * (size_t)TR;
static_assert(F == TR, "W1^T shares the stages' shape");
static_assert(4 * (size_t)(PARTS * 4 * F + TR) <= STAGE, "the end's sums fit the h stage");
// the forward: W1^T | k0d, k0p, b1, w2 (f32)
constexpr int FWD_BLOCKS_PER_SM = 2;
constexpr size_t FWD_SMEM = STAGE + 4 * 4 * (size_t)F;

// W1^T in bf16 and the F-vectors (k0d, k0p, w2 rounded to bf16, b1 as it
// is), once per block
__device__ void stage_weights_bf16(const float* w1, const float* k0d, const float* k0p,
                                   const float* b1, const float* w2, __nv_bfloat16* s_w1,
                                   float* s_k0d, float* s_k0p, float* s_b1, float* s_w2) {
  for (int i = threadIdx.x; i < F * F; i += THREADS)  // coalesced reads, transposed writes
    s_w1[(i % F) * LDH + i / F] = __float2bfloat16_rn(w1[i]);
  for (int i = threadIdx.x; i < F; i += THREADS) {
    s_k0d[i] = rnd(k0d[i]);
    s_k0p[i] = k0p != nullptr ? rnd(k0p[i]) : 0.f;
    s_b1[i] = b1[i];
    s_w2[i] = rnd(w2[i]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, FWD_BLOCKS_PER_SM) ray_head_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ fp,  // (rays, F)
    const __nv_bfloat16* __restrict__ d,   // (rays, S)
    const __nv_bfloat16* __restrict__ p,   // (rays, S) or null
    const float* __restrict__ k0d, const float* __restrict__ k0p,  // (F,), k0p or null
    const float* __restrict__ w1,  // (F, F), (in, out)
    const float* __restrict__ b1, const float* __restrict__ w2,    // (F,)
    const float* __restrict__ b2,  // (1,)
    __nv_bfloat16* __restrict__ out,  // (rays, S)
    long long rows, int S) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [j][i]
  float* s_k0d = reinterpret_cast<float*>(smem_tc + STAGE);
  float* s_k0p = s_k0d + F;
  float* s_b1 = s_k0p + F;
  float* s_w2 = s_b1 + F;
  stage_weights_bf16(w1, k0d, k0p, b1, w2, s_w1, s_k0d, s_k0p, s_b1, s_w2);

  const bool prior = p != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int o_w1 = frag_off(LDH, lane, false);  // B: W1^T as [n = j][k = i]
  const float bias2 = b2[0];
  const long long ntiles = (rows + TR - 1) / TR;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // the lane's rows g and g + 8 of the warp's 16; rows past the end
    // compute on the last row and are not stored
    const long long row0 = tile * TR + 16 * warp + g;
    const long long ra = row0 < rows ? row0 : rows - 1;
    const long long rb = row0 + 8 < rows ? row0 + 8 : rows - 1;

    // ---- 1. h as the A fragments of z2 = h W1
    const __nv_bfloat16* fa = fp + (ra / S) * F + 2 * q;
    const __nv_bfloat16* fb = fp + (rb / S) * F + 2 * q;
    uint32_t a[KS][4];  // fp pairs, then h pairs
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      a[s][0] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s));
      a[s][1] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s));
      a[s][2] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s + 8));
      a[s][3] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s + 8));
    }
    const float da = __bfloat162float(d[ra]), db = __bfloat162float(d[rb]);
    const float pa = prior ? __bfloat162float(p[ra]) : 0.f;
    const float pb = prior ? __bfloat162float(p[rb]) : 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * s + 2 * q + 8 * (e >> 1);
        const float2 kd = *reinterpret_cast<const float2*>(s_k0d + c);
        const float2 kp = *reinterpret_cast<const float2*>(s_k0p + c);
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a[s][e]);
        a[s][e] = (e & 1) ? bits(h_pair(x, db, pb, kd, kp, prior))
                          : bits(h_pair(x, da, pa, kd, kp, prior));
      }
    }

    // ---- 2. z2 = h W1 + b1 on tensor cores; 3. sum_j bf16(h2_j w2_j)
    float part[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      float acc[NT / 2][4];
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int t2 = 0; t2 < NT / 4; ++t2) {
          uint32_t b[4];
          ldsm4(b, s_w1 + o_w1 + (64 * hh + 16 * t2) * LDH + s * 16);
          mma(acc[2 * t2], a[s], b[0], b[1]);
          mma(acc[2 * t2 + 1], a[s], b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        const int j = 64 * hh + 8 * t + 2 * q;
        const float2 bj = *reinterpret_cast<const float2*>(s_b1 + j);
        const float2 wj = *reinterpret_cast<const float2*>(s_w2 + j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 y = h2_pair(acc[t][2 * r], acc[t][2 * r + 1], bj);
          const float2 o = rnd2(y.x * wj.x, y.y * wj.y);
          part[r] += o.x + o.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(part[r]);
      if (q == 0 && row0 + 8 * r < rows) out[row0 + 8 * r] = __float2bfloat16_rn(v + bias2);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ray_head_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ fp,  // (rays, F)
    const __nv_bfloat16* __restrict__ d,   // (rays, S)
    const __nv_bfloat16* __restrict__ p,   // (rays, S) or null
    const __nv_bfloat16* __restrict__ ct,  // (rays, S) output cotangent
    const float* __restrict__ k0d, const float* __restrict__ k0p,  // (F,), k0p or null
    const float* __restrict__ w1,  // (F, F), (in, out)
    const float* __restrict__ b1, const float* __restrict__ w2,    // (F,)
    float* __restrict__ dfp,       // (rays, F)
    float* __restrict__ dd,        // (rays, S)
    float* __restrict__ dp,        // (rays, S) or null
    float* __restrict__ slabs,     // (gridDim.x, SLAB)
    long long nrays, int S) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem_tc);          // [j][i]
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_H);   // [row][i]
  __nv_bfloat16* s_dz2 = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_DZ2);
  __nv_bfloat16* s_hc = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_HC);
  __nv_bfloat16* s_dz = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_DZ);
  float* s_k0d = reinterpret_cast<float*>(smem_tc + OFF_VEC);
  float* s_k0p = s_k0d + F;
  float* s_b1 = s_k0p + F;
  float* s_w2 = s_b1 + F;
  float* s_d = reinterpret_cast<float*>(smem_tc + OFF_ROW);
  float* s_p = s_d + TR;
  float* s_ct = s_p + TR;

  stage_weights_bf16(w1, k0d, k0p, b1, w2, s_w1, s_k0d, s_k0p, s_b1, s_w2);
  const int tid = threadIdx.x;

  const bool prior = p != nullptr;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * warp;  // the warp's first row in the tile
  const int rays_per_tile = TR / S;
  const long long ntiles = (nrays + rays_per_tile - 1) / rays_per_tile;

  // per-lane ldmatrix offsets (elements) of the operand patterns
  const int o_rows = frag_off(LDH, lane, true) + row0 * LDH;  // A: the warp's rows of [row][k]
  const int o_w1 = frag_off(LDH, lane, false);                // B: W1^T as [n = j][k = i]
  const int o_w1T = frag_off(LDH, lane, true);                // B: W1^T as [k = j][n = i], .trans
  const int o_hA = frag_off(LDH, lane, false) + row0;         // A: h^T from [row][i], .trans
  const int o_zB = frag_off(LDH, lane, true);                 // B: dz2 from [row][j], .trans

  // the h pass: lane's 8 columns (a 16-byte chunk) of rows (lane / 16) + 2k
  const int chunk = lane & 15;
  // the column sums: columns 2c, 2c+1 over rows part * TR / PARTS on
  const int cpair = tid % (F / 2), cpart = tid / (F / 2);

  float gw[NT][4];  // dW1 rows 16 warp + (g, g + 8), columns 8t + 2q (+1)
#pragma unroll
  for (int t = 0; t < NT; ++t) gw[t][0] = gw[t][1] = gw[t][2] = gw[t][3] = 0.f;
  float cs_db1[2] = {0.f, 0.f}, cs_dw2[2] = {0.f, 0.f}, cs_dk0d[2] = {0.f, 0.f},
        cs_dk0p[2] = {0.f, 0.f}, cs_db2 = 0.f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long ray0 = tile * rays_per_tile;
    const int nr = (int)(nrays - ray0 < rays_per_tile ? nrays - ray0 : rays_per_tile);
    const int nrows = nr * S;
    const long long rbase = ray0 * S;  // the tile's first row

    // ---- 1. the warp's rows: d, p, ct; h = bf16(elu(bf16(bf16(fp + bf16(d k0d)) + bf16(p k0p))))
    if (lane < 16) {
      const int r = row0 + lane;
      const bool v = r < nrows;
      s_d[r] = v ? __bfloat162float(d[rbase + r]) : 0.f;
      s_p[r] = v && prior ? __bfloat162float(p[rbase + r]) : 0.f;
      s_ct[r] = v ? __bfloat162float(ct[rbase + r]) : 0.f;
    }
    __syncwarp();
    float kd8[8], kp8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kd8[e] = s_k0d[8 * chunk + e];
      kp8[e] = s_k0p[8 * chunk + e];
    }
    uint4 fv[8];  // the 8 rows' fp chunks, all loads in flight at once
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = row0 + (lane >> 4) + 2 * k;
      fv[k] = r < nrows
                  ? __ldg(reinterpret_cast<const uint4*>(fp + (ray0 + r / S) * F + 8 * chunk))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = row0 + (lane >> 4) + 2 * k;
      uint4 hv = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        const __nv_bfloat162* f2 = reinterpret_cast<const __nv_bfloat162*>(&fv[k]);
        uint32_t* h2 = reinterpret_cast<uint32_t*>(&hv);
        const float dv = s_d[r], pv = s_p[r];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h2[e] = bits(h_pair(f2[e], dv, pv, make_float2(kd8[2 * e], kd8[2 * e + 1]),
                              make_float2(kp8[2 * e], kp8[2 * e + 1]), prior));
      }
      *reinterpret_cast<uint4*>(s_h + r * LDH + 8 * chunk) = hv;
    }
    __syncwarp();

    // ---- 2. z2 = h W1 + b1 on tensor cores; h2 = bf16(elu z2),
    // dz2 = bf16(bf16(ct w2) elu'(h2)) and bf16(h2 ct) to their stages
    const float ct0 = s_ct[row0 + g], ct1 = s_ct[row0 + g + 8];
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      float acc[NT / 2][4];
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        ldsm4(a, s_h + o_rows + s * 16);
#pragma unroll
        for (int t2 = 0; t2 < NT / 4; ++t2) {
          uint32_t b[4];
          ldsm4(b, s_w1 + o_w1 + (64 * hh + 16 * t2) * LDH + s * 16);
          mma(acc[2 * t2], a, b[0], b[1]);
          mma(acc[2 * t2 + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        const int j = 64 * hh + 8 * t + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(s_b1 + j);
        const float2 w = *reinterpret_cast<const float2*>(s_w2 + j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float c = r ? ct1 : ct0;
          const float2 h2 = h2_pair(acc[t][2 * r], acc[t][2 * r + 1], b);
          const float2 cw = rnd2(c * w.x, c * w.y);
          const float2 dl = delu2_bf16(h2);
          const int o = (row0 + g + 8 * r) * LDH + j;
          *reinterpret_cast<uint32_t*>(s_dz2 + o) = bits(bf2(cw.x * dl.x, cw.y * dl.y));
          *reinterpret_cast<uint32_t*>(s_hc + o) = bits(bf2(h2.x * c, h2.y * c));
        }
      }
    }
    __syncwarp();

    // ---- 3. dh = dz2 W1^T on tensor cores; dz = bf16(bf16(dh) elu'(h)) to
    // its stage; dd = bf16(sum bf16(dz k0d)), dp likewise
    float ddp[2] = {0.f, 0.f}, dpp[2] = {0.f, 0.f};
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      float acc[NT / 2][4];
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        ldsm4(a, s_dz2 + o_rows + s * 16);
#pragma unroll
        for (int t2 = 0; t2 < NT / 4; ++t2) {
          uint32_t b[4];
          ldsm4_t(b, s_w1 + o_w1T + s * 16 * LDH + 64 * hh + 16 * t2);
          mma(acc[2 * t2], a, b[0], b[1]);
          mma(acc[2 * t2 + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        const int i = 64 * hh + 8 * t + 2 * q;
        const float2 kd = *reinterpret_cast<const float2*>(s_k0d + i);
        const float2 kp = *reinterpret_cast<const float2*>(s_k0p + i);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (row0 + g + 8 * r) * LDH + i;
          const float2 dh = rnd2(acc[t][2 * r], acc[t][2 * r + 1]);
          const float2 dl =
              delu2_bf16(__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_h + o)));
          const __nv_bfloat162 dzb = bf2(dh.x * dl.x, dh.y * dl.y);
          const float2 dz = __bfloat1622float2(dzb);
          const float2 a = rnd2(dz.x * kd.x, dz.y * kd.y);
          ddp[r] += a.x + a.y;
          if (prior) {
            const float2 c = rnd2(dz.x * kp.x, dz.y * kp.y);
            dpp[r] += c.x + c.y;
          }
          *reinterpret_cast<uint32_t*>(s_dz + o) = bits(dzb);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ddv = quad_sum(ddp[r]), dpv = quad_sum(dpp[r]);
      const int row = row0 + g + 8 * r;
      if (q == 0 && row < nrows) {
        dd[rbase + row] = rnd(ddv);
        if (prior) dp[rbase + row] = rnd(dpv);
      }
    }
    __syncthreads();  // every warp's h, dz2, h2 ct and dz rows are staged

    // ---- 4. dW1[i][j] += sum_row h[row][i] dz2[row][j], rows i of warp w
#pragma unroll 1
    for (int ks = 0; ks < TR / 16; ++ks) {
      uint32_t a[4];
      ldsm4_t(a, s_h + o_hA + ks * 16 * LDH);
#pragma unroll
      for (int t2 = 0; t2 < NT / 2; ++t2) {
        uint32_t b[4];
        ldsm4_t(b, s_dz2 + o_zB + ks * 16 * LDH + 16 * t2);
        mma(gw[2 * t2], a, b[0], b[1]);
        mma(gw[2 * t2 + 1], a, b[2], b[3]);
      }
    }

    // ---- 5. dfp per ray: the f32 sum of its S rows of dz
    for (int item = tid; item < nr * F; item += THREADS) {
      const int ray = item / F, f = item % F;
      const __nv_bfloat16* col = s_dz + ray * S * LDH + f;
      float sum = 0.f;
#pragma unroll 4
      for (int i = 0; i < S; ++i) sum += __bfloat162float(col[i * LDH]);
      dfp[(ray0 + ray) * F + f] = sum;
    }
    // the column sums, pad rows adding zeros: db1 = sum dz2, dw2 = sum
    // bf16(h2 ct), dk0d = sum bf16(dz d), dk0p = sum bf16(dz p), db2 = sum ct
#pragma unroll 4
    for (int r = cpart * (TR / PARTS); r < (cpart + 1) * (TR / PARTS); ++r) {
      const int o = r * LDH + 2 * cpair;
      const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_dz + o));
      const float2 z2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_dz2 + o));
      const float2 hc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_hc + o));
      const float2 zd = rnd2(z.x * s_d[r], z.y * s_d[r]);
      cs_db1[0] += z2.x;
      cs_db1[1] += z2.y;
      cs_dw2[0] += hc.x;
      cs_dw2[1] += hc.y;
      cs_dk0d[0] += zd.x;
      cs_dk0d[1] += zd.y;
      if (prior) {
        const float2 zp = rnd2(z.x * s_p[r], z.y * s_p[r]);
        cs_dk0p[0] += zp.x;
        cs_dk0p[1] += zp.y;
      }
    }
    if (tid < TR) cs_db2 += s_ct[tid];
    __syncthreads();  // the stages and rows are rewritten by the next tile
  }

  // dW1 into the block's slab, (in, out) layout
  float* slab = slabs + (long long)blockIdx.x * SLAB;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = 8 * t + 2 * q;
    *reinterpret_cast<float2*>(slab + (row0 + g) * F + j) = make_float2(gw[t][0], gw[t][1]);
    *reinterpret_cast<float2*>(slab + (row0 + g + 8) * F + j) = make_float2(gw[t][2], gw[t][3]);
  }
  // the vector sums: the row parts combined in a fixed order
  float* s_red = reinterpret_cast<float*>(s_h);  // [PARTS][4][F] | [TR]
  float* part = s_red + cpart * 4 * F + 2 * cpair;
  *reinterpret_cast<float2*>(part) = make_float2(cs_db1[0], cs_db1[1]);
  *reinterpret_cast<float2*>(part + F) = make_float2(cs_dw2[0], cs_dw2[1]);
  *reinterpret_cast<float2*>(part + 2 * F) = make_float2(cs_dk0d[0], cs_dk0d[1]);
  *reinterpret_cast<float2*>(part + 3 * F) = make_float2(cs_dk0p[0], cs_dk0p[1]);
  if (tid < TR) s_red[PARTS * 4 * F + tid] = cs_db2;
  __syncthreads();
  float* vec = slab + F * F;  // db1 | dw2 | dk0d | dk0p | db2
  for (int i = tid; i < 4 * F; i += THREADS) {
    float sum = 0.f;
    for (int pt = 0; pt < PARTS; ++pt) sum += s_red[pt * 4 * F + i];
    vec[i] = sum;
  }
  if (tid == 0) {
    float sum = 0.f;
    for (int r = 0; r < TR; ++r) sum += s_red[PARTS * 4 * F + r];
    vec[4 * F] = sum;
  }
}

}  // namespace tc

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

// bf16: the tensor-core kernel, f32: the CUDA-core one
int launch_fwd(bool bf16, const void* fp, const void* d, const void* p, const void* k0d,
               const void* k0p, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, long long nrays, int S, int grid, void* stream) {
  const long long rows = nrays * S;
  if (rows == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(tc::ray_head_fwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    tc::ray_head_fwd_bf16_kernel<<<grid, tc::THREADS, tc::FWD_SMEM, s>>>(
        (const __nv_bfloat16*)fp, (const __nv_bfloat16*)d, (const __nv_bfloat16*)p,
        (const float*)k0d, (const float*)k0p, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (__nv_bfloat16*)out, rows, S);
  } else {
    err = cudaFuncSetAttribute(ray_head_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    ray_head_fwd_kernel<<<grid, FWD_THREADS, FWD_SMEM, s>>>(
        (const float*)fp, (const float*)d, (const float*)p, (const float*)k0d,
        (const float*)k0p, (const float*)w1, (const float*)b1, (const float*)w2,
        (const float*)b2, (float*)out, rows, S);
  }
  return (int)cudaGetLastError();
}

int launch_bwd(bool bf16, const void* fp, const void* d, const void* p, const void* ct,
               const void* k0d, const void* k0p, const void* w1, const void* b1, const void* w2,
               void* dfp, void* dd, void* dp, void* slabs, void* grads, long long nrays, int S,
               int nslabs, void* stream) {
  if (nrays == 0 || nslabs <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    if (S < 1 || S > tc::TR) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(tc::ray_head_bwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::SMEM);
    if (err != cudaSuccess) return (int)err;
    tc::ray_head_bwd_bf16_kernel<<<nslabs, tc::THREADS, tc::SMEM, s>>>(
        (const __nv_bfloat16*)fp, (const __nv_bfloat16*)d, (const __nv_bfloat16*)p,
        (const __nv_bfloat16*)ct, (const float*)k0d, (const float*)k0p, (const float*)w1,
        (const float*)b1, (const float*)w2, (float*)dfp, (float*)dd, (float*)dp,
        (float*)slabs, nrays, S);
  } else {
    if (S < 1 || S > BWD_THREADS) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ray_head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    ray_head_bwd_kernel<<<nslabs, BWD_THREADS, BWD_SMEM, s>>>(
        (const float*)fp, (const float*)d, (const float*)p, (const float*)ct, (const float*)k0d,
        (const float*)k0p, (const float*)w1, (const float*)b1, (const float*)w2, (float*)dfp,
        (float*)dd, (float*)dp, (float*)slabs, nrays, S);
  }
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
extern "C" int ray_head_fwd_f32(RAY_HEAD_FWD_ARGS) { return launch_fwd(false, RAY_HEAD_FWD_PASS); }
extern "C" int ray_head_fwd_bf16(RAY_HEAD_FWD_ARGS) { return launch_fwd(true, RAY_HEAD_FWD_PASS); }
extern "C" int ray_head_bwd_f32(RAY_HEAD_BWD_ARGS) { return launch_bwd(false, RAY_HEAD_BWD_PASS); }
extern "C" int ray_head_bwd_bf16(RAY_HEAD_BWD_ARGS) { return launch_bwd(true, RAY_HEAD_BWD_PASS); }
extern "C" long long ray_head_slab_len() { return SLAB; }

// The forward's launch shape, for bf16 (the tensor-core kernel) or f32
// operands: threads and dynamic shared memory per block, and the blocks for
// rows = rays x S rows on sms SMs (the grid the forward entry points take).
extern "C" int ray_head_fwd_threads(int bf16) { return bf16 ? tc::THREADS : FWD_THREADS; }
extern "C" long long ray_head_fwd_smem_bytes(int bf16) {
  return (long long)(bf16 ? tc::FWD_SMEM : FWD_SMEM);
}
extern "C" long long ray_head_fwd_blocks(long long rows, int sms, int bf16) {
  const long long per = bf16 ? tc::TR : FWD_THREADS;  // rows a block takes at a time
  const long long most = (long long)sms * (bf16 ? tc::FWD_BLOCKS_PER_SM : 1);
  const long long tiles = (rows + per - 1) / per;
  return tiles < 1 ? 1 : (tiles < most ? tiles : most);
}

// The backward's launch shape, likewise; the blocks (= slabs) for nrays rays
// of S samples, -1 where the kernel refuses S (a tile holds 128 rows of
// whole rays).
extern "C" int ray_head_bwd_threads(int bf16) { return bf16 ? tc::THREADS : BWD_THREADS; }
extern "C" long long ray_head_bwd_smem_bytes(int bf16) {
  return (long long)(bf16 ? tc::SMEM : BWD_SMEM);
}
extern "C" long long ray_head_bwd_blocks(long long nrays, int S, int sms, int bf16) {
  const int rows = bf16 ? tc::TR : BWD_THREADS;
  if (S < 1 || S > rows) return -1;
  const long long tiles = (nrays + rows / S - 1) / (rows / S);
  return tiles < 1 ? 1 : (tiles < sms ? tiles : sms);
}

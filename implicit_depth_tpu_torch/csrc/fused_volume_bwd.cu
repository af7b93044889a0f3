// Backward of the fused metadata volume for Hopper (sm_90a).
//
// Replaces the TPU kernel implicit_depth_tpu/ops/fused_volume.py::
// _fused_bwd_kernel (wrapper `fused_metadata_volume_bwd`). Given the volume
// cotangent ct (B, D, H, W), it recomputes the forward of fused_volume.cu per
// (b, d, v, u) point (warp, closed-form metadata, fc0, fc1) and backpropagates
// through fc2, fc1 and fc0:
//     dh2p = w2 ct leaky'(h2p),  dh1 = W1^T dh2p,  dacc = dh1 leaky'(acc),
//     dvis_k = W_vis_k^T dacc + cur ddot_k,  ddot_k = W_dot_k^T dacc,
// giving dbase (B, H, F, W), dcur (B, H, W, C), dsrc (B, K, H, W, C) through
// the transposed bilinear warp, and the weight gradients dW_visT (F, K*C),
// dW_metaT (F, K*8), dw_plane, dW_fc1T (F, F), db_fc1, dw_fc2, db_fc2.
//
// What bounds it: ~100 k multiply-adds per point (the forward's 36 k again,
// dh1 and dvis 30 k, and the outer products of the three weight gradients
// 35 k), ~2 TFLOP per step at B=12, K=7, D=64, H=96, W=128; device traffic is
// small beside it, except the dsrc scatter (4 taps x K views x 16 channels
// per point). Design:
// - One block of 64 threads walks tiles of 64 pixels; for each tile it loops
//   over the D planes, so a thread owns one pixel for the whole loop: dcur
//   stays in registers and dbase is a read-modify-write no other thread
//   touches. Nothing of size (B, D, H, W, F) is ever written to device memory.
// - The fc0/fc1 weights sit in shared memory as f32, as in the forward. The
//   backward needs them transposed too (dh1 = W1^T dh2p, dvis = W_vis^T
//   dacc): rows are read as broadcasts either way round, once as dot products
//   and once as axpy rows, so each matrix is held once.
// - The weight gradients are sums over all points. Each tile stages its h1
//   and dh2p, then dacc and the recomputed visuals and metadata, in shared
//   memory (the X and Y stages) and a block-wide register-tiled product adds
//   the tile's outer products to the block's own f32 slab in device memory.
//   A second kernel sums the slabs in a fixed order, so the result is the
//   same on every run.
// - dsrc: every point scatters its taps with float4 atomicAdd (sm_90), four
//   times fewer atomics than per channel; their order varies from run to run.
// f32 FMA accumulation throughout; tensor-core MMAs are later work.

#include "fused_volume_common.cuh"

namespace {

using namespace fv;

constexpr int TP = 64;        // pixels per tile = threads per block
constexpr int XS = F + 4;     // row stride (floats) of the X stage: conflict-free float4 rows
constexpr int SLAB_VEC = 3 * F + 4;  // dw_plane, db_fc1, dw_fc2, db_fc2 (+ pad)

__host__ __device__ inline int y_stride(int K) {
  // room for max(F, K*C visuals + K*6 metadata padded to 8 columns), and a
  // stride of 4 mod 8 floats keeps the per-thread float4 rows conflict-free
  int n = K * C + ((K * NMETA + 7) / 8) * 8;
  if (n < F) n = F;
  return n + ((4 - n % 8) + 8) % 8;
}

__host__ __device__ inline long long slab_len(int K) {
  return (long long)F * F + (long long)F * K * C + (long long)F * K * 8 + SLAB_VEC;
}

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : 0.01f * x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void atomic_add16(float* p, float w, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = make_float4(w * v[4 * i], w * v[4 * i + 1], w * v[4 * i + 2],
                                 w * v[4 * i + 3]);
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(q + i, t);
#else
    atomicAdd(&q[i].x, t.x);
    atomicAdd(&q[i].y, t.y);
    atomicAdd(&q[i].z, t.z);
    atomicAdd(&q[i].w, t.w);
#endif
  }
}

// slab[m][col(n)] += sum_{p < TP} A[p][m] * B[p][n] for m < M (a multiple of
// 8) and n < N, over the block's TP threads; col(n) = n, or the metadata map
// (n / 6) * 8 + n % 6 into 8 columns per view. Each thread owns 8x8 tiles.
__device__ void tile_outer(const float* A, int lda, int M, const float* B, int ldb, int N,
                           float* slab, int lds, bool meta_cols) {
  const int mch = M / 8, nch = (N + 7) / 8;
  for (int c = threadIdx.x; c < mch * nch; c += TP) {
    const int m0 = (c / nch) * 8, n0 = (c % nch) * 8;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int p = 0; p < TP; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + p * lda + m0);
      const float4 a1 = *reinterpret_cast<const float4*>(A + p * lda + m0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(B + p * ldb + n0);
      const float4 b1 = *reinterpret_cast<const float4*>(B + p * ldb + n0 + 4);
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
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + j;
        if (n < N) {
          const int col = meta_cols ? (n / NMETA) * 8 + n % NMETA : n;
          slab[(long long)(m0 + i) * lds + col] += acc[i][j];
        }
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(TP, 1) fused_volume_bwd_kernel(
    const T* __restrict__ cur,          // (B, H, W, C)
    const T* __restrict__ src,          // (B, K, H, W, C)
    const float* __restrict__ A,        // (B, K, 3, 3)
    const float* __restrict__ bvec,     // (B, K, 3)
    const float* __restrict__ origins,  // (B, K, 3)
    const float* __restrict__ invK,     // (B, 3, 3)
    const float* __restrict__ planes,   // (D,)
    const float* __restrict__ base,     // (B, H, F, W)
    const T* __restrict__ w_visT,       // (F, K*C)
    const float* __restrict__ w_metaT,  // (F, K*8)
    const float* __restrict__ w_plane,  // (F,)
    const T* __restrict__ w_fc1T,       // (F, F), row j = output j
    const float* __restrict__ b_fc1,    // (F,)
    const float* __restrict__ w_fc2,    // (F,)
    const float* __restrict__ ct,       // (B, D, H, W) volume cotangent
    float* __restrict__ dbase,          // (B, H, F, W), zeroed
    float* __restrict__ dcur,           // (B, H, W, C)
    float* __restrict__ dsrc,           // (B, K, H, W, C), zeroed
    float* __restrict__ slabs,          // (gridDim.x, slab_len(K)), zeroed
    int B, int K, int H, int W, int D) {
  extern __shared__ float4 smem4[];
  float* s_vis = reinterpret_cast<float*>(smem4);  // [K*C][F]
  float* s_meta = s_vis + K * C * F;               // [K*NMETA][F]
  float* s_fc1 = s_meta + K * NMETA * F;           // [F][F]
  float* s_plane = s_fc1 + F * F;                  // [F]
  float* s_b1 = s_plane + F;                       // [F]
  float* s_w2 = s_b1 + F;                          // [F]
  float* X = s_w2 + F;                             // [TP][XS]: h1, then dacc
  float* Y = X + TP * XS;                          // [TP][ys]: dh2p, then visuals | metadata
  const int ys = y_stride(K);

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

  const int t = threadIdx.x, lane = t & 31;
  float* slab = slabs + (long long)blockIdx.x * slab_len(K);
  float* g_fc1 = slab;                            // [F][F]
  float* g_vis = g_fc1 + F * F;                   // [F][K*C]
  float* g_meta = g_vis + (long long)F * K * C;   // [F][K*8]
  float* g_vec = g_meta + (long long)F * K * 8;   // dw_plane | db_fc1 | dw_fc2 | db_fc2

  float db1_acc[F / 32], dw2_acc[F / 32], db2_acc = 0.f, dwp_acc[F / TP];
#pragma unroll
  for (int i = 0; i < F / 32; ++i) db1_acc[i] = dw2_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < F / TP; ++i) dwp_acc[i] = 0.f;

  const long long HW = (long long)H * W;
  const long long npix = (long long)B * HW;
  const long long nchunks = (npix + TP - 1) / TP;
  float* xrow = X + t * XS;
  float* yrow = Y + t * ys;

  for (long long chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const long long pix = chunk * TP + t;
    const bool valid = pix < npix;
    const int u = valid ? (int)(pix % W) : 0;
    const int v = valid ? (int)((pix / W) % H) : 0;
    const int bi = valid ? (int)(pix / HW) : 0;
    const float uu = u + 0.5f, vv = v + 0.5f;
    const float* ik = invK + bi * 9;
    const float r0 = ik[0] * uu + (ik[1] * vv + ik[2]);
    const float r1 = ik[3] * uu + (ik[4] * vv + ik[5]);
    const float r2 = ik[6] * uu + (ik[7] * vv + ik[8]);
    const float rn2 = r0 * r0 + r1 * r1 + r2 * r2;
    const float rinv = rsqrtf(rn2);
    const T* curp = cur + ((long long)(bi * H + v) * W + u) * C;
    const float* bp = base + ((long long)(bi * H + v) * F) * W + u;
    float* dbp = dbase + ((long long)(bi * H + v) * F) * W + u;

    float dcur_acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dcur_acc[c] = 0.f;

    for (int d = 0; d < D; ++d) {
      const float dep = planes[d];
      const float ctv = valid ? ct[((long long)(bi * D + d) * H + v) * W + u] : 0.f;

      // ---- forward recompute: fc0 and h1 (zeros for a pixel past the end)
      float h[F];
#pragma unroll
      for (int f = 0; f < F; ++f) h[f] = 0.f;
      if (valid) {
#pragma unroll
        for (int f = 0; f < F; ++f) h[f] = bp[(long long)f * W] + s_plane[f] * dep;
        for (int k = 0; k < K; ++k) {
          const int bk = bi * K + k;
          const ViewSample sp = warp_point(A + bk * 9, bvec + bk * 3, uu, vv, dep, H, W);
          float val[C];
          sample16(src + (long long)bk * HW * C, sp.x, sp.y, H, W, val);
          const float* wv = s_vis + k * C * F;
#pragma unroll
          for (int c = 0; c < C; ++c) axpy_row(val[c], wv + c * F, h);
          float m[4];
          view_rays(r0, r1, r2, rn2, rinv, origins + bk * 3, dep, m);
          const float* wm = s_meta + k * NMETA * F;
          axpy_row(sp.z, wm + 0 * F, h);
          axpy_row(dot16(curp, val), wm + 1 * F, h);
          axpy_row(m[0], wm + 2 * F, h);
          axpy_row(m[1], wm + 3 * F, h);
          axpy_row(m[2], wm + 4 * F, h);
          axpy_row(m[3], wm + 5 * F, h);
        }
#pragma unroll
        for (int f = 0; f < F; ++f) h[f] = leaky(h[f]);
      }
#pragma unroll
      for (int f = 0; f < F; f += 4)
        *reinterpret_cast<float4*>(xrow + f) = make_float4(h[f], h[f + 1], h[f + 2], h[f + 3]);

      // ---- fc1 forward, fc2 and fc1-bias backward, one unit j at a time
#pragma unroll 1
      for (int j = 0; j < F; ++j) {
        const float a = s_b1[j] + dot_row(s_fc1 + j * F, h);
        const float g = s_w2[j] * ctv * (a > 0.f ? 1.f : 0.01f);
        yrow[j] = g;
        const float sw2 = warp_sum(leaky(a) * ctv);
        const float sb1 = warp_sum(g);
        if ((j & 31) == lane) {
          dw2_acc[j >> 5] += sw2;
          db1_acc[j >> 5] += sb1;
        }
      }
      db2_acc += warp_sum(ctv);
      __syncthreads();

      // dW_fc1T[j][f] += sum_p dh2p[p][j] h1[p][f]
      tile_outer(Y, ys, F, X, XS, F, g_fc1, F, false);

      // ---- dh1 = W1^T dh2p (own row of Y), dacc = dh1 leaky'(acc)
      float g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = 0.f;
#pragma unroll 1
      for (int j = 0; j < F; j += 4) {
        const float4 y4 = *reinterpret_cast<const float4*>(yrow + j);
        axpy_row(y4.x, s_fc1 + (j + 0) * F, g);
        axpy_row(y4.y, s_fc1 + (j + 1) * F, g);
        axpy_row(y4.z, s_fc1 + (j + 2) * F, g);
        axpy_row(y4.w, s_fc1 + (j + 3) * F, g);
      }
#pragma unroll
      for (int f = 0; f < F; f += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(xrow + f);
        g[f + 0] *= x4.x > 0.f ? 1.f : 0.01f;
        g[f + 1] *= x4.y > 0.f ? 1.f : 0.01f;
        g[f + 2] *= x4.z > 0.f ? 1.f : 0.01f;
        g[f + 3] *= x4.w > 0.f ? 1.f : 0.01f;
      }
      __syncthreads();  // the product above and every row read of X and Y are done

#pragma unroll
      for (int f = 0; f < F; f += 4)
        *reinterpret_cast<float4*>(xrow + f) = make_float4(g[f], g[f + 1], g[f + 2], g[f + 3]);
      if (valid) {
#pragma unroll
        for (int f = 0; f < F; ++f) dbp[(long long)f * W] += g[f];
      }

      // ---- per view: recompute the sample, stage it, backprop into the
      // warped visuals and scatter them through the bilinear taps
      for (int k = 0; k < K; ++k) {
        const int bk = bi * K + k;
        float val[C], m[4];
        ViewSample sp = {0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] = 0.f;
        m[0] = m[1] = m[2] = m[3] = 0.f;
        float dotp = 0.f;
        if (valid) {
          sp = warp_point(A + bk * 9, bvec + bk * 3, uu, vv, dep, H, W);
          sample16(src + (long long)bk * HW * C, sp.x, sp.y, H, W, val);
          view_rays(r0, r1, r2, rn2, rinv, origins + bk * 3, dep, m);
          dotp = dot16(curp, val);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) yrow[k * C + c] = val[c];
        float* ym = yrow + K * C + k * NMETA;
        ym[0] = sp.z;
        ym[1] = dotp;
        ym[2] = m[0];
        ym[3] = m[1];
        ym[4] = m[2];
        ym[5] = m[3];
        if (!valid) continue;

        const float ddot = dot_row(s_meta + (k * NMETA + 1) * F, g);
        float dv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[c] = dot_row(s_vis + (k * C + c) * F, g);
          dcur_acc[c] += val[c] * ddot;
        }
        accum16(curp, ddot, dv);

        // transposed bilinear warp, zeros padding
        const float x0f = floorf(sp.x), y0f = floorf(sp.y);
        const float fx = sp.x - x0f, fy = sp.y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        float* img = dsrc + (long long)bk * HW * C;
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
            atomic_add16(img + ((long long)yi * W + xi) * C, wx * wy, dv);
          }
        }
      }
      __syncthreads();

      // dW_visT[f][kc] += sum_p dacc[p][f] vis[p][kc]; dW_metaT likewise
      tile_outer(X, XS, F, Y, ys, K * C, g_vis, K * C, false);
      tile_outer(X, XS, F, Y + K * C, ys, K * NMETA, g_meta, K * 8, true);
#pragma unroll
      for (int i = 0; i < F / TP; ++i) {
        const int f = t + i * TP;
        float s = 0.f;
        for (int p = 0; p < TP; ++p) s += X[p * XS + f];
        dwp_acc[i] += dep * s;
      }
      __syncthreads();  // X and Y are rewritten by the next plane
    }
    if (valid) {
      float* dc = dcur + pix * C;
#pragma unroll
      for (int c = 0; c < C; ++c) dc[c] = dcur_acc[c];
    }
  }

  // vector gradients: the two warps' partials combined in a fixed order
  float* s_red = X;  // [2][2][F] + [2]
  const int w = t >> 5;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    s_red[(w * 2 + 0) * F + lane + 32 * i] = db1_acc[i];
    s_red[(w * 2 + 1) * F + lane + 32 * i] = dw2_acc[i];
  }
  if (lane == 0) s_red[4 * F + w] = db2_acc;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < F / TP; ++i) {
    const int f = t + i * TP;
    g_vec[f] = dwp_acc[i];
    g_vec[F + f] = s_red[0 * F + f] + s_red[2 * F + f];
    g_vec[2 * F + f] = s_red[1 * F + f] + s_red[3 * F + f];
  }
  if (t == 0) g_vec[3 * F] = s_red[4 * F] + s_red[4 * F + 1];
}

// out[i] = sum over the slabs, in slab order
__global__ void sum_slabs_kernel(const float* __restrict__ slabs, int nslabs, long long len,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int p = 0; p < nslabs; ++p) s += slabs[(long long)p * len + i];
  out[i] = s;
}

size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)K * (C + NMETA) * F + (size_t)F * F + 3 * F +
                          (size_t)TP * XS + (size_t)TP * y_stride(K));
}

template <typename T>
int launch(const void* cur, const void* src, const void* A, const void* b, const void* origins,
           const void* invK, const void* planes, const void* base, const void* w_visT,
           const void* w_metaT, const void* w_plane, const void* w_fc1T, const void* b_fc1,
           const void* w_fc2, const void* ct, void* dbase, void* dcur, void* dsrc, void* slabs,
           void* grads, int nslabs, int B, int K, int H, int W, int D, void* stream) {
  if ((long long)B * H * W == 0 || nslabs <= 0) return 0;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(fused_volume_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fused_volume_bwd_kernel<T><<<nslabs, TP, smem, s>>>(
      (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
      (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
      (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
      (const float*)w_fc2, (const float*)ct, (float*)dbase, (float*)dcur, (float*)dsrc,
      (float*)slabs, B, K, H, W, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long len = slab_len(K);
  sum_slabs_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>((const float*)slabs, nslabs,
                                                                 len, (float*)grads);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_VOLUME_BWD_ARGS                                                               \
  const void *cur, const void *src, const void *A, const void *b, const void *origins,      \
      const void *invK, const void *planes, const void *base, const void *w_visT,           \
      const void *w_metaT, const void *w_plane, const void *w_fc1T, const void *b_fc1,      \
      const void *w_fc2, const void *ct, void *dbase, void *dcur, void *dsrc, void *slabs,  \
      void *grads, int nslabs, int B, int K, int H, int W, int D, void *stream

#define FUSED_VOLUME_BWD_PASS                                                                \
  cur, src, A, b, origins, invK, planes, base, w_visT, w_metaT, w_plane, w_fc1T, b_fc1, w_fc2, \
      ct, dbase, dcur, dsrc, slabs, grads, nslabs, B, K, H, W, D, stream

// C entry points: return cudaGetLastError() of the launches (0 on success).
// `grads` (slab_len) receives dW_fc1T | dW_visT | dW_metaT | dw_plane |
// db_fc1 | dw_fc2 | db_fc2, summed over the nslabs per-block slabs.
extern "C" int fused_metadata_volume_bwd_f32(FUSED_VOLUME_BWD_ARGS) {
  return launch<float>(FUSED_VOLUME_BWD_PASS);
}

extern "C" int fused_metadata_volume_bwd_bf16(FUSED_VOLUME_BWD_ARGS) {
  return launch<__nv_bfloat16>(FUSED_VOLUME_BWD_PASS);
}

extern "C" long long fused_metadata_volume_bwd_slab_len(int K) { return slab_len(K); }

extern "C" long long fused_metadata_volume_bwd_smem_bytes(int K) {
  return (long long)smem_bytes(K);
}

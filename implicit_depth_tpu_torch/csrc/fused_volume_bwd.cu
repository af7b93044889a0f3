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
// 35 k), ~2 TFLOP per step at B=12, K=7, D=64, H=96, W=128: the products
// bound it, and they are matrix products over the points. Device traffic is
// small beside it, except the dsrc scatter (4 taps x K views x 16 channels
// per point). Both kernels keep nothing of size (B, D, H, W, F) in device
// memory, walk tiles of pixels and loop over the D planes inside a tile, so
// that dcur and dbase have one owner; the weight gradients go to a per-block
// f32 slab that a second kernel sums in block order (the same result on
// every run); dsrc is a float4 atomicAdd scatter (sm_90) whose order varies
// from run to run.
//
// Two instantiations, chosen by the features' dtype:
// - bf16 (the training path, `precision: 16`): tensor cores, below.
// - f32: one thread per pixel on CUDA cores (f32 FMA throughout), kept for
//   the f32 GPU-vs-CPU checks, whose bounds leave no room for TF32.

#include "fused_volume_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fv;

constexpr int SLAB_VEC = 3 * F + 4;  // dw_plane, db_fc1, dw_fc2, db_fc2 (+ pad)

__host__ __device__ inline long long slab_len(int K) {
  return (long long)F * F + (long long)F * K * C + (long long)F * K * 8 + SLAB_VEC;
}

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : 0.01f * x; }
__device__ __forceinline__ float leaky_slope(float x) { return x > 0.f ? 1.f : 0.01f; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void atomic_add4(float* p, float4 t) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(p), t);
#else
  atomicAdd(p, t.x);
  atomicAdd(p + 1, t.y);
  atomicAdd(p + 2, t.z);
  atomicAdd(p + 3, t.w);
#endif
}

__device__ __forceinline__ void atomic_add16(float* p, float w, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    atomic_add4(p + 4 * i, make_float4(w * v[4 * i], w * v[4 * i + 1], w * v[4 * i + 2],
                                       w * v[4 * i + 3]));
}

// ---------------------------------------------------------------- f32: CUDA cores
//
// One block of 64 threads walks tiles of 64 pixels, a thread owns one pixel
// for the whole plane loop (dcur in registers, dbase a read-modify-write no
// other thread touches). The fc0/fc1 weights sit in shared memory as f32 and
// are read as broadcasts, as rows for the dot products and the axpys alike.
// The weight gradients: each tile stages h1 and dh2p, then dacc and the
// recomputed visuals and metadata, in shared memory (the X and Y stages) and
// a block-wide register-tiled product adds the tile's outer products to the
// block's slab.

constexpr int TP = 64;     // pixels per tile = threads per block
constexpr int XS = F + 4;  // row stride (floats) of the X stage: conflict-free float4 rows

__host__ __device__ inline int y_stride(int K) {
  // room for max(F, K*C visuals + K*6 metadata padded to 8 columns), and a
  // stride of 4 mod 8 floats keeps the per-thread float4 rows conflict-free
  int n = K * C + ((K * NMETA + 7) / 8) * 8;
  if (n < F) n = F;
  return n + ((4 - n % 8) + 8) % 8;
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

__global__ void __launch_bounds__(TP, 1) fused_volume_bwd_f32_kernel(
    const float* __restrict__ cur,      // (B, H, W, C)
    const float* __restrict__ src,      // (B, K, H, W, C)
    const float* __restrict__ A,        // (B, K, 3, 3)
    const float* __restrict__ bvec,     // (B, K, 3)
    const float* __restrict__ origins,  // (B, K, 3)
    const float* __restrict__ invK,     // (B, 3, 3)
    const float* __restrict__ planes,   // (D,)
    const float* __restrict__ base,     // (B, H, F, W)
    const float* __restrict__ w_visT,   // (F, K*C)
    const float* __restrict__ w_metaT,  // (F, K*8)
    const float* __restrict__ w_plane,  // (F,)
    const float* __restrict__ w_fc1T,   // (F, F), row j = output j
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
    s_vis[i] = w_visT[f * (K * C) + kc];
  }
  for (int i = threadIdx.x; i < K * NMETA * F; i += blockDim.x) {
    const int f = i % F, r = i / F;
    s_meta[i] = w_metaT[f * (K * 8) + (r / NMETA) * 8 + (r % NMETA)];
  }
  for (int i = threadIdx.x; i < F * F; i += blockDim.x) s_fc1[i] = w_fc1T[i];
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
    const float* curp = cur + ((long long)(bi * H + v) * W + u) * C;
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
        const float g = s_w2[j] * ctv * leaky_slope(a);
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
        g[f + 0] *= leaky_slope(x4.x);
        g[f + 1] *= leaky_slope(x4.y);
        g[f + 2] *= leaky_slope(x4.z);
        g[f + 3] *= leaky_slope(x4.w);
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

size_t smem_bytes_f32(int K) {
  return sizeof(float) * ((size_t)K * (C + NMETA) * F + (size_t)F * F + 3 * F +
                          (size_t)TP * XS + (size_t)TP * y_stride(K));
}

// ---------------------------------------------------------------- bf16: tensor cores
//
// A block of 8 warps walks tiles of P = 128 pixels; for each tile it loops
// over the D planes. Per (tile, plane):
//   A. all threads sample every (pixel, view) once: the warped visuals go to
//      shared memory as bf16 (P x K*C, the JAX kernel's rounding at :487),
//      the six metadata values as f32 and the sample's x, y for the scatter.
//   B. warp w owns pixel rows 16w..16w+15 and runs the per-pixel chain with
//      mma.sync m16n8k16 (bf16 operands, f32 accumulation), each product in
//      two halves of 64 output columns so that 32 accumulators are live:
//        acc  = base + dep w_plane + vis W_vis^T (tensor) + meta W_meta^T (f32 FMA)
//        a    = bf16(h1) W1^T + b1               h1 = leaky(acc), rounded (:522)
//        dh2p = w2 ct leaky'(a)                   rounded before its products (:534)
//        dh1  = bf16(dh2p) W1,  dacc = dh1 leaky'(acc), rounded for its products (:539)
//        dvis = bf16(dacc) W_vis,  ddot = dacc W_dot (f32), then the scatter
//      h1 and dh2p go to bf16 stages (the next product's A operand and the
//      block-wide dW_fc1^T product's), dacc to an f32 stage.
//   C. the weight gradients over the tile's P pixels: dW_fc1^T = dh2p^T h1
//      and dW_visT = dacc^T vis on tensor cores, warp w owning output rows
//      16w..16w+15, each added to the block's slab (kept in mma fragment
//      order so that each lane moves float4s); dW_metaT = dacc^T meta in f32
//      on CUDA cores from the f32 dacc stage, into the slab too. db_fc1,
//      dw_fc2 and dw_plane are column sums of f32 values in registers,
//      reduced across the warp's rows by shuffles into per-warp sums in
//      shared memory. dbase is added from the dacc stage, a warp's 32
//      pixels per access.
// Every read-modify-write of device memory issues its loads before its
// stores: the compiler cannot tell the addresses apart, and element by
// element each load would wait for the previous store. Registers are the
// scarce resource (255 a thread at 8 warps an SM; the shared memory leaves
// L1 ~25 KB, so spills go to L2): hence the halves, the fixed shared-memory
// layout (offsets and strides are immediates) and the stages that hand
// operands back instead of holding them.
// Shared memory: W1 and W_vis as bf16 (rows padded by 8 so that ldmatrix's
// eight row reads fall on distinct banks), W_meta as f32, and the stages;
// h1 | dh2p share their space with the f32 dacc stage (231 KB at K=7).
// ldmatrix (.trans where a product wants the transpose) loads every operand
// from one copy of each matrix.

namespace tc {

using namespace tcore;

constexpr int P = 128;               // pixels per tile
constexpr int WARPS = P / 16;        // one 16-row mma tile per warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = F / 8;            // n-tiles of 8 across F
constexpr int KS = F / 16;           // k-slices of 16 across F
constexpr int LDH = F + 8;           // bf16 row stride of W1, h1, dh2p (272 B)
constexpr int LDA = F + 4;           // f32 row stride of the dacc stage
constexpr int KMAX = 7;              // source views the shared-memory layout holds

// Shared memory in bytes for k views: the layout below at k = KMAX, and what
// it would take beyond (no launch). Fixed at compile time, the offsets and
// strides cost no registers.
__host__ __device__ constexpr size_t layout_bytes(int k) {
  return 2 * (size_t)F * LDH                     // W1^T (w_fc1T rows j)
         + 2 * (size_t)F * (k * C + 8)           // W_vis^T (w_visT rows f)
         + 4 * (size_t)6 * k * F                 // W_meta, row 6k+i
         + 4 * 3 * (size_t)F                     // w_plane | b_fc1 | w_fc2
         + 2 * (size_t)P * (k * C + 8)           // warped visuals
         + 4 * (size_t)P * (6 * k + 2)           // metadata
         + 8 * (size_t)P * k                     // sample positions
         + 4 * (size_t)P                         // cotangent
         + 4 * (size_t)WARPS * 3 * F             // the warps' column sums
         + (2 * 2 * P * LDH > 4 * P * LDA ? 2 * 2 * (size_t)P * LDH : 4 * (size_t)P * LDA);
}

constexpr int LDV = KMAX * C + 8;  // bf16 row stride of W_vis^T and the visual stage (240 B)
constexpr int LDM = 6 * KMAX + 2;  // f32 row stride of the metadata stage
constexpr size_t OFF_WV = 2 * (size_t)F * LDH;            // after W1^T [F][LDH]
constexpr size_t OFF_WM = OFF_WV + 2 * (size_t)F * LDV;   // W_vis^T [F][LDV]
constexpr size_t OFF_VEC = OFF_WM + 4 * (size_t)6 * KMAX * F;
constexpr size_t OFF_VIS = OFF_VEC + 4 * 3 * (size_t)F;
constexpr size_t OFF_META = OFF_VIS + 2 * (size_t)P * LDV;
constexpr size_t OFF_XY = OFF_META + 4 * (size_t)P * LDM;
constexpr size_t OFF_CT = OFF_XY + 8 * (size_t)P * KMAX;
constexpr size_t OFF_KEEP = OFF_CT + 4 * (size_t)P;
constexpr size_t OFF_UN = OFF_KEEP + 4 * (size_t)WARPS * 3 * F;  // h1 | dh2p, or the f32 dacc
constexpr size_t SMEM = layout_bytes(KMAX);
static_assert(OFF_UN + 2 * 2 * (size_t)P * LDH <= SMEM && OFF_UN + 4 * (size_t)P * LDA <= SMEM,
              "layout");

// a 16 x 64 half of the warp's accumulator rows (n-tiles t < 8), rounded
// to bf16, into a [P][LDH] stage: lane (g, q) writes rows row, row + 8 from
// column col (= first column + 2q) on
__device__ __forceinline__ void stage_half(const float (*c)[4], __nv_bfloat16* S, int row,
                                           int col) {
  uint32_t* r0 = reinterpret_cast<uint32_t*>(S + row * LDH + col);
  uint32_t* r1 = reinterpret_cast<uint32_t*>(S + (row + 8) * LDH + col);
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    r0[4 * t] = pack_bf16(c[t][0], c[t][1]);
    r1[4 * t] = pack_bf16(c[t][2], c[t][3]);
  }
}

// v summed over the 8 lanes of a quad column (the warp's 16 pixel rows)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// keep[f] += v summed over the warp's rows, for column f = 8t + 2q + e of an
// accumulator; lane (g, q) adds the sums of the n-tiles t = 2g, 2g+1
__device__ __forceinline__ void keep_col_sum(float v, float* keep, int t, int e, int g, int q) {
  v = rows_sum(v);
  if ((t >> 1) == g) keep[8 * t + 2 * q + e] += v;
}

__global__ void __launch_bounds__(THREADS, 1) fused_volume_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ cur,     // (B, H, W, C)
    const __nv_bfloat16* __restrict__ src,     // (B, K, H, W, C)
    const float* __restrict__ A,               // (B, K, 3, 3)
    const float* __restrict__ bvec,            // (B, K, 3)
    const float* __restrict__ origins,         // (B, K, 3)
    const float* __restrict__ invK,            // (B, 3, 3)
    const float* __restrict__ planes,          // (D,)
    const float* __restrict__ base,            // (B, H, F, W)
    const __nv_bfloat16* __restrict__ w_visT,  // (F, K*C)
    const float* __restrict__ w_metaT,         // (F, K*8)
    const float* __restrict__ w_plane,         // (F,)
    const __nv_bfloat16* __restrict__ w_fc1T,  // (F, F), row j = output j
    const float* __restrict__ b_fc1,           // (F,)
    const float* __restrict__ w_fc2,           // (F,)
    const float* __restrict__ ct,              // (B, D, H, W) volume cotangent
    float* __restrict__ dbase,                 // (B, H, F, W), zeroed
    float* __restrict__ dcur,                  // (B, H, W, C)
    float* __restrict__ dsrc,                  // (B, K, H, W, C), zeroed
    float* __restrict__ slabs,                 // (gridDim.x, slab_len(K)), zeroed
    int B, int K, int H, int W, int D) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [F][LDH]
  __nv_bfloat16* s_wv = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_WV);  // [F][LDV]
  float* s_wm = reinterpret_cast<float*>(smem_tc + OFF_WM);          // [6K][F]
  float* s_plane = reinterpret_cast<float*>(smem_tc + OFF_VEC);
  float* s_b1 = s_plane + F;
  float* s_w2 = s_b1 + F;
  __nv_bfloat16* s_vis = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_VIS);  // [P][LDV]
  float* s_meta = reinterpret_cast<float*>(smem_tc + OFF_META);                // [P][LDM]
  float2* s_xy = reinterpret_cast<float2*>(smem_tc + OFF_XY);                  // [P][KMAX]
  float* s_ct = reinterpret_cast<float*>(smem_tc + OFF_CT);                    // [P]
  float* s_keep = reinterpret_cast<float*>(smem_tc + OFF_KEEP);                // [WARPS][3][F]
  __nv_bfloat16* s_h1 = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_UN);    // [P][LDH]
  __nv_bfloat16* s_dh2p = s_h1 + P * LDH;                                       // [P][LDH]
  float* s_dacc = reinterpret_cast<float*>(smem_tc + OFF_UN);                  // [P][LDA]
  const int KC = K * C, KM = 6 * K;

  const int tid = threadIdx.x;
  for (int i = tid; i < F * F / 8; i += THREADS)
    *reinterpret_cast<uint4*>(s_w1 + (i / (F / 8)) * LDH + (i % (F / 8)) * 8) =
        reinterpret_cast<const uint4*>(w_fc1T)[i];
  for (int i = tid; i < F * KC / 8; i += THREADS)
    *reinterpret_cast<uint4*>(s_wv + (i / (KC / 8)) * LDV + (i % (KC / 8)) * 8) =
        reinterpret_cast<const uint4*>(w_visT)[i];
  for (int i = tid; i < KM * F; i += THREADS) {
    const int f = i % F, j = i / F;
    s_wm[i] = w_metaT[f * (K * 8) + (j / NMETA) * 8 + (j % NMETA)];
  }
  for (int i = tid; i < F; i += THREADS) {
    s_plane[i] = w_plane[i];
    s_b1[i] = b_fc1[i];
    s_w2[i] = w_fc2[i];
  }
  for (int i = tid; i < WARPS * 3 * F; i += THREADS) s_keep[i] = 0.f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * warp;  // the warp's first pixel row in the tile
  float* slab = slabs + (long long)blockIdx.x * slab_len(K);
  float* g_fc1 = slab;                           // fragment order, [WARPS][NT][32][4]
  float* g_vis = g_fc1 + F * F;                  // fragment order, [WARPS][2K][32][4]
  float* g_meta = g_vis + (long long)F * KC;     // [F][K*8]
  float* g_vec = g_meta + (long long)F * K * 8;  // dw_plane | db_fc1 | dw_fc2 | db_fc2

  // per-lane ldmatrix offsets (elements) of the operand patterns below
  const int o_vis = frag_off(LDV, lane, true) + row0 * LDV;  // A: vis rows
  const int o_rows = frag_off(LDH, lane, true) + row0 * LDH; // A: h1 or dh2p rows
  const int o_wv = frag_off(LDV, lane, false);               // B: W_vis^T as [f][kc]
  const int o_wvT = frag_off(LDV, lane, true);               // B: W_vis as [f][kc], .trans
  const int o_w1 = frag_off(LDH, lane, false);               // B: W1^T as [j][f]
  const int o_w1T = frag_off(LDH, lane, true);               // B: W1 as [j][f], .trans
  const int o_hA = frag_off(LDH, lane, false) + row0;        // A: dh2p^T from [p][j], .trans
  const int o_hB = frag_off(LDH, lane, true);                // B: h1 from [p][f], .trans
  const int o_vB = frag_off(LDV, lane, true);                // B: vis from [p][kc], .trans

  // the warp's column sums dw_plane | db_fc1 | dw_fc2, kept in shared memory
  float* keep = s_keep + warp * 3 * F;
  float db2 = 0.f;  // the cotangent's sum over pixel tid of every tile
  const int mf = 4 * (tid & 31), mk = tid >> 5;  // dW_metaT: rows mf..mf+3, view mk

  const long long HW = (long long)H * W;
  const long long npix = (long long)B * HW;
  const long long ntiles = (npix + P - 1) / P;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long tpix = tile * P;
    // the lane's two pixel rows, row0 + g and row0 + g + 8 (pixel tpix + row)
    bool valid[2];
    long long boff[2];
    int bimg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long pix = tpix + row0 + g + 8 * r;
      valid[r] = pix < npix;
      const long long pp = valid[r] ? pix : 0;
      const int u = (int)(pp % W), v = (int)((pp / W) % H);
      bimg[r] = (int)(pp / HW);
      boff[r] = ((long long)(bimg[r] * H + v) * F) * W + u;
    }
    // the thread's pixel tid % P in the coalesced dbase update
    const long long upix = tpix + tid % P;
    const bool uvalid = upix < npix;
    float* ubase = dbase + (uvalid ? ((upix / W) * F) * W + upix % W : 0);

    for (int d = 0; d < D; ++d) {
      const float dep = planes[d];

      // ---- A. sample every (pixel, view) of the tile once
#pragma unroll 1
      for (int s = tid; s < P * K; s += THREADS) {
        const int k = s / P, p = s % P;
        const long long px = tpix + p;
        float val[C], m6[NMETA];
        float2 xy = make_float2(0.f, 0.f);
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
        for (int j = 0; j < NMETA; ++j) m6[j] = 0.f;
        if (px < npix) {
          const int u = (int)(px % W), v = (int)((px / W) % H), bi = (int)(px / HW);
          const int bk = bi * K + k;
          const float uu = u + 0.5f, vv = v + 0.5f;
          const ViewSample sp = warp_point(A + bk * 9, bvec + bk * 3, uu, vv, dep, H, W);
          sample16(src + (long long)bk * HW * C, sp.x, sp.y, H, W, val);
          const float* ik = invK + bi * 9;
          const float r0 = ik[0] * uu + (ik[1] * vv + ik[2]);
          const float r1 = ik[3] * uu + (ik[4] * vv + ik[5]);
          const float r2 = ik[6] * uu + (ik[7] * vv + ik[8]);
          const float rn2 = r0 * r0 + r1 * r1 + r2 * r2;
          view_rays(r0, r1, r2, rn2, rsqrtf(rn2), origins + bk * 3, dep, m6 + 2);
          m6[0] = sp.z;
          m6[1] = dot16(cur + px * C, val);  // the unrounded warp, as the JAX kernel
          xy = make_float2(sp.x, sp.y);
        }
        uint4 packed[2];
        uint32_t* pw = reinterpret_cast<uint32_t*>(packed);
#pragma unroll
        for (int i = 0; i < C / 2; ++i) pw[i] = pack_bf16(val[2 * i], val[2 * i + 1]);
        uint4* vrow = reinterpret_cast<uint4*>(s_vis + p * LDV + k * C);
        vrow[0] = packed[0];
        vrow[1] = packed[1];
        float2* mrow = reinterpret_cast<float2*>(s_meta + p * LDM + k * NMETA);
        mrow[0] = make_float2(m6[0], m6[1]);
        mrow[1] = make_float2(m6[2], m6[3]);
        mrow[2] = make_float2(m6[4], m6[5]);
        s_xy[p * KMAX + k] = xy;
      }
      if (tid < P) {
        const long long px = tpix + tid;
        float c = 0.f;
        if (px < npix) {
          const long long bi = px / HW, vu = px % HW;
          c = ct[(bi * D + d) * HW + vu];
        }
        s_ct[tid] = c;
        db2 += c;
      }
      __syncthreads();

      // ---- B. the warp's 16 rows, each product in two halves of 64 output
      // columns (32 accumulator registers at a time). fc0: base + plane
      // term, vis W_vis^T on tensor cores, the metadata in f32; h1 =
      // leaky(acc) rounded to its stage; leaky'(acc) kept as bits
      uint32_t pos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float acc[NT / 2][4];
#pragma unroll
        for (int t = 0; t < NT / 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = 64 * h + 8 * t + 2 * q + e;
            const float pl = s_plane[f] * dep;
            acc[t][e] = valid[0] ? base[boff[0] + (long long)f * W] + pl : 0.f;
            acc[t][2 + e] = valid[1] ? base[boff[1] + (long long)f * W] + pl : 0.f;
          }
#pragma unroll 1
        for (int ks = 0; ks < K; ++ks) {  // one k-slice of 16 per view
          uint32_t a[4];
          ldsm4(a, s_vis + o_vis + ks * 16);
#pragma unroll
          for (int t2 = 0; t2 < NT / 4; ++t2) {
            uint32_t b[4];
            ldsm4(b, s_wv + o_wv + (64 * h + 16 * t2) * LDV + ks * 16);
            mma(acc[2 * t2], a, b[0], b[1]);
            mma(acc[2 * t2 + 1], a, b[2], b[3]);
          }
        }
        const float* m0 = s_meta + (row0 + g) * LDM;
        const float* m1 = m0 + 8 * LDM;
#pragma unroll 3
        for (int j = 0; j < KM; ++j) {
          const float x0 = m0[j], x1 = m1[j];
          const float* wr = s_wm + j * F + 64 * h + 2 * q;
#pragma unroll
          for (int t = 0; t < NT / 2; ++t) {
            const float2 w2 = *reinterpret_cast<const float2*>(wr + 8 * t);
            acc[t][0] += x0 * w2.x;
            acc[t][1] += x0 * w2.y;
            acc[t][2] += x1 * w2.x;
            acc[t][3] += x1 * w2.y;
          }
        }
        pos[h] = 0u;
#pragma unroll
        for (int t = 0; t < NT / 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (acc[t][e] > 0.f) pos[h] |= 1u << (t * 4 + e);
            acc[t][e] = leaky(acc[t][e]);
          }
        stage_half(acc, s_h1, row0 + g, 64 * h + 2 * q);
      }
      __syncwarp();

      // fc1 on tensor cores, then dh2p, the column sums of the fc2 and
      // fc1-bias gradients (f32), and dh2p rounded to its stage
      {
        const float ct0 = s_ct[row0 + g], ct1 = s_ct[row0 + g + 8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a2[NT / 2][4];
#pragma unroll
          for (int t = 0; t < NT / 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) a2[t][e] = 0.f;
#pragma unroll 1
          for (int s = 0; s < KS; ++s) {
            uint32_t a[4];
            ldsm4(a, s_h1 + o_rows + s * 16);
#pragma unroll
            for (int t2 = 0; t2 < NT / 4; ++t2) {
              uint32_t b[4];
              ldsm4(b, s_w1 + o_w1 + (64 * h + 16 * t2) * LDH + s * 16);
              mma(a2[2 * t2], a, b[0], b[1]);
              mma(a2[2 * t2 + 1], a, b[2], b[3]);
            }
          }
#pragma unroll
          for (int t = 0; t < NT / 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 64 * h + 8 * t + 2 * q + e;
              const float h0 = a2[t][e] + s_b1[j], h1v = a2[t][2 + e] + s_b1[j];
              const float sw2 = leaky(h0) * ct0 + leaky(h1v) * ct1;
              a2[t][e] = s_w2[j] * ct0 * leaky_slope(h0);
              a2[t][2 + e] = s_w2[j] * ct1 * leaky_slope(h1v);
              keep_col_sum(a2[t][e] + a2[t][2 + e], keep + F, 8 * h + t, e, g, q);
              keep_col_sum(sw2, keep + 2 * F, 8 * h + t, e, g, q);
            }
          stage_half(a2, s_dh2p, row0 + g, 64 * h + 2 * q);
        }
      }
      __syncthreads();

      // ---- C1. dW_fc1T[j][f] += sum_p dh2p[p][j] h1[p][f]: rows j of warp w,
      // in two halves of f
      {
        float* gw = g_fc1 + ((long long)warp * NT * 32 + lane) * 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float gacc[NT / 2][4];
#pragma unroll
          for (int t = 0; t < NT / 2; ++t) {
            const float4 v = *reinterpret_cast<const float4*>(gw + (half * NT / 2 + t) * 128);
            gacc[t][0] = v.x;
            gacc[t][1] = v.y;
            gacc[t][2] = v.z;
            gacc[t][3] = v.w;
          }
#pragma unroll 1
          for (int ks = 0; ks < P / 16; ++ks) {
            uint32_t a[4];
            ldsm4_t(a, s_dh2p + o_hA + ks * 16 * LDH);
#pragma unroll
            for (int t2 = 0; t2 < NT / 4; ++t2) {
              uint32_t b[4];
              ldsm4_t(b, s_h1 + o_hB + ks * 16 * LDH + half * (F / 2) + 16 * t2);
              mma(gacc[2 * t2], a, b[0], b[1]);
              mma(gacc[2 * t2 + 1], a, b[2], b[3]);
            }
          }
#pragma unroll
          for (int t = 0; t < NT / 2; ++t)
            *reinterpret_cast<float4*>(gw + (half * NT / 2 + t) * 128) =
                make_float4(gacc[t][0], gacc[t][1], gacc[t][2], gacc[t][3]);
        }
      }

      // ---- B, continued: dh1 = bf16(dh2p) W1 on tensor cores, in two halves
      // of f. The warp's dh2p rows as A fragments, read before the stage is
      // released to the f32 dacc stage
      uint32_t dh2f[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) ldsm4(dh2f[s], s_dh2p + o_rows + s * 16);
      __syncthreads();  // every warp is done with the h1 | dh2p stage
      float ddot[7][2];  // dacc W_dot (f32) per view (K <= 7), the two rows
#pragma unroll
      for (int k = 0; k < 7; ++k) ddot[k][0] = ddot[k][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dacc[NT / 2][4];
#pragma unroll
        for (int t = 0; t < NT / 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[t][e] = 0.f;
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int t2 = 0; t2 < NT / 4; ++t2) {
            uint32_t b[4];
            ldsm4_t(b, s_w1 + o_w1T + s * 16 * LDH + 64 * h + 16 * t2);
            mma(dacc[2 * t2], dh2f[s], b[0], b[1]);
            mma(dacc[2 * t2 + 1], dh2f[s], b[2], b[3]);
          }
        // dacc = dh1 leaky'(acc): to the f32 stage (for dvis, dbase, dW_visT
        // and dW_metaT), dw_plane and ddot
        float* r0p = s_dacc + (row0 + g) * LDA + 64 * h + 2 * q;
        float* r1p = r0p + 8 * LDA;
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!((pos[h] >> (t * 4 + e)) & 1u)) dacc[t][e] *= 0.01f;
          *reinterpret_cast<float2*>(r0p + 8 * t) = make_float2(dacc[t][0], dacc[t][1]);
          *reinterpret_cast<float2*>(r1p + 8 * t) = make_float2(dacc[t][2], dacc[t][3]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            keep_col_sum((dacc[t][e] + dacc[t][2 + e]) * dep, keep, 8 * h + t, e, g, q);
          }
        }
#pragma unroll
        for (int k = 0; k < 7; ++k)
          if (k < K) {
            const float* wd = s_wm + (k * NMETA + 1) * F + 64 * h + 2 * q;
#pragma unroll
            for (int t = 0; t < NT / 2; ++t) {
              const float2 w2 = *reinterpret_cast<const float2*>(wd + 8 * t);
              ddot[k][0] += dacc[t][0] * w2.x + dacc[t][1] * w2.y;
              ddot[k][1] += dacc[t][2] * w2.x + dacc[t][3] * w2.y;
            }
          }
      }
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (k < K) {
          ddot[k][0] = quad_sum(ddot[k][0]);
          ddot[k][1] = quad_sum(ddot[k][1]);
        }
      __syncwarp();
      // the warp's dacc rows, rounded, as the A fragments of dvis
      uint32_t dac[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float* d0 = s_dacc + (row0 + g) * LDA + 16 * s + 2 * q;
        const float2 x00 = *reinterpret_cast<const float2*>(d0);
        const float2 x10 = *reinterpret_cast<const float2*>(d0 + 8 * LDA);
        const float2 x01 = *reinterpret_cast<const float2*>(d0 + 8);
        const float2 x11 = *reinterpret_cast<const float2*>(d0 + 8 * LDA + 8);
        dac[s][0] = pack_bf16(x00.x, x00.y);
        dac[s][1] = pack_bf16(x10.x, x10.y);
        dac[s][2] = pack_bf16(x01.x, x01.y);
        dac[s][3] = pack_bf16(x11.x, x11.y);
      }

      // per view: dvis = bf16(dacc) W_vis (tensor), dcur, and the scatter of
      // dvis + cur ddot through the bilinear taps
      float dc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        float dv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          uint32_t b[4];
          ldsm4_t(b, s_wv + o_wvT + s * 16 * LDV + k * C);
          mma(dv[0], dac[s], b[0], b[1]);
          mma(dv[1], dac[s], b[2], b[3]);
        }
        float dd[2] = {0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 7; ++kk)
          if (kk == k) {
            dd[0] = ddot[kk][0];
            dd[1] = ddot[kk][1];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = row0 + g + 8 * r;
          const __nv_bfloat16* vr = s_vis + p * LDV + k * C;
          const float2 v0 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + 2 * q));
          const float2 v1 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + 8 + 2 * q));
          dc[r][0] += v0.x * dd[r];
          dc[r][1] += v0.y * dd[r];
          dc[r][2] += v1.x * dd[r];
          dc[r][3] += v1.y * dd[r];
          // channels 2q, 2q+1 | 2q+8, 2q+9; pairs of lanes swap halves so
          // that each lane scatters four consecutive channels
          const __nv_bfloat16* cp = cur + (valid[r] ? tpix + p : 0) * C;
          const float2 c0 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cp + 2 * q));
          const float2 c1 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cp + 8 + 2 * q));
          const float a0 = dv[0][2 * r] + c0.x * dd[r];
          const float a1 = dv[0][2 * r + 1] + c0.y * dd[r];
          const float b0 = dv[1][2 * r] + c1.x * dd[r];
          const float b1 = dv[1][2 * r + 1] + c1.y * dd[r];
          const bool odd = q & 1;
          const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
          const float4 v4 = odd ? make_float4(x0, x1, b0, b1) : make_float4(a0, a1, x0, x1);
          const int ch = odd ? 2 * q + 6 : 2 * q;
          if (!valid[r]) continue;
          const float2 xy = s_xy[p * KMAX + k];
          const float x0f = floorf(xy.x), y0f = floorf(xy.y);
          const float fx = xy.x - x0f, fy = xy.y - y0f;
          const int xi0 = (int)x0f, yi0 = (int)y0f;
          float* img = dsrc + ((long long)bimg[r] * K + k) * HW * C + ch;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int yi = yi0 + dy;
            if (yi < 0 || yi >= H) continue;
            const float wy = dy ? fy : 1.f - fy;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const int xi = xi0 + dx;
              if (xi < 0 || xi >= W) continue;
              const float wt = (dx ? fx : 1.f - fx) * wy;
              atomic_add4(img + ((long long)yi * W + xi) * C,
                          make_float4(wt * v4.x, wt * v4.y, wt * v4.z, wt * v4.w));
            }
          }
        }
      }
      {  // dcur: each (pixel, channel) has one owner; all loads before the stores
        float2* dp0 = reinterpret_cast<float2*>(dcur + (valid[0] ? tpix + row0 + g : 0) * C + 2 * q);
        float2* dp1 = reinterpret_cast<float2*>(dcur + (valid[1] ? tpix + row0 + g + 8 : 0) * C + 2 * q);
        const float2 o00 = dp0[0], o01 = dp0[4], o10 = dp1[0], o11 = dp1[4];
        if (valid[0]) {
          dp0[0] = make_float2(o00.x + dc[0][0], o00.y + dc[0][1]);
          dp0[4] = make_float2(o01.x + dc[0][2], o01.y + dc[0][3]);
        }
        if (valid[1]) {
          dp1[0] = make_float2(o10.x + dc[1][0], o10.y + dc[1][1]);
          dp1[4] = make_float2(o11.x + dc[1][2], o11.y + dc[1][3]);
        }
      }
      __syncthreads();  // the f32 dacc stage is complete

      // dbase[pixel][f] += dacc: thread (pixel tid % P, f = tid / P + 2i),
      // a warp's 32 pixels coalesced, in two batches of 32 loads in flight
      if (uvalid) {
        const float* da = s_dacc + (tid % P) * LDA + tid / P;
        float* db = ubase + (long long)(tid / P) * W;
#pragma unroll
        for (int b0 = 0; b0 < F / 2; b0 += 32) {
          float o[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = db[(long long)(2 * (b0 + i)) * W];
#pragma unroll
          for (int i = 0; i < 32; ++i) db[(long long)(2 * (b0 + i)) * W] = o[i] + da[2 * (b0 + i)];
        }
      }

      // ---- C2. dW_visT[f][kc] += sum_p bf16(dacc[p][f]) vis[p][kc]: rows f of
      // warp w, views 0-3 then 4-6; the A fragments are built from the f32
      // stage, rounded
#pragma unroll 1
      for (int k0 = 0; k0 < K; k0 += 4) {
        float gv[8][4];
        float* gw = g_vis + (((long long)warp * 2 * K + 2 * k0) * 32 + lane) * 4;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (k0 + t / 2 < K) {
            const float4 v = *reinterpret_cast<const float4*>(gw + t * 128);
            gv[t][0] = v.x;
            gv[t][1] = v.y;
            gv[t][2] = v.z;
            gv[t][3] = v.w;
          }
#pragma unroll 1
        for (int ks = 0; ks < P / 16; ++ks) {
          const float* da = s_dacc + (16 * ks + 2 * q) * LDA + row0 + g;
          uint32_t a[4];
          a[0] = pack_bf16(da[0], da[LDA]);
          a[1] = pack_bf16(da[8], da[LDA + 8]);
          a[2] = pack_bf16(da[8 * LDA], da[9 * LDA]);
          a[3] = pack_bf16(da[8 * LDA + 8], da[9 * LDA + 8]);
#pragma unroll
          for (int t2 = 0; t2 < 4; ++t2)
            if (k0 + t2 < K) {
              uint32_t b[4];
              ldsm4_t(b, s_vis + o_vB + ks * 16 * LDV + 16 * (k0 + t2));
              mma(gv[2 * t2], a, b[0], b[1]);
              mma(gv[2 * t2 + 1], a, b[2], b[3]);
            }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (k0 + t / 2 < K)
            *reinterpret_cast<float4*>(gw + t * 128) =
                make_float4(gv[t][0], gv[t][1], gv[t][2], gv[t][3]);
      }

      // ---- C3. dW_metaT[f][6k+i] += sum_p dacc[p][f] meta[p][6k+i], f32,
      // each element of the slab owned by one thread
      if (mk < K) {
        float sm6[4][NMETA];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NMETA; ++j) sm6[i][j] = 0.f;
        const float* mcol = s_meta + mk * NMETA;
#pragma unroll 8
        for (int p = 0; p < P; ++p) {
          const float4 a4 = *reinterpret_cast<const float4*>(s_dacc + p * LDA + mf);
          const float2* m2 = reinterpret_cast<const float2*>(mcol + p * LDM);
          const float2 ma = m2[0], mb = m2[1], mc = m2[2];
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float mv[NMETA] = {ma.x, ma.y, mb.x, mb.y, mc.x, mc.y};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NMETA; ++j) sm6[i][j] += av[i] * mv[j];
        }
        float* gm = g_meta + (long long)mf * (K * 8) + mk * 8;
        float old[4][NMETA];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NMETA; ++j) old[i][j] = gm[i * (K * 8) + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NMETA; ++j) gm[i * (K * 8) + j] = old[i][j] + sm6[i][j];
      }
      __syncthreads();  // the stages are rewritten by the next plane
    }
  }

  // the vector gradients: the warps' column sums combined in warp order
  // (columns 6, 7 of each view of dW_metaT stay zero)
  float* s_db2 = s_dacc;
  if (tid < P) s_db2[tid] = db2;
  __syncthreads();
  for (int i = tid; i < 3 * F; i += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += s_keep[w * 3 * F + i];
    g_vec[i] = s;  // i / F: dw_plane, db_fc1, dw_fc2
  }
  if (tid == 0) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += s_db2[p];
    g_vec[3 * F] = s;
  }
}

}  // namespace tc

size_t smem_bytes_bf16(int K) { return tc::layout_bytes(K > tc::KMAX ? K : tc::KMAX); }

// Position in a slab of element i of the natural layout (dW_fc1T (F, F) |
// dW_visT (F, K*C) | dW_metaT | vectors): the tensor-core kernel keeps its
// first two gradients in mma fragment order, [warp][n-tile][lane][4].
__device__ __forceinline__ long long frag_pos(long long i, int K) {
  long long base = 0;
  int ncols = F;
  if (i >= (long long)F * F) {
    if (i >= (long long)F * F + (long long)F * K * C) return i;
    base = (long long)F * F;
    ncols = K * C;
  }
  const long long j = i - base;
  const int m = (int)(j / ncols), n = (int)(j % ncols);
  const int r = m & 15, c = n & 7;
  const int lane = (r & 7) * 4 + (c >> 1), elem = (r >> 3) * 2 + (c & 1);
  return base + (((long long)(m >> 4) * (ncols / 8) + (n >> 3)) * 32 + lane) * 4 + elem;
}

// out[i] = sum over the slabs, in slab order, of element i (natural layout)
__global__ void sum_slabs_kernel(const float* __restrict__ slabs, int nslabs, long long len,
                                 int frag_K, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const long long at = frag_K > 0 ? frag_pos(i, frag_K) : i;
  float s = 0.f;
  for (int p = 0; p < nslabs; ++p) s += slabs[(long long)p * len + at];
  out[i] = s;
}

template <typename T>
int launch(const void* cur, const void* src, const void* A, const void* b, const void* origins,
           const void* invK, const void* planes, const void* base, const void* w_visT,
           const void* w_metaT, const void* w_plane, const void* w_fc1T, const void* b_fc1,
           const void* w_fc2, const void* ct, void* dbase, void* dcur, void* dsrc, void* slabs,
           void* grads, int nslabs, int B, int K, int H, int W, int D, void* stream) {
  if ((long long)B * H * W == 0 || nslabs <= 0) return 0;
  constexpr bool low = sizeof(T) == 2;
  const size_t smem = low ? smem_bytes_bf16(K) : smem_bytes_f32(K);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if constexpr (low) {
    if (K > tc::KMAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(tc::fused_volume_bwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tc::fused_volume_bwd_bf16_kernel<<<nslabs, tc::THREADS, smem, s>>>(
        (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
        (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
        (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
        (const float*)w_fc2, (const float*)ct, (float*)dbase, (float*)dcur, (float*)dsrc,
        (float*)slabs, B, K, H, W, D);
  } else {
    err = cudaFuncSetAttribute(fused_volume_bwd_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_volume_bwd_f32_kernel<<<nslabs, TP, smem, s>>>(
        (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
        (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
        (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
        (const float*)w_fc2, (const float*)ct, (float*)dbase, (float*)dcur, (float*)dsrc,
        (float*)slabs, B, K, H, W, D);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long len = slab_len(K);
  sum_slabs_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(
      (const float*)slabs, nslabs, len, low ? K : 0, (float*)grads);
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

// Pixels per tile, of which a launch takes at most one block each: the f32
// kernel (bf16 == 0) or the tensor-core kernel
extern "C" int fused_metadata_volume_bwd_tile(int bf16) { return bf16 ? tc::P : TP; }

// Dynamic shared memory of one block: the f32 kernel (bf16 == 0) or the
// tensor-core kernel
extern "C" long long fused_metadata_volume_bwd_smem_bytes(int K, int bf16) {
  return (long long)(bf16 ? smem_bytes_bf16(K) : smem_bytes_f32(K));
}

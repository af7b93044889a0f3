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
// is compute-bound. What the TPU kernel did to feed its matrix unit (one-hot
// gather matmuls, plane groups of 8/16, lane padding, y-band chunks) does not
// carry over; a bilinear tap is a direct 16-channel vector load from the NHWC
// source.
//
// Two instantiations, chosen by the features' dtype:
// - bf16 (the eval and training paths): tensor cores, namespace tc below.
// - f32: one thread per point on CUDA cores, kept for the f32 GPU-vs-CPU
//   checks, whose bounds leave no room for TF32. A thread keeps its 128
//   hidden units in registers; all fc0/fc1 weights sit in shared memory as
//   f32, so every weight read is a warp-wide broadcast feeding four FMAs per
//   16-byte load; persistent blocks walk the points with a grid-stride loop.
// Both take at most 7 source views (tc::KMAX), as the backward does.

#include "fused_volume_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fv;

constexpr int THREADS = 256;

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
      const ViewSample sp = warp_point(A + bk * 9, bvec + bk * 3, uu, vv, dep, H, W);
      float val[C];
      sample16(src + (long long)bk * HW * C, sp.x, sp.y, H, W, val);

      // fc0 rows of the warped source visuals, rounded to T first (the JAX
      // kernel's operand, implicit_depth_tpu/ops/fused_volume.py:207); the
      // dot metadata below takes the unrounded samples, as there
      const float* wv = s_vis + k * C * F;
#pragma unroll
      for (int c = 0; c < C; ++c) axpy_row(round_to<T>(val[c]), wv + c * F, h);

      // closed-form metadata
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

    // h1, rounded to T as fc1's operand (:239)
#pragma unroll
    for (int f = 0; f < F; ++f) h[f] = round_to<T>(h[f] > 0.f ? h[f] : 0.01f * h[f]);

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

// ---------------------------------------------------------------- bf16: tensor cores
//
// A work unit is (tile of P = 128 consecutive pixels of the flattened
// (b, v, u), group of G = 8 consecutive planes); persistent blocks of 8 warps
// walk the units, so that the card fills at b=1 (96 tiles x 8 groups) as at
// b=12, and every output point has one writer. Per plane:
//   A. the block samples every (pixel, view) of the tile once: the warped
//      visuals go to shared memory as bf16 (P x K*C, the JAX kernel's
//      rounding at :207), the six metadata values as f32, the dot taking the
//      unrounded warp (:210). A thread samples one pixel (tid % P) in every
//      other view; its ray and current features are read once per unit.
//   B. warp w owns pixel rows 16w..16w+15. fc0 in two halves of 64 output
//      columns (32 accumulators live): base + dep w_plane, vis W_vis^T on
//      tensor cores (mma.sync m16n8k16, ldmatrix operands, f32
//      accumulation), meta W_meta^T in f32 FMA (:234). h1 = leaky(acc),
//      rounded to bf16 (:239) and packed: two adjacent accumulator tiles are
//      one A fragment of fc1, so h1 stays in 32 registers, with no stage.
//   C. fc1 on tensor cores in two halves of 64 output columns, + b1,
//      LeakyReLU, the dot with w2 in f32; quad_sum over the row's lanes,
//      + b2, one store per point.
// The sample stages are double-buffered, and the warps take two orders:
// warps 0-3 sample plane d+1 and then run B and C for plane d, warps 4-7 the
// other way round, so that on each of the SM's four schedulers (warps w and
// w+4) one warp waits on its taps while the other computes. One barrier a
// plane: after it, plane d+1's stages are complete and plane d's are free.
// What sets the pace (tools/volume_fwd_ablation.py): the metadata FMAs
// (5,376 a pixel, each lane issuing ten shared-memory loads beside every 32
// of them), then the taps' latency.
// Shared memory, fixed at compile time for up to KMAX views (offsets and
// strides are immediates): W1^T and W_vis^T as bf16 (rows padded by 8 so
// that ldmatrix's eight row reads fall on distinct banks), W_meta as f32 and
// two pairs of sample stages; base is read from device memory (L2) per plane.

namespace tc {

using namespace tcore;

constexpr int P = 128;         // pixels per tile
constexpr int G = 8;           // planes per work unit
constexpr int WARPS = P / 16;  // one 16-row mma tile per warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = F / 8;      // n-tiles of 8 across F
constexpr int KS = F / 16;     // k-slices of 16 across F
constexpr int KMAX = 7;        // source views the shared-memory layout holds
constexpr int LDH = F + 8;     // bf16 row stride of W1^T (272 B)
constexpr int LDV = KMAX * C + 8;  // bf16 row stride of W_vis^T and the visual stage (240 B)
constexpr int LDM = 6 * KMAX + 2;  // f32 row stride of the metadata stage

constexpr size_t OFF_WV = 2 * (size_t)F * LDH;                 // after W1^T [F][LDH]
constexpr size_t OFF_WM = OFF_WV + 2 * (size_t)F * LDV;        // W_vis^T [F][LDV]
constexpr size_t OFF_VEC = OFF_WM + 4 * (size_t)6 * KMAX * F;  // W_meta [6K][F]
constexpr size_t OFF_STAGE = OFF_VEC + 4 * 3 * (size_t)F;      // w_plane | b_fc1 | w_fc2
constexpr size_t VIS_BYTES = 2 * (size_t)P * LDV;              // visuals [P][LDV]
constexpr size_t STAGE_BYTES = VIS_BYTES + 4 * (size_t)P * LDM;  // + metadata [P][LDM]
constexpr size_t SMEM = OFF_STAGE + 2 * STAGE_BYTES;           // two stages

__host__ __device__ inline long long units(long long npix, int D) {
  return (npix + P - 1) / P * ((D + G - 1) / G);
}

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : 0.01f * x; }

__global__ void __launch_bounds__(THREADS, 1) fused_volume_bf16_kernel(
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
    const float* __restrict__ b_fc2,           // (1,)
    float* __restrict__ out,                   // (B, D, H, W)
    int B, int K, int H, int W, int D) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem_tc);           // [F][LDH]
  __nv_bfloat16* s_wv = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_WV);  // [F][LDV]
  float* s_wm = reinterpret_cast<float*>(smem_tc + OFF_WM);                  // [6K][F]
  float* s_plane = reinterpret_cast<float*>(smem_tc + OFF_VEC);
  float* s_b1 = s_plane + F;
  float* s_w2 = s_b1 + F;
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
  const float bias2 = b_fc2[0];
  // (the first unit's barrier after its first A orders these stores before
  // any read)

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * warp;  // the warp's first pixel row in the tile
  const bool sample_first = warp < WARPS / 2;
  // per-lane ldmatrix offsets (elements)
  const int o_vis = frag_off(LDV, lane, true) + row0 * LDV;  // A: vis rows
  const int o_wv = frag_off(LDV, lane, false);               // B: W_vis^T as [f][kc]
  const int o_w1 = frag_off(LDH, lane, false);               // B: W1^T as [j][f]

  const long long HW = (long long)H * W;
  const long long npix = (long long)B * HW;
  const int ngroups = (D + G - 1) / G;
  const long long nunits = units(npix, D);

  for (long long unit = blockIdx.x; unit < nunits; unit += gridDim.x) {
    const long long tpix = (unit / ngroups) * P;
    const int d0 = (int)(unit % ngroups) * G;
    const int d1 = d0 + G < D ? d0 + G : D;

    // The thread's pixel tid % P, which it samples in the views tid / P,
    // tid / P + 2, ...: its ray r = invK (u+.5, v+.5, 1) and current features
    const int pa = tid % P;
    const long long pxa = tpix + pa;
    const bool oka = pxa < npix;
    const long long rowa = oka ? pxa / W : 0;  // b H + v
    const int bia = (int)(rowa / H);
    const float uu = (oka ? (int)(pxa - rowa * W) : 0) + 0.5f, vv = (int)(rowa % H) + 0.5f;
    const float* ik = invK + bia * 9;
    const float r0 = ik[0] * uu + (ik[1] * vv + ik[2]);
    const float r1 = ik[3] * uu + (ik[4] * vv + ik[5]);
    const float r2 = ik[6] * uu + (ik[7] * vv + ik[8]);
    const float rn2 = r0 * r0 + r1 * r1 + r2 * r2;
    const float rinv = rsqrtf(rn2);
    float curv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) curv[c] = 0.f;
    if (oka) accum16(cur + pxa * C, 1.f, curv);
    // the lane's two pixel rows, row0 + g and row0 + g + 8: their base rows
    // and output offsets at plane 0
    bool valid[2];
    long long boff[2], obase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long pix = tpix + row0 + g + 8 * r;
      valid[r] = pix < npix;
      boff[r] = valid[r] ? (pix / W) * F * W + pix % W : 0;
      obase[r] = valid[r] ? (pix / HW) * D * HW + pix % HW : 0;
    }

    // ---- A. sample every (pixel, view) of the tile at plane d into stage s
    auto sample = [&](int d, int s) {
      __nv_bfloat16* s_vis = reinterpret_cast<__nv_bfloat16*>(smem_tc + OFF_STAGE + s * STAGE_BYTES);
      float* s_meta = reinterpret_cast<float*>(smem_tc + OFF_STAGE + s * STAGE_BYTES + VIS_BYTES);
      const float dep = planes[d];
#pragma unroll 1
      for (int k = tid / P; k < K; k += THREADS / P) {
        float val[C], m6[NMETA];
#pragma unroll
        for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
        for (int j = 0; j < NMETA; ++j) m6[j] = 0.f;
        if (oka) {
          const int bk = bia * K + k;
          const ViewSample sp = warp_point(A + bk * 9, bvec + bk * 3, uu, vv, dep, H, W);
          sample16(src + (long long)bk * HW * C, sp.x, sp.y, H, W, val);
          view_rays(r0, r1, r2, rn2, rinv, origins + bk * 3, dep, m6 + 2);
          m6[0] = sp.z;
          float dot = 0.f;  // the unrounded warp, as the JAX kernel
#pragma unroll
          for (int c = 0; c < C; ++c) dot += curv[c] * val[c];
          m6[1] = dot;
        }
        uint4 packed[2];
        uint32_t* pw = reinterpret_cast<uint32_t*>(packed);
#pragma unroll
        for (int i = 0; i < C / 2; ++i) pw[i] = pack_bf16(val[2 * i], val[2 * i + 1]);
        uint4* vrow = reinterpret_cast<uint4*>(s_vis + pa * LDV + k * C);
        vrow[0] = packed[0];
        vrow[1] = packed[1];
        float2* mrow = reinterpret_cast<float2*>(s_meta + pa * LDM + k * NMETA);
        mrow[0] = make_float2(m6[0], m6[1]);
        mrow[1] = make_float2(m6[2], m6[3]);
        mrow[2] = make_float2(m6[4], m6[5]);
      }
    };

    // ---- B and C for the warp's 16 rows at plane d, from stage s
    auto mlp = [&](int d, int s) {
      const __nv_bfloat16* s_vis =
          reinterpret_cast<const __nv_bfloat16*>(smem_tc + OFF_STAGE + s * STAGE_BYTES);
      const float* s_meta =
          reinterpret_cast<const float*>(smem_tc + OFF_STAGE + s * STAGE_BYTES + VIS_BYTES);
      const float dep = planes[d];
      // B. fc0 in two halves of 64 columns; h1 into A fragments of fc1:
      // n-tiles 2s, 2s+1 are k-slice s
      uint32_t h1f[KS][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float acc[NT / 2][4];
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
          const long long fw = (long long)(64 * h + 8 * t + 2 * q) * W;
          const float2 pw = *reinterpret_cast<const float2*>(s_plane + 64 * h + 8 * t + 2 * q);
          const float p0 = pw.x * dep, p1 = pw.y * dep;
          acc[t][0] = base[boff[0] + fw] + p0;
          acc[t][1] = base[boff[0] + fw + W] + p1;
          acc[t][2] = base[boff[1] + fw] + p0;
          acc[t][3] = base[boff[1] + fw + W] + p1;
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
#pragma unroll 6
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
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
          h1f[4 * h + t / 2][2 * (t & 1)] = pack_bf16(leaky(acc[t][0]), leaky(acc[t][1]));
          h1f[4 * h + t / 2][2 * (t & 1) + 1] = pack_bf16(leaky(acc[t][2]), leaky(acc[t][3]));
        }
      }
      // C. fc1 on tensor cores in two halves of 64 columns, + b1,
      // LeakyReLU, the dot with w2 (f32); the rows' sums over the quad
      float o[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a2[NT / 2][4];
#pragma unroll
        for (int t = 0; t < NT / 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) a2[t][e] = 0.f;
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int t2 = 0; t2 < NT / 4; ++t2) {
            uint32_t b[4];
            ldsm4(b, s_w1 + o_w1 + (64 * h + 16 * t2) * LDH + s * 16);
            mma(a2[2 * t2], h1f[s], b[0], b[1]);
            mma(a2[2 * t2 + 1], h1f[s], b[2], b[3]);
          }
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
          const int j = 64 * h + 8 * t + 2 * q;
          const float2 bj = *reinterpret_cast<const float2*>(s_b1 + j);
          const float2 wj = *reinterpret_cast<const float2*>(s_w2 + j);
          o[0] += wj.x * leaky(a2[t][0] + bj.x) + wj.y * leaky(a2[t][1] + bj.y);
          o[1] += wj.x * leaky(a2[t][2] + bj.x) + wj.y * leaky(a2[t][3] + bj.y);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(o[r]) + bias2;
        if (q == 0 && valid[r]) out[obase[r] + d * HW] = v;
      }
    };

    // The previous unit's last barrier freed both stages.
    sample(d0, 0);
    __syncthreads();
    for (int d = d0; d < d1; ++d) {
      const int s = (d - d0) & 1;
#pragma unroll 1
      for (int step = 0; step < 2; ++step) {
        if ((step == 0) == sample_first) {
          if (d + 1 < d1) sample(d + 1, s ^ 1);
        } else {
          mlp(d, s);
        }
      }
      __syncthreads();  // plane d+1's stages are complete, plane d's are free
    }
  }
}

}  // namespace tc

template <typename T>
int launch(const void* cur, const void* src, const void* A, const void* b, const void* origins,
           const void* invK, const void* planes, const void* base, const void* w_visT,
           const void* w_metaT, const void* w_plane, const void* w_fc1T, const void* b_fc1,
           const void* w_fc2, const void* b_fc2, void* out, int B, int K, int H, int W, int D,
           void* stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return 0;
  if (K > tc::KMAX) return (int)cudaErrorInvalidValue;
  constexpr bool low = sizeof(T) == 2;
  const size_t smem = low ? tc::SMEM : smem_bytes(K);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if constexpr (low) {
    err = cudaFuncSetAttribute(tc::fused_volume_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long need = tc::units((long long)B * H * W, D);
    const int grid = (int)(need < sms ? need : sms);
    tc::fused_volume_bf16_kernel<<<grid, tc::THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
        (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
        (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
        (const float*)w_fc2, (const float*)b_fc2, (float*)out, B, K, H, W, D);
  } else {
    err = cudaFuncSetAttribute(fused_volume_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long need = (total + THREADS - 1) / THREADS;
    const int grid = (int)(need < sms ? need : sms);
    fused_volume_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)cur, (const T*)src, (const float*)A, (const float*)b, (const float*)origins,
        (const float*)invK, (const float*)planes, (const float*)base, (const T*)w_visT,
        (const float*)w_metaT, (const float*)w_plane, (const T*)w_fc1T, (const float*)b_fc1,
        (const float*)w_fc2, (const float*)b_fc2, (float*)out, B, K, H, W, D);
  }
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

// Source views a launch takes at most, in either instantiation
extern "C" int fused_metadata_volume_max_views() { return tc::KMAX; }

// Dynamic shared memory of one block: the f32 kernel (bf16 == 0) or the
// tensor-core kernel
extern "C" long long fused_metadata_volume_smem_bytes(int K, int bf16) {
  return (long long)(bf16 ? tc::SMEM : smem_bytes(K));
}

// Pixels per tile and planes per work unit of the tensor-core kernel
extern "C" int fused_metadata_volume_tile() { return tc::P; }
extern "C" int fused_metadata_volume_plane_group() { return tc::G; }

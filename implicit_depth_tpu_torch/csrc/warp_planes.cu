// Plane-sweep warp for Hopper (sm_90a), forward and transpose.
//
// Replaces the TPU kernels implicit_depth_tpu/ops/warp_kernel.py::_warp_kernel
// (wrapper warp_planes) and ::_warp_bwd_kernel (wrapper warp_planes_bwd).
// Same contract: for every source view k' (K' = batch x views, flattened) and
// every output point (plane d, row v, column u),
//     r = planes[d] * (A[k'] (u + .5, v + .5, 1)) + b[k'],  z = max(r2, 1e-5),
//     x = clip(r0 / z - .5, +-2W),  y = clip(r1 / z - .5, +-2H),
// and the output is the bilinear sample of src[k'] (H, W, C) at (x, y) with
// zeros padding: F.grid_sample(align_corners=False, padding_mode="zeros").
//
// The sample position is rounded step by step, without FMA contraction, in
// the order of ops/warp_kernel.py::sample_coords, so that the plain version
// reproduces it bit for bit: where z nears its clamp, x = r0 / z is large and
// a different rounding of r0 or z moves the bilinear weights visibly.
//
// Forward, warp_planes_kernel: one thread per output point (k', d, v, u). The
// four corner taps are direct 16-channel vector loads from the NHWC source
// (32 bytes in bf16, 64 in f32); a corner outside the image adds nothing. The
// blend is f32 and rounds once to the source dtype. Consecutive threads own
// consecutive u, so the 16-channel stores are coalesced.
// What bounds it: bytes. The output is (K', D, H, W, C) and dominates the
// traffic (176 MB in bf16 at K'=7, D=64, 96x128); a source view is 393 KB in
// bf16 and stays in L2. None of the TPU kernel's one-hot MXU gathers,
// bilinear-hat operands, plane groups, lane padding, zero rows or y-band
// chunks carry over: on this card a tap is a load.
//
// Transpose, warp_planes_bwd_kernel: one thread per cotangent point recomputes
// the point's four taps and weights the same way and scatters w * ct into an
// f32 (K', H, W, C) accumulator with float4 atomicAdd (sm_90), four atomics per
// tap. The order of the sums varies from run to run. Bound: bytes (the
// cotangent is read once); the atomics to L2 are what it actually waits on.
// For bf16 cotangents a second kernel rounds the f32 accumulator once to bf16.

#include <type_traits>

#include "fused_volume_common.cuh"

namespace {

using namespace fv;

constexpr int THREADS = 256;

__device__ __forceinline__ void store16(float* p, const float* val) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_float4(val[4 * i], val[4 * i + 1], val[4 * i + 2], val[4 * i + 3]);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return t;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* val) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = pack8(val);
  q[1] = pack8(val + 8);
}

// (k', d, v, u) of the flat point index p, row-major over (K', D, H, W)
struct Point {
  int k, d, v, u;
};

// index-space sample position (x, y) of the pixel centre (uu, vv) on the plane
// at depth dep: p = (a0 uu + a1 vv) + a2 per row of A, r = dep p + b,
// z = max(r2, 1e-5), x = clip(r0 / z - .5, +-2W), y = clip(r1 / z - .5, +-2H)
struct Coords {
  float x, y;
};

__device__ __forceinline__ Coords sample_coords(const float* a, const float* bb, float uu,
                                                float vv, float dep, int H, int W) {
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p = __fadd_rn(__fadd_rn(__fmul_rn(a[3 * i], uu), __fmul_rn(a[3 * i + 1], vv)),
                              a[3 * i + 2]);
    r[i] = __fadd_rn(__fmul_rn(dep, p), bb[i]);
  }
  const float z = fmaxf(r[2], 1e-5f);
  Coords c;
  c.x = fminf(fmaxf(__fsub_rn(__fdiv_rn(r[0], z), 0.5f), -2.f * W), 2.f * W);
  c.y = fminf(fmaxf(__fsub_rn(__fdiv_rn(r[1], z), 0.5f), -2.f * H), 2.f * H);
  return c;
}

__device__ __forceinline__ Point unflatten(long long p, int H, int W, int D) {
  Point q;
  q.u = (int)(p % W);
  long long t = p / W;
  q.v = (int)(t % H);
  t /= H;
  q.d = (int)(t % D);
  q.k = (int)(t / D);
  return q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) warp_planes_kernel(
    const T* __restrict__ src,        // (K', H, W, C)
    const float* __restrict__ A,      // (K', 3, 3)
    const float* __restrict__ bvec,   // (K', 3)
    const float* __restrict__ planes,  // (D,)
    T* __restrict__ out,              // (K', D, H, W, C)
    long long total, int H, int W, int D) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const Point q = unflatten(p, H, W, D);
  const Coords s =
      sample_coords(A + q.k * 9, bvec + q.k * 3, q.u + 0.5f, q.v + 0.5f, planes[q.d], H, W);
  float val[C];
  sample16(src + (long long)q.k * H * W * C, s.x, s.y, H, W, val);
  store16(out + p * C, val);
}

// acc[c] += w * g[c] for the 16 channels at acc (16-byte aligned, f32)
__device__ __forceinline__ void scatter16(float* acc, float w, const float* g) {
  float4* q = reinterpret_cast<float4*>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = make_float4(w * g[4 * i], w * g[4 * i + 1], w * g[4 * i + 2],
                                 w * g[4 * i + 3]);
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

template <typename T>
__global__ void __launch_bounds__(THREADS) warp_planes_bwd_kernel(
    const T* __restrict__ ct,         // (K', D, H, W, C)
    const float* __restrict__ A,      // (K', 3, 3)
    const float* __restrict__ bvec,   // (K', 3)
    const float* __restrict__ planes,  // (D,)
    float* __restrict__ acc,          // (K', H, W, C), zeroed
    long long total, int H, int W, int D) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const Point q = unflatten(p, H, W, D);
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = 0.f;
  accum16(ct + p * C, 1.f, g);
  const Coords s =
      sample_coords(A + q.k * 9, bvec + q.k * 3, q.u + 0.5f, q.v + 0.5f, planes[q.d], H, W);
  const float x0f = floorf(s.x), y0f = floorf(s.y);
  const float fx = s.x - x0f, fy = s.y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  float* base = acc + (long long)q.k * H * W * C;
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
      scatter16(base + ((long long)yi * W + xi) * C, wx * wy, g);
    }
  }
}

// out = bf16(in), 8 values a thread; n8 = number of 8-value groups
__global__ void __launch_bounds__(THREADS) round_to_bf16_kernel(
    const float* __restrict__ in, __nv_bfloat16* __restrict__ out, long long n8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4* src = reinterpret_cast<const float4*>(in) + 2 * i;
  const float4 a = src[0], b = src[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  reinterpret_cast<uint4*>(out)[i] = pack8(v);
}

unsigned int blocks_for(long long n) { return (unsigned int)((n + THREADS - 1) / THREADS); }

template <typename T>
int launch_fwd(const void* src, const void* A, const void* b, const void* planes, void* out,
               int K, int H, int W, int Cn, int D, void* stream) {
  if (Cn != C) return (int)cudaErrorInvalidValue;
  const long long total = (long long)K * D * H * W;
  if (total == 0) return 0;
  warp_planes_kernel<T><<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const float*)A, (const float*)b, (const float*)planes, (T*)out, total, H,
      W, D);
  return (int)cudaGetLastError();
}

// acc: the f32 (K', H, W, C) accumulator; out: the result in ct's dtype (the
// same buffer as acc when that is f32)
template <typename T>
int launch_bwd(const void* ct, const void* A, const void* b, const void* planes, void* acc,
               void* out, int K, int H, int W, int Cn, int D, void* stream) {
  if (Cn != C) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_src = (long long)K * H * W * C;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * n_src, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)K * D * H * W;
  if (total > 0) {
    warp_planes_bwd_kernel<T><<<blocks_for(total), THREADS, 0, st>>>(
        (const T*)ct, (const float*)A, (const float*)b, (const float*)planes, (float*)acc,
        total, H, W, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!std::is_same<T, float>::value && n_src > 0) {
    round_to_bf16_kernel<<<blocks_for(n_src / 8), THREADS, 0, st>>>(
        (const float*)acc, (__nv_bfloat16*)out, n_src / 8);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// C entry points: return cudaGetLastError() of the launches (0 on success);
// cudaErrorInvalidValue for a channel count other than 16.
#define WARP_FWD_ARGS                                                                     \
  const void *src, const void *A, const void *b, const void *planes, void *out, int K, int H, \
      int W, int C, int D, void *stream
#define WARP_BWD_ARGS                                                                    \
  const void *ct, const void *A, const void *b, const void *planes, void *acc, void *out, \
      int K, int H, int W, int C, int D, void *stream

extern "C" int warp_planes_f32(WARP_FWD_ARGS) {
  return launch_fwd<float>(src, A, b, planes, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bf16(WARP_FWD_ARGS) {
  return launch_fwd<__nv_bfloat16>(src, A, b, planes, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bwd_f32(WARP_BWD_ARGS) {
  return launch_bwd<float>(ct, A, b, planes, acc, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bwd_bf16(WARP_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16>(ct, A, b, planes, acc, out, K, H, W, C, D, stream);
}

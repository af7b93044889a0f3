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
// Transpose, warp_planes_bwd_kernel: a gather, source-tile stationary. One
// block owns a tile of 16 x 16 source texels of one view, one thread a texel
// and its 16 channels, and sums them in registers over every plane; each
// output element is written once, in the cotangent's dtype. No global
// atomics, no accumulator in device memory, no second kernel. As on the TPU
// (whose output block for view k stays in VMEM over the scanline axis), each
// output element has one owner; here the plane loop runs inside the block.
// - Candidate boxes (candidate_boxes, f64, once per block for 64 planes, a
//   thread a plane and case): a pixel's taps reach the tile only if its
//   sample lies in the tile grown by one texel. r is affine in (u, v), so "r0 / r2 in [lo, hi]" with r2 > 0
//   is a pair of half-planes, and so is each bound of the clamped case
//   (z = 1e-5); each is loosened by a bound on the forward's f32 rounding of
//   r. The image rectangle clipped by the five half-planes of each case is a
//   convex polygon; its bounding box is the case's box: one for the samples
//   with r2 > 1e-5, one for the clamped ones (empty unless the plane passes
//   within ~1e-3 of the source camera centre, which the inverse homography
//   does not see). A pixel counts in the box of its own case only, so none
//   is added twice. The Python mirror is ops/warp_kernel.py::candidate_boxes.
// - Chunks: the boxes' rows, plane after plane, are packed into chunks of at
//   most NMAX pixels (next_chunk, by thread 0 while the previous chunk's
//   copies fly). A chunk's cotangents go to shared memory by cp.async, each
//   pixel's 16-byte pieces in rotated slots (no bank conflicts among the
//   texels' loads), while each warp recomputes its pixels' samples with
//   sample_coords (the forward's bits) and finds each pixel's cell
//   (floor(x), floor(y)) among the (TW + 1) x (TH + 1) cells whose taps reach
//   the tile.
// - A stable counting sort by cell (per-warp histograms with
//   __match_any_sync, prefixes over the warps and the cells) lists each
//   cell's pixels in pixel order.
// - Each texel thread walks its four cells' lists and adds wx * wy * ct.
// The order of every texel's sum is fixed by (chunk, cell, pixel index), so
// two launches give the same bits. No atomics of any kind: the counts are
// per-warp and ranked with __match_any_sync.
// What bounds it: bytes (the cotangent is read once from HBM, 2.82 GB in
// bf16 at K'=112, D=64, 96x128; the boxes overlap their neighbours' by the
// grown border, read again from L2). What it spends (bf16, K'=112, H100, by
// tools/warp_bwd_ablation.py): the texels' sums ~35%, the samples and cells
// ~18%, the sort and the chunk walk ~23%, the copies ~16%, the boxes ~8%.

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
// z = max(r2, 1e-5), x = clip(r0 / z - .5, +-2W), y = clip(r1 / z - .5, +-2H);
// clamped: r2 <= 1e-5, z at its clamp
struct Coords {
  float x, y;
  bool clamped;
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
  c.clamped = !(r[2] > 1e-5f);
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

// ------------------------------------------------------------ the transpose

namespace bwd {

constexpr int TW = 16, TH = 16;                     // the texels a block owns
constexpr int NT = TW * TH;                         // threads: one per texel
constexpr int WARPS = NT / 32;
constexpr int NCX = TW + 1, NCELL = NCX * (TH + 1);  // cells whose taps reach the tile
constexpr int STAGE_BYTES = 40960;                  // the chunk's cotangents
constexpr int PLANE_GROUP = 64;                     // planes whose boxes are computed together
constexpr int MAXSEG = 8;                           // box segments a chunk
constexpr int NONE = -1;

template <typename T>
__host__ __device__ constexpr int nmax() {  // pixels a chunk holds
  return STAGE_BYTES / (C * (int)sizeof(T));
}

// shared memory: stage | segments | boxes | (fx, fy) | cell + rank << 16 | hist | cell
// starts | cell counts | segment starts | segment counts | list, each part aligned for
// its type
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGE_BYTES + 2 * MAXSEG * 16 + PLANE_GROUP * 2 * 8 + nmax<T>() * (8 + 4 + 2) +
         (WARPS + 2) * NCELL * 4 + (2 * (MAXSEG + 1) + 2) * 4;
}

// a u + b v + c >= 0
struct HalfPlane {
  double a, b, c;
};

// the polygon (xs, ys, n) clipped by h (Sutherland-Hodgman) into (ox, oy);
// returns the new vertex count
__device__ int clip_polygon(const double* xs, const double* ys, int n, HalfPlane h, double* ox,
                            double* oy) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int j = i + 1 == n ? 0 : i + 1;
    const double si = h.a * xs[i] + h.b * ys[i] + h.c;
    const double sj = h.a * xs[j] + h.b * ys[j] + h.c;
    if (si >= 0.0) {
      ox[m] = xs[i];
      oy[m] = ys[i];
      ++m;
    }
    if ((si >= 0.0) != (sj >= 0.0)) {
      const double t = si / (si - sj);
      ox[m] = xs[i] + t * (xs[j] - xs[i]);
      oy[m] = ys[i] + t * (ys[j] - ys[i]);
      ++m;
    }
  }
  return m;
}

// The candidate box (u0, u1, v0, v1) of the tile [tx0, tx1] x [ty0, ty1] on
// the plane at depth dep: for cls 0 it holds every pixel with r2 > 1e-5 whose
// taps reach the tile, for cls 1 every clamped one (r2 <= 1e-5); empty: u0 > u1.
// A tap reaches the tile iff x in [tx0 - 1, tx1 + 1), i.e. s = r0 / z in
// [tx0 - .5, tx1 + 1.5), and likewise y. e[i] bounds the forward's f32
// rounding of r_i over the image (5 ulps of dep |a_i| (W, H, 1) + |b_i|, and
// some), eps its rounding of the divide and the - .5.
__device__ __noinline__ void candidate_boxes(const float* a, const float* bb, float dep, int H,
                                             int W, int tx0, int tx1, int ty0, int ty1,
                                             int cls, short4* box) {
  double R[3][3], e[3];
  const double dp = dep;
  for (int i = 0; i < 3; ++i) {
    const double a0 = a[3 * i], a1 = a[3 * i + 1], a2 = a[3 * i + 2];
    R[i][0] = dp * a0;
    R[i][1] = dp * a1;
    R[i][2] = dp * (0.5 * a0 + 0.5 * a1 + a2) + bb[i];
    e[i] = 0x1p-22 * (2.0 * fabs(dp) * (fabs(a0) * W + fabs(a1) * H + fabs(a2)) +
                      fabs((double)bb[i]));
  }
  const double zc = (double)1e-5f, eps = 0.01 + (W + H) * 0x1p-20;
  const double lo[2] = {tx0 - 0.5 - eps, ty0 - 0.5 - eps};
  const double hi[2] = {tx1 + 1.5 + eps, ty1 + 1.5 + eps};
  HalfPlane hp[5];
  hp[0] = cls == 0 ? HalfPlane{R[2][0], R[2][1], R[2][2] - zc + e[2]}
                   : HalfPlane{-R[2][0], -R[2][1], zc + e[2] - R[2][2]};
  for (int j = 0; j < 2; ++j) {
    if (cls == 0) {  // lo r2 <= r_j <= hi r2, r2 > 0
      hp[1 + 2 * j] = {R[j][0] - lo[j] * R[2][0], R[j][1] - lo[j] * R[2][1],
                       R[j][2] - lo[j] * R[2][2] + e[j] + fabs(lo[j]) * e[2]};
      hp[2 + 2 * j] = {hi[j] * R[2][0] - R[j][0], hi[j] * R[2][1] - R[j][1],
                       hi[j] * R[2][2] - R[j][2] + e[j] + fabs(hi[j]) * e[2]};
    } else {  // lo zc <= r_j <= hi zc
      hp[1 + 2 * j] = {R[j][0], R[j][1], R[j][2] - lo[j] * zc + e[j]};
      hp[2 + 2 * j] = {-R[j][0], -R[j][1], hi[j] * zc - R[j][2] + e[j]};
    }
  }
  double xs[2][10], ys[2][10];
  xs[0][0] = 0.0, xs[0][1] = W - 1.0, xs[0][2] = W - 1.0, xs[0][3] = 0.0;
  ys[0][0] = 0.0, ys[0][1] = 0.0, ys[0][2] = H - 1.0, ys[0][3] = H - 1.0;
  int n = 4;
  for (int j = 0; j < 5 && n > 0; ++j)
    n = clip_polygon(xs[j & 1], ys[j & 1], n, hp[j], xs[(j + 1) & 1], ys[(j + 1) & 1]);
  short4 out = make_short4(1, 0, 1, 0);
  if (n > 0) {
    const double* px = xs[1];  // five clips: the result is in buffer 1
    const double* py = ys[1];
    double u0 = px[0], u1 = px[0], v0 = py[0], v1 = py[0];
    for (int i = 1; i < n; ++i) {
      u0 = fmin(u0, px[i]), u1 = fmax(u1, px[i]);
      v0 = fmin(v0, py[i]), v1 = fmax(v1, py[i]);
    }
    const int iu0 = max(0, (int)ceil(u0 - 1e-6)), iu1 = min(W - 1, (int)floor(u1 + 1e-6));
    const int iv0 = max(0, (int)ceil(v0 - 1e-6)), iv1 = min(H - 1, (int)floor(v1 + 1e-6));
    if (iu0 <= iu1 && iv0 <= iv1) out = make_short4(iu0, iu1, iv0, iv1);
  }
  *box = out;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A staged pixel's 16-byte pieces are stored in rotated slots, piece p in slot
// p ^ key(i), so that 8 lanes reading the same piece of 8 consecutive pixels
// hit 8 different 16-byte bank groups
constexpr bool SWIZZLE = true;

template <typename T>
__device__ __forceinline__ int piece_key(int i) {
  constexpr int P = C * (int)sizeof(T) / 16;  // pieces a pixel: 2 in bf16, 4 in f32
  return SWIZZLE ? (i / (8 / P)) % P : 0;
}

// val[c] += w * p[c] for the 16 channels of the staged pixel at p (key: its
// slots' rotation)
__device__ __forceinline__ void accum16_shared(const float* p, int key, float w, float* val) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = q[i ^ key];
    val[4 * i + 0] += w * t.x;
    val[4 * i + 1] += w * t.y;
    val[4 * i + 2] += w * t.z;
    val[4 * i + 3] += w * t.w;
  }
}

__device__ __forceinline__ void accum16_shared(const __nv_bfloat16* p, int key, float w,
                                               float* val) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 t = q[i ^ key];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      val[8 * i + 2 * j + 0] += w * f.x;
      val[8 * i + 2 * j + 1] += w * f.y;
    }
  }
}

// The walk over a plane group's boxes: box q = 2 (plane) + case, column band
// from u = cu, next row v = cv
struct Cursor {
  int q, cu, cv;
};

__device__ __forceinline__ bool empty_box(short4 b) { return b.x > b.y || b.z > b.w; }

// the cursor at the first row of the first box from q on that is not empty
__device__ Cursor first_row(const short4* boxes, int q, int nq) {
  while (q < nq && empty_box(boxes[q])) ++q;
  return Cursor{q, q < nq ? boxes[q].x : 0, q < nq ? boxes[q].z : 0};
}

// The next chunk: whole rows of the boxes in order (a box wider than NMAX in
// column bands), at most NMAX pixels in at most MAXSEG segments of rows of
// one box; seg[s] = (q, u0, columns, v0), pixels [start[s], start[s + 1]).
// Returns the segment count, 0 when the boxes are done.
template <int NMAX>
__device__ int next_chunk(Cursor& cur, const short4* boxes, int nq, int4* seg, int* start) {
  int used = 0, ns = 0;
  while (cur.q < nq && ns < MAXSEG) {
    const short4 box = boxes[cur.q];
    const int bw = min(box.y - cur.cu + 1, NMAX);
    const int nrows = min((NMAX - used) / bw, box.w - cur.cv + 1);
    if (nrows <= 0) break;
    seg[ns] = make_int4(cur.q, cur.cu, bw, cur.cv);
    start[ns++] = used;
    used += bw * nrows;
    cur.cv += nrows;
    if (cur.cv > box.w) {  // the band is done: the next band, or the next box
      cur.cu += bw;
      cur.cv = box.z;
      if (cur.cu > box.y) cur = first_row(boxes, cur.q + 1, nq);
    }
  }
  start[ns] = used;
  return ns;
}

// three blocks an SM: at most 80 registers a thread (the f64 box code runs
// apart, in candidate_boxes; at 64 the sums spill) and ~72 KB of shared
// memory a block
template <typename T>
__global__ void __launch_bounds__(NT, 3) warp_planes_bwd_kernel(
    const T* __restrict__ ct,         // (K', D, H, W, C)
    const float* __restrict__ A,      // (K', 3, 3)
    const float* __restrict__ bvec,   // (K', 3)
    const float* __restrict__ planes,  // (D,)
    T* __restrict__ out,              // (K', H, W, C)
    int H, int W, int D) {
  constexpr int NMAX = nmax<T>();
  constexpr int EPP = 16 / (int)sizeof(T);  // elements in 16 bytes
  constexpr int PIECES = C / EPP;           // 16-byte pieces a pixel
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  int4* segs = reinterpret_cast<int4*>(smem + STAGE_BYTES);  // (2, MAXSEG), two chunks' worth
  short4* boxes = reinterpret_cast<short4*>(segs + 2 * MAXSEG);  // (PLANE_GROUP, 2)
  float2* fxy = reinterpret_cast<float2*>(boxes + PLANE_GROUP * 2);
  int* cellrank = reinterpret_cast<int*>(fxy + NMAX);
  int* hist = cellrank + NMAX;  // (WARPS, NCELL)
  int* cstart = hist + WARPS * NCELL;
  int* ccount = cstart + NCELL;
  int* seg_start = ccount + NCELL;  // (2, MAXSEG + 1)
  int* seg_count = seg_start + 2 * (MAXSEG + 1);  // (2,)
  short* list = reinterpret_cast<short*>(seg_count + 2);

  const int k = blockIdx.y;
  const int tiles_x = (W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW, ty0 = (blockIdx.x / tiles_x) * TH;
  const int tw = min(TW, W - tx0), th = min(TH, H - ty0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lx = tid % TW, ly = tid / TW;
  float a[9], bb[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) a[i] = A[k * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) bb[i] = bvec[k * 3 + i];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  int* h = hist + warp * NCELL;
  const T* ctk = ct + (long long)k * D * H * W * C;
  Cursor cur{0, 0, 0};  // thread 0's

  for (int g0 = 0; g0 < D; g0 += PLANE_GROUP) {
    const int nd = min(PLANE_GROUP, D - g0), nq = 2 * nd;
    __syncthreads();
    if (tid < nq)  // thread 2 (plane) + case
      candidate_boxes(A + k * 9, bvec + k * 3, planes[g0 + tid / 2], H, W, tx0, tx0 + tw - 1,
                      ty0, ty0 + th - 1, tid & 1, boxes + tid);
    __syncthreads();
    if (tid == 0) {
      cur = first_row(boxes, 0, nq);
      seg_count[0] = next_chunk<NMAX>(cur, boxes, nq, segs, seg_start);
    }
    __syncthreads();
    for (int buf = 0;; buf ^= 1) {
      const int ns = seg_count[buf];
      if (ns == 0) break;
      const int4* sg = segs + buf * MAXSEG;
      const int* ss = seg_start + buf * (MAXSEG + 1);
      const int n = ss[ns];
      // 1. the chunk's cotangents to the stage, 16 bytes a copy
      for (int s = 0; s < ns; ++s) {
        const int4 q = sg[s];  // (box, u0, columns, v0)
        const T* ctd = ctk + (long long)(g0 + q.x / 2) * H * W * C;
        const int i0 = ss[s], m = ss[s + 1] - i0;
        for (int j = tid; j < m * PIECES; j += NT) {
          const int i = j / PIECES, pc = j - i * PIECES;
          const int r = i / q.z, c = i - r * q.z;
          cp_async16(stage + (i0 + i) * C + (pc ^ piece_key<T>(i0 + i)) * EPP,
                     ctd + ((long long)(q.w + r) * W + q.y + c) * C + pc * EPP);
        }
      }
      // the next chunk's segments, while the copies fly
      if (tid == 0)
        seg_count[buf ^ 1] = next_chunk<NMAX>(cur, boxes, nq, segs + (buf ^ 1) * MAXSEG,
                                              seg_start + (buf ^ 1) * (MAXSEG + 1));
      // 2. warp w takes pixels [w gpw 32, (w + 1) gpw 32): their samples,
      // cells and ranks among the warp's earlier pixels of the same cell
      const int gpw = (n + NT - 1) / NT;
      for (int c = lane; c < NCELL; c += 32) h[c] = 0;
      __syncwarp();
      for (int g = 0; g < gpw; ++g) {
        const int i = (warp * gpw + g) * 32 + lane;
        int cell = NONE;
        if (i < n) {
          int s = 0;
          while (s + 1 < ns && i >= ss[s + 1]) ++s;
          const int4 q = sg[s];
          const int off = i - ss[s], r = off / q.z, c = off - r * q.z;
          const Coords smp = sample_coords(a, bb, q.y + c + 0.5f, q.w + r + 0.5f,
                                           planes[g0 + q.x / 2], H, W);
          if ((int)smp.clamped == (q.x & 1)) {
            const float x0f = floorf(smp.x), y0f = floorf(smp.y);
            const int cx = (int)x0f - tx0 + 1, cy = (int)y0f - ty0 + 1;
            if (cx >= 0 && cx <= tw && cy >= 0 && cy <= th) {
              cell = cy * NCX + cx;
              fxy[i] = make_float2(smp.x - x0f, smp.y - y0f);
            }
          }
        }
        const unsigned peers = __match_any_sync(0xffffffffu, cell);
        const int base = cell != NONE ? h[cell] : 0;
        __syncwarp();
        if (cell != NONE) {
          const int below = __popc(peers & ((1u << lane) - 1u));
          if (below == 0) h[cell] = base + __popc(peers);
          cellrank[i] = cell | ((base + below) << 16);
        } else if (i < n) {
          cellrank[i] = NONE;
        }
        __syncwarp();
      }
      __syncthreads();
      // 3. per cell: exclusive prefix over the warps, and the count
      for (int c = tid; c < NCELL; c += NT) {
        int run = 0;
        for (int w = 0; w < WARPS; ++w) {
          const int t = hist[w * NCELL + c];
          hist[w * NCELL + c] = run;
          run += t;
        }
        ccount[c] = run;
      }
      __syncthreads();
      // 4. warp 0: exclusive prefix of the counts over the cells
      if (warp == 0) {
        constexpr int PER = (NCELL + 31) / 32;
        int local = 0;
        for (int j = 0; j < PER; ++j) {
          const int c = lane * PER + j;
          if (c < NCELL) local += ccount[c];
        }
        int incl = local;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += t;
        }
        int run = incl - local;
        for (int j = 0; j < PER; ++j) {
          const int c = lane * PER + j;
          if (c < NCELL) {
            cstart[c] = run;
            run += ccount[c];
          }
        }
      }
      __syncthreads();
      // 5. each pixel to its place: cells in order, pixels in index order
      for (int g = 0; g < gpw; ++g) {
        const int i = (warp * gpw + g) * 32 + lane;
        if (i < n) {
          const int cr = cellrank[i];
          if (cr != NONE) {
            const int c = cr & 0xffff;
            list[cstart[c] + h[c] + (cr >> 16)] = (short)i;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // 6. each texel adds its four cells. Cell (lx + ox, ly + oy) holds the
      // samples whose tap (1 - ox, 1 - oy) is this texel; cells lx and
      // lx + 1 of a row are consecutive in the list, so each row is one run.
      if (lx < tw && ly < th) {
        const int ca = ly * NCX + lx, cb = ca + NCX;
        const int a0 = cstart[ca], am = cstart[ca + 1], na = am + ccount[ca + 1] - a0;
        const int b0 = cstart[cb], bm = cstart[cb + 1], nb = bm + ccount[cb + 1] - b0;
#pragma unroll 2
        for (int t = 0; t < na + nb; ++t) {
          const bool top = t < na;
          const int j = top ? a0 + t : b0 + t - na;
          const int i = list[j];
          const float2 f = fxy[i];
          const float wx = j < (top ? am : bm) ? f.x : 1.f - f.x;
          const float wy = top ? f.y : 1.f - f.y;
          accum16_shared(stage + i * C, piece_key<T>(i), wx * wy, acc);
        }
      }
      __syncthreads();
    }
  }
  if (lx < tw && ly < th) store16(out + (((long long)k * H + ty0 + ly) * W + tx0 + lx) * C, acc);
}

}  // namespace bwd

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

// out: the (K', H, W, C) result in ct's dtype, every element written
template <typename T>
int launch_bwd(const void* ct, const void* A, const void* b, const void* planes, void* out,
               int K, int H, int W, int Cn, int D, void* stream) {
  if (Cn != C || H > 32767 || W > 32767 || K > 65535) return (int)cudaErrorInvalidValue;
  if ((long long)K * H * W == 0) return 0;
  const int smem = bwd::smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(bwd::warp_planes_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + bwd::TW - 1) / bwd::TW) * ((H + bwd::TH - 1) / bwd::TH), K);
  bwd::warp_planes_bwd_kernel<T><<<grid, bwd::NT, smem, (cudaStream_t)stream>>>(
      (const T*)ct, (const float*)A, (const float*)b, (const float*)planes, (T*)out, H, W, D);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: return cudaGetLastError() of the launches (0 on success);
// cudaErrorInvalidValue for a channel count other than 16 (and, for the
// transpose, H or W above 32767 or K' above 65535).
#define WARP_ARGS                                                                          \
  const void *x, const void *A, const void *b, const void *planes, void *out, int K, int H, \
      int W, int C, int D, void *stream

extern "C" int warp_planes_f32(WARP_ARGS) {
  return launch_fwd<float>(x, A, b, planes, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bf16(WARP_ARGS) {
  return launch_fwd<__nv_bfloat16>(x, A, b, planes, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bwd_f32(WARP_ARGS) {
  return launch_bwd<float>(x, A, b, planes, out, K, H, W, C, D, stream);
}

extern "C" int warp_planes_bwd_bf16(WARP_ARGS) {
  return launch_bwd<__nv_bfloat16>(x, A, b, planes, out, K, H, W, C, D, stream);
}

// the transpose's layout: its tile (texels wide, high) and its shared memory a
// block (bf16: 1 for the bf16 instantiation)
extern "C" int warp_planes_bwd_tile_width() { return bwd::TW; }
extern "C" int warp_planes_bwd_tile_height() { return bwd::TH; }
extern "C" int warp_planes_bwd_smem_bytes(int bf16) {
  return bf16 ? bwd::smem_bytes<__nv_bfloat16>() : bwd::smem_bytes<float>();
}

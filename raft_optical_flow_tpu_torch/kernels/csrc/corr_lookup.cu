// Windowed bilinear lookup over a materialized correlation pyramid, for Hopper
// (sm_90a). Built by kernels/_build.py with plain nvcc; bound through ctypes
// by kernels/corr_lookup.py. No PyTorch headers.
//
// Replaces three Pallas TPU kernels of raft_optical_flow_tpu/kernels/corr_lookup.py:
//   raft_corr_lookup_level          <- _lookup_level_kernel   (K1, one level)
//   raft_corr_lookup_coarse_fused   <- _coarse_fused_kernel   (K2, levels 1..L-1
//                                      in one launch)
//   raft_corr_lookup_level_bwd      <- _lookup_level_bwd_kernel (K3, K1's
//                                      gradient wrt the volume; see below)
//   raft_corr_lookup_all_levels     <- _fused_lookup_kernel (K8, levels
//                                      0..L-1 in one launch, fp32 output: K2's
//                                      device code started at level 0)
//
// What they compute: for each query q of batch b and level l, the (2r+1)^2
// window of corr_l[b, q] (a contiguous [Hl, Wl] row) sampled bilinearly at
// coords(q) / 2^l + (a - r, b - r), window channel k = a*(2r+1) + b; taps
// outside [0, Wl-1] x [0, Hl-1] read 0. fp32 or bf16 volume, fp32 weights and
// sums, one rounding to the fp32 or bf16 output.
//
// Design: on the TPU the lookup was two batched selector matmuls plus one-hot
// placement matmuls, because Mosaic handles per-query addressing poorly. On
// the card it is a gather: a block stages the pixels its windows' taps reach in
// shared memory and forms the windows from there (see K1 and K2 below). The arithmetic is written without
// fused multiply-adds, in the operation order of
// ops/corr.py::sample_corr_window, so the kernels agree bit for bit with their
// plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K1 and K2 (and K8 through K2's entry): a block of kThreads threads forms
// the windows of a run of consecutive items, an item being a query (K1) or a
// (query, level) pair in query-major order (K2), so that its outputs are one
// contiguous span of `out`. Three phases, with a block barrier between them:
//   1. each window's column taps (a) and row taps (b), one thread each, with
//      window_value's arithmetic of ops/corr.py::sample_corr_window:
//      px = fl(cx + (a - r)), x0 = floor(px), wx = px - x0, the clamp to
//      [-2, W] in float before the int cast, the in-bounds test of tap x0 and
//      of tap x0 + 1; and the window's box corner (floor(cx) - r, floor(cy) - r),
//      clipped in float before the int cast, so that far and NaN centres (all
//      their taps out of bounds) never reach it;
//   2. the box of (K+2) x (K+2) pixels from that corner, where it lies in the
//      level, copied into shared memory one box row to a thread, as the
//      16-byte-aligned chunks of the level's row that hold it (cp.async: no
//      registers, every copy of the block in flight at once; a chunk reads at
//      most 15 bytes beside the pixels it is for, inside their 16-byte-aligned
//      unit of the allocation, and they are never used). K+2, not K+1:
//      fl(cx + (a - r)) may round up across an integer, so x0 is
//      floor(cx) + (a - r) or one more, never less (for any centre whose taps
//      can be in bounds, |c| < 2^23), and the taps of one axis span
//      floor(c) - r .. floor(c) + r + 2. A box row keeps where its column 0
//      fell in its first chunk (rowoff);
//   3. the outputs, one thread to a window row b, its two tap rows in
//      registers, for a = 0 .. K-1: each tap reads the box cell that its tap
//      index from phase 1 addresses, or, out of bounds, a zero: the zero
//      column run after each box row's chunks, or the zero row after the box;
//      t00 = (v00*(1-wy))*(1-wx), t01, t10, t11, summed ((t00+t01)+t10)+t11,
//      one rounding to the output type.
// Every operation is the plain version's, in its order, without fused
// multiply-adds (__fmul_rn / __fadd_rn), so the kernels agree with it bit for
// bit. Chunk bytes outside the box or the level are never read: only
// in-bounds taps address the chunks. An empty level (K2) gets weights of 0
// and every tap on a zero: zeros, as the plain version returns.
//
// The window side K is a template constant for radius 3 and 4 (RAFT-small and
// RAFT-standard), so that the index arithmetic of every phase is by constants;
// any other radius runs the same code with K from the radius.
//
// Bound on the card: bytes. A query's row is read by no other query, so
// shared memory buys reuse only inside a window: each staged pixel serves up
// to four taps, and a box row of 11 bf16 touches one or two 32-byte sectors.
// Whole chunks, not pixels: staged pixel by pixel, the copies' instructions
// and their loads' latency took most of the time (PERF.md §6). With
// chunks, K1 runs as fast without phase 3's arithmetic as with it: the copies
// bind it, at about 2 TB/s counted in 64-byte units of the rows they touch.

constexpr int kMaxWindows = 16;      // windows a block at most (16 beat 12, 24 and 32)
constexpr int kSmemTarget = 49152;   // shared memory a block aims at (no opt-in below it)
constexpr size_t kMaxSmem = 232448;  // shared memory a block can have on Hopper

struct CoarseLevels {
  const void* corr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  float scale[kMaxLevels];  // 1 / 2^level, exact
  int n;
};

struct Window {     // a window's level row and box corner
  const void* row;  // the query's [H, W] row of the level
  int bx, by, H, W;
};

// A window's box in shared memory, for window side K over pixels of es bytes:
// S = K+2 rows of RP elements (the NCH 16-byte chunks of V elements that a
// row of S pixels can touch, then zeros, at least S + V of them), and a row
// of zeros.
struct BoxLayout {
  int S, V, NCH, RP, box;  // box: elements of one window's box
};
__host__ __device__ constexpr BoxLayout box_layout(int K, int es) {
  const int S = K + 2, V = 16 / es;
  const int NCH = (S + 2 * V - 2) / V;
  // the row pitch in 16-byte units, made odd: neighbouring rows (and the
  // windows' boxes) then start on other banks
  const int units = (NCH * V + S + 2 * V - 1) / V;
  const int RP = (units | 1) * V;
  return BoxLayout{S, V, NCH, RP, (S + 1) * RP};
}
// shared memory of one window: its taps, its box, its Window and its rowoff
__host__ __device__ constexpr size_t window_smem(int K, int es) {
  return 2 * K * sizeof(float4) + (size_t)box_layout(K, es).box * es + sizeof(Window) +
         (K + 2) * sizeof(int);
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::); }

// The windows of items [blockIdx.x * nw, ...): K1 when !kCoarse (one level,
// coords level-scaled), K2 when kCoarse (lv.n levels, coords level-0, item
// = query * lv.n + level). KC: the window side K, or 0 to take it from the
// radius.
template <typename TIn, typename TOut, int KC, bool kCoarse>
__device__ __forceinline__ void lookup_windows(const CoarseLevels& lv,
                                               const float* __restrict__ coords,
                                               TOut* __restrict__ out, int64_t n_items,
                                               int radius, int nw) {
  constexpr int es = sizeof(TIn);
  const int K = KC > 0 ? KC : 2 * radius + 1;
  const BoxLayout L = box_layout(K, es);
  const int S = L.S, KK = K * K;
  extern __shared__ float4 smem[];
  float4* taps = smem;                                           // [nw][2K]
  TIn* boxes = reinterpret_cast<TIn*>(taps + nw * 2 * K);        // [nw][L.box]
  Window* win = reinterpret_cast<Window*>(boxes + nw * L.box);   // [nw]
  int* rowoff = reinterpret_cast<int*>(win + nw);                // [nw][S]
  const int64_t first = (int64_t)blockIdx.x * nw;
  const int n_win = (int)(n_items - first < nw ? n_items - first : nw);

  // 1. taps and box corners; zeros in the boxes
  uint4* zero = reinterpret_cast<uint4*>(boxes);
  for (int e = threadIdx.x; e < n_win * L.box * es / 16; e += kThreads)
    zero[e] = make_uint4(0, 0, 0, 0);
  const int64_t q_first = kCoarse ? first / lv.n : first;  // item first = q_first * n + l_first
  const int l_first = (int)(first - q_first * (kCoarse ? lv.n : 1));
  for (int e = threadIdx.x; e < n_win * 2 * K; e += kThreads) {
    const int w = e / (2 * K), i = e - w * (2 * K);
    const int dq = kCoarse ? (l_first + w) / lv.n : w;
    const int64_t q = q_first + dq;
    const int li = kCoarse ? l_first + w - dq * lv.n : 0;
    const int H = lv.H[li], W = lv.W[li];
    float cx = coords[2 * q], cy = coords[2 * q + 1];
    if (kCoarse) {
      cx = __fmul_rn(cx, lv.scale[li]);
      cy = __fmul_rn(cy, lv.scale[li]);
    }
    const float lo = -(float)(K + 2);
    const int bx = (int)fminf(fmaxf(floorf(cx) - (float)radius, lo), (float)W);
    const int by = (int)fminf(fmaxf(floorf(cy) - (float)radius, lo), (float)H);
    if (i == 0)
      win[w] = Window{static_cast<const TIn*>(lv.corr[li]) + q * ((int64_t)H * W), bx, by, H, W};
    const bool col = i < K;
    const int n = col ? W : H, corner = col ? bx : by;
    // out of bounds: a column of the zero run after every box row, or the zero row
    const int oob = col ? L.NCH * L.V + S : S;
    float wt = 0.0f, om = 0.0f;
    int t0 = oob, t1 = oob;
    if (H > 0 && W > 0) {
      const float p = __fadd_rn(col ? cx : cy, (float)((col ? i : i - K) - radius));
      const float p0 = floorf(p);
      wt = __fsub_rn(p, p0);
      om = __fsub_rn(1.0f, wt);
      const int pi = (int)fminf(fmaxf(p0, -2.0f), (float)n);
      if (pi >= 0 && pi <= n - 1) t0 = pi - corner;
      if (pi + 1 >= 0 && pi + 1 <= n - 1) t1 = pi + 1 - corner;
    }
    taps[w * 2 * K + i] = make_float4(__int_as_float(t0), __int_as_float(t1), wt, om);
  }
  __syncthreads();

  // 2. the box rows inside their level, as the 16-byte chunks that hold them
  for (int e = threadIdx.x; e < n_win * S; e += kThreads) {
    const int w = e / S, r = e - w * S;
    const Window m = win[w];
    const int y = m.by + r, x_lo = max(m.bx, 0), x_hi = min(m.bx + S, m.W);
    int off = 0;
    if ((unsigned)y < (unsigned)m.H && x_lo < x_hi) {
      const TIn* row = static_cast<const TIn*>(m.row) + (int64_t)y * m.W;
      const uintptr_t lo = reinterpret_cast<uintptr_t>(row + x_lo);
      const uintptr_t a = lo & ~(uintptr_t)15;
      // at most L.NCH chunks: the S pixels and up to V - 1 before them
      const int nch = (int)((reinterpret_cast<uintptr_t>(row + x_hi - 1) - a) >> 4) + 1;
      off = (int)((lo - a) / es) - (x_lo - m.bx);  // where box column 0 falls
      TIn* dst = boxes + w * L.box + r * L.RP;
      for (int j = 0; j < nch; ++j)
        copy16_async(dst + j * L.V, reinterpret_cast<const void*>(a + 16 * j));
    }
    rowoff[w * S + r] = off;
  }
  wait_copies();
  __syncthreads();

  // 3. the outputs: the block's span of out, one thread to a window row b
  TOut* o = out + first * KK;
  for (int e = threadIdx.x; e < n_win * K; e += kThreads) {
    const int w = e / K, b = e - w * K;
    const float4 y = taps[w * 2 * K + K + b];
    const int y0 = __float_as_int(y.x), y1 = __float_as_int(y.y);
    const TIn* bw = boxes + w * L.box;
    const TIn* row0 = bw + y0 * L.RP + (y0 < S ? rowoff[w * S + y0] : 0);
    const TIn* row1 = bw + y1 * L.RP + (y1 < S ? rowoff[w * S + y1] : 0);
    TOut* ob = o + w * KK + b;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float4 x = taps[w * 2 * K + a];
      const int c0 = __float_as_int(x.x), c1 = __float_as_int(x.y);
      const float t00 = __fmul_rn(__fmul_rn(load_f(row0 + c0), y.w), x.w);
      const float t01 = __fmul_rn(__fmul_rn(load_f(row0 + c1), y.w), x.z);
      const float t10 = __fmul_rn(__fmul_rn(load_f(row1 + c0), y.z), x.w);
      const float t11 = __fmul_rn(__fmul_rn(load_f(row1 + c1), y.z), x.z);
      store_f(ob + a * K, __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11));
    }
  }
}

// K1: corr [BQ, H, W] (lv.corr[0], lv.H[0], lv.W[0]), coords [BQ, 2]
// level-scaled, out [BQ, K*K].
template <typename TIn, typename TOut, int KC>
__global__ void __launch_bounds__(kThreads)
    lookup_level_kernel(CoarseLevels lv, const float* __restrict__ coords,
                        TOut* __restrict__ out, int64_t bq_total, int radius, int nw) {
  lookup_windows<TIn, TOut, KC, false>(lv, coords, out, bq_total, radius, nw);
}

// K2: levels [BQ, H_i, W_i], coords [BQ, 2] level-0, out [BQ, n*K*K].
template <typename TIn, typename TOut, int KC>
__global__ void __launch_bounds__(kThreads)
    coarse_fused_kernel(CoarseLevels lv, const float* __restrict__ coords,
                        TOut* __restrict__ out, int64_t bq_total, int radius, int nw) {
  lookup_windows<TIn, TOut, KC, true>(lv, coords, out, bq_total * lv.n, radius, nw);
}

// Windows too wide for their box to fit in shared memory (a radius above
// about 80): one thread per output value, the plain version's arithmetic tap
// by tap, each tap read from the level's row.
template <typename T>
__device__ __forceinline__ float window_value(const T* __restrict__ row, int H, int W, float cx,
                                              float cy, int a, int b, int radius) {
  const float px = __fadd_rn(cx, (float)(a - radius));
  const float py = __fadd_rn(cy, (float)(b - radius));
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float wx = __fsub_rn(px, x0);
  const float wy = __fsub_rn(py, y0);
  // clamp in float before the int cast: [-2, W] keeps both x0 and x0 + 1 on
  // their side of the bounds
  const int xi = (int)fminf(fmaxf(x0, -2.0f), (float)W);
  const int yi = (int)fminf(fmaxf(y0, -2.0f), (float)H);
  const bool x0in = xi >= 0 && xi <= W - 1;
  const bool x1in = xi + 1 >= 0 && xi + 1 <= W - 1;
  const bool y0in = yi >= 0 && yi <= H - 1;
  const bool y1in = yi + 1 >= 0 && yi + 1 <= H - 1;
  const T* r0 = row + (int64_t)yi * W + xi;
  const T* r1 = r0 + W;
  const float v00 = (x0in && y0in) ? load_f(r0) : 0.0f;
  const float v01 = (x1in && y0in) ? load_f(r0 + 1) : 0.0f;
  const float v10 = (x0in && y1in) ? load_f(r1) : 0.0f;
  const float v11 = (x1in && y1in) ? load_f(r1 + 1) : 0.0f;
  const float omx = __fsub_rn(1.0f, wx);
  const float omy = __fsub_rn(1.0f, wy);
  const float t00 = __fmul_rn(__fmul_rn(v00, omy), omx);
  const float t01 = __fmul_rn(__fmul_rn(v01, omy), wx);
  const float t10 = __fmul_rn(__fmul_rn(v10, wy), omx);
  const float t11 = __fmul_rn(__fmul_rn(v11, wy), wx);
  return __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11);
}

// K1 and K2 for such windows: out [BQ, n*K*K], output idx of query idx / (n*K*K).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    wide_lookup_kernel(CoarseLevels lv, const float* __restrict__ coords,
                       TOut* __restrict__ out, int64_t bq_total, int radius) {
  const int K = 2 * radius + 1;
  const int KK = K * K;
  const int per_q = lv.n * KK;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bq_total * per_q) return;
  const int64_t q = idx / per_q;
  const int rem = (int)(idx - q * per_q);
  const int li = rem / KK;
  const int k = rem - li * KK;
  const int H = lv.H[li];
  const int W = lv.W[li];
  float v = 0.0f;  // an empty level (floor-mode pooling) is all out of bounds
  if (H > 0 && W > 0) {
    const float s = lv.scale[li];  // 1 for K1, whose coords come level-scaled
    const TIn* row = static_cast<const TIn*>(lv.corr[li]) + q * ((int64_t)H * W);
    const int a = k / K;
    v = window_value(row, H, W, __fmul_rn(coords[2 * q], s), __fmul_rn(coords[2 * q + 1], s), a,
                     k - a * K, radius);
  }
  store_f(out + idx, v);
}

// K3, the volume gradient of K1:
//   dcorr[q, h, w] = sum_{a, b} X_a(w) * Y_b(h) * g[q, a*K + b]
// where X_a(w) is the weight K1 gave column w in window column a: with
// px = cx + (a - r), x0 = floor(px), wx = px - x0 (K1's arithmetic), it is
// 1 - wx at w = x0, wx at w = x0 + 1, and 0 elsewhere; Y_b(h) likewise in y.
// The coords gradient is zero (RAFT detaches coords before every lookup).
//
// Bound on the card: bytes. The dense dcorr (B*Q*Hl*Wl elements) is written
// once and dwarfs the g read (B*Q*K^2) and the coords; at most (K+1)^2 of a
// row's elements are not zero, and each takes a few dozen flops.
//
// Design: on the TPU the gradient was two selector matmuls per query tile
// (one-hot placement matmuls unflattened the cotangent, and the query tile
// was halved to fit VMEM). On the card it is a store of the dense rows at
// memset speed with a small patch in each. A block owns a span of the flat
// dcorr buffer (at most 4 16-byte stores per thread: 8,192 bf16 or 4,096
// fp32 elements, whatever the rows' length or alignment; halved down to 512
// elements at the coarse levels, so that every SM still gets several blocks
// of their patch arithmetic) and builds it in a shared-memory tile: zero
// the span's words of the tile; then the block's threads share the patch items of every query
// whose row meets the span, each item one element (h, w) of the query's
// (2r+5)^2 box around floor(coords) that lies in the span, computed as
// before (the at most 2 x 2 taps that reach it, fp32 weights and sums in
// the same order, one rounding) and written into the tile; then each
// thread copies its 16-byte pieces of the tile to dcorr, neighbouring
// threads on neighbouring addresses. The arithmetic is
// spread over all threads (a few items each at level 0), not left to the
// few whose store meets a patch, and every element of dcorr is written once.
// No atomics, no memset of dcorr, no second pass, deterministic.

// Weight that window column a (centre c, level-scaled) gives pixel p of a row
// of n pixels: K1's bilinear weight, 0 where column a does not reach p.
__device__ __forceinline__ float tap_weight(float c, int a, int radius, int p, int n) {
  const float pa = __fadd_rn(c, (float)(a - radius));
  const float p0 = floorf(pa);
  const float wa = __fsub_rn(pa, p0);
  const int pi = (int)fminf(fmaxf(p0, -2.0f), (float)n);  // K1's clamp
  if (pi == p) return __fsub_rn(1.0f, wa);
  if (pi + 1 == p) return wa;
  return 0.0f;
}

// dcorr at (h, w) of the query with coords (cx, cy) and cotangent row gq.
// Window column a sits at floor(cx) + a - r, give or take one for the
// rounding of cx + (a - r), and reaches its tap and the next: so only a in
// [w - floor(cx) + r - 2, w - floor(cx) + r + 1] can reach w, and none can
// once w is more than r + 2 from floor(cx). Same in y. Far out-of-bounds
// coords fail this test in float, before any int cast.
template <typename TG>
__device__ __forceinline__ float bwd_element(float cx, float cy, const TG* __restrict__ gq,
                                             int h, int w, int H, int W, int radius) {
  const int K = 2 * radius + 1;
  const float lim = (float)radius + 2.0f;
  const float dx = (float)w - floorf(cx);
  const float dy = (float)h - floorf(cy);
  float acc = 0.0f;
  if (dx >= -lim && dx <= lim && dy >= -lim && dy <= lim) {
    const int a_lo = (int)dx + radius - 2;
    const int b_lo = (int)dy + radius - 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a_lo + i;
      if (a < 0 || a >= K) continue;
      const float xw = tap_weight(cx, a, radius, w, W);
      if (xw == 0.0f) continue;
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b_lo + j;
        if (b < 0 || b >= K) continue;
        t += tap_weight(cy, b, radius, h, H) * load_f(gq + a * K + b);
      }
      acc += xw * t;
    }
  }
  return acc;
}

constexpr int kBwdStores = 4;       // 16-byte stores per thread
constexpr int kBwdMinSpan = 512;    // elements: the smallest span per block
constexpr int kBwdMinBlocks = 528;  // 4 blocks per SM of an H100

// g: [BQ, K*K]; coords: [BQ, 2] level-scaled; dcorr: [BQ, H, W], 16-byte
// aligned, n = BQ*H*W elements. Block b owns elements [b * span_max, b *
// span_max + span_max) of the flat dcorr; span_max is at most the tile and a
// multiple of a 16-byte store.
template <typename TG, typename TOut>
__global__ void __launch_bounds__(kThreads)
    lookup_level_bwd_kernel(const float* __restrict__ coords,
                            const TG* __restrict__ g, TOut* __restrict__ dcorr,
                            int64_t n, int span_max, int H, int W, int radius) {
  constexpr int V = 16 / sizeof(TOut);
  constexpr int kSpan = kThreads * kBwdStores * V;
  __shared__ __align__(16) TOut tile[kSpan];
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  const int64_t e0 = (int64_t)blockIdx.x * span_max;
  const int span = (int)(n - e0 < span_max ? n - e0 : span_max);
  // zero only the 16-byte words the span covers (a halved span at the
  // coarse levels leaves most of the tile unused)
  const int words = (span + V - 1) / V;
#pragma unroll
  for (int i = 0; i < kBwdStores; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < words) tile4[j] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // patch items: each query meeting the span, each element of its box
  const int hw = H * W;
  const int KK = (2 * radius + 1) * (2 * radius + 1);
  const float lim = (float)radius + 2.0f;
  const int side = 2 * radius + 5;
  const int rb = H < side ? H : side, cb = W < side ? W : side;
  const int box = rb * cb;
  const int64_t q0 = e0 / hw;
  const int nq = (int)((e0 + span - 1) / hw - q0) + 1;
  for (int it = threadIdx.x; it < nq * box; it += kThreads) {
    const int qo = it / box;
    const int rem = it - qo * box;
    const int by = rem / cb;
    const int64_t q = q0 + qo;
    const float cx = coords[2 * q], cy = coords[2 * q + 1];
    // the box's corner: floor(coords) - (radius + 2), moved inside the level;
    // in float first, so far out-of-bounds and NaN coords never reach the cast
    const int h = (int)fminf(fmaxf(floorf(cy) - lim, 0.0f), (float)(H - rb)) + by;
    const int w = (int)fminf(fmaxf(floorf(cx) - lim, 0.0f), (float)(W - cb)) + rem - by * cb;
    const int64_t e = q * hw + h * W + w - e0;
    if (e < 0 || e >= span) continue;
    store_f(tile + e, bwd_element(cx, cy, g + q * KK, h, w, H, W, radius));
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kBwdStores; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if ((j + 1) * V <= span) {
      *reinterpret_cast<uint4*>(dcorr + e0 + (int64_t)j * V) = tile4[j];
    } else {
      for (int k = j * V; k < span; ++k) dcorr[e0 + k] = tile[k];
    }
  }
}

template <typename TG, typename TOut>
int launch_level_bwd(const void* coords, const void* g, void* dcorr, int64_t n, int H,
                     int W, int radius, cudaStream_t s) {
  // the full tile, halved while the level is too small to give every SM
  // several blocks (the coarse levels, where most elements are patch items)
  int span = kThreads * kBwdStores * (16 / sizeof(TOut));
  while (span > kBwdMinSpan && (n + span - 1) / span < kBwdMinBlocks) span /= 2;
  const int64_t blocks = (n + span - 1) / span;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  lookup_level_bwd_kernel<TG, TOut><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(coords), static_cast<const TG*>(g), static_cast<TOut*>(dcorr),
      n, span, H, W, radius);
  return (int)cudaGetLastError();
}

// K1 (!kCoarse) or K2 over bq queries: K a template constant KC, or (KC = 0)
// from the radius; nw windows a block: at most kMaxWindows, one a thread in
// phase 3, and what fits in kSmemTarget (at least one). A window whose box
// does not fit in a block's shared memory goes to wide_lookup_kernel.
template <typename TIn, typename TOut, bool kCoarse, int KC>
int launch_windows_k(const CoarseLevels& lv, const void* coords, void* out, int64_t bq,
                     int radius, cudaStream_t s) {
  auto kernel = kCoarse ? coarse_fused_kernel<TIn, TOut, KC> : lookup_level_kernel<TIn, TOut, KC>;
  const int K = 2 * radius + 1;
  const size_t per_window = window_smem(K, sizeof(TIn));
  if (per_window > kMaxSmem) {  // a box too wide for shared memory
    const int64_t threads = bq * lv.n * K * K;
    if ((threads + kThreads - 1) / kThreads > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    wide_lookup_kernel<TIn, TOut><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        lv, static_cast<const float*>(coords), static_cast<TOut*>(out), bq, radius);
    return (int)cudaGetLastError();
  }
  const int nw = (int)std::max<size_t>(
      1, std::min<size_t>(std::min(kMaxWindows, kThreads / K), kSmemTarget / per_window));
  const size_t smem = per_window * nw;
  if (smem > (size_t)kSmemTarget) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = ((kCoarse ? bq * lv.n : bq) + nw - 1) / nw;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(lv, static_cast<const float*>(coords),
                                                  static_cast<TOut*>(out), bq, radius, nw);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, bool kCoarse>
int launch_windows(const CoarseLevels& lv, const void* coords, void* out, int64_t bq,
                   int radius, cudaStream_t s) {
  switch (radius) {
    case 3: return launch_windows_k<TIn, TOut, kCoarse, 7>(lv, coords, out, bq, radius, s);
    case 4: return launch_windows_k<TIn, TOut, kCoarse, 9>(lv, coords, out, bq, radius, s);
    default: return launch_windows_k<TIn, TOut, kCoarse, 0>(lv, coords, out, bq, radius, s);
  }
}

template <bool kCoarse>
int launch_windows(const CoarseLevels& lv, const void* coords, void* out, int64_t bq,
                   int radius, int corr_dtype, int out_dtype, cudaStream_t s) {
  switch (corr_dtype * 2 + out_dtype) {
    case 0: return launch_windows<float, float, kCoarse>(lv, coords, out, bq, radius, s);
    case 1: return launch_windows<float, __nv_bfloat16, kCoarse>(lv, coords, out, bq, radius, s);
    case 2: return launch_windows<__nv_bfloat16, float, kCoarse>(lv, coords, out, bq, radius, s);
    default:
      return launch_windows<__nv_bfloat16, __nv_bfloat16, kCoarse>(lv, coords, out, bq, radius, s);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int raft_corr_lookup_level(const void* corr, const void* coords,
                                      void* out, int B, int Q, int H, int W,
                                      int radius, int corr_dtype, int out_dtype,
                                      void* stream) {
  if (B < 0 || Q < 0 || H <= 0 || W <= 0 || radius < 0 || corr_dtype < 0 ||
      corr_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t bq = (int64_t)B * Q;
  if (bq == 0) return (int)cudaSuccess;
  CoarseLevels lv = {};
  lv.corr[0] = corr;
  lv.H[0] = H;
  lv.W[0] = W;
  lv.scale[0] = 1.0f;
  lv.n = 1;
  return launch_windows<false>(lv, coords, out, bq, radius, corr_dtype, out_dtype,
                               static_cast<cudaStream_t>(stream));
}

// level_ptrs, level_h, level_w, level_index: host arrays of n_levels entries
// (device pointer, Hl, Wl, pyramid level l). Empty levels (Hl or Wl = 0) are
// written as zeros.
extern "C" int raft_corr_lookup_coarse_fused(
    const void* const* level_ptrs, const int* level_h, const int* level_w,
    const int* level_index, int n_levels, const void* coords, void* out, int B,
    int Q, int radius, int corr_dtype, int out_dtype, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || B < 0 || Q < 0 || radius < 0 ||
      corr_dtype < 0 || corr_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  CoarseLevels lv;
  lv.n = n_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < n_levels;
    lv.corr[i] = used ? level_ptrs[i] : nullptr;
    lv.H[i] = used ? level_h[i] : 0;
    lv.W[i] = used ? level_w[i] : 0;
    lv.scale[i] = used ? ldexpf(1.0f, -level_index[i]) : 0.0f;
    if (used && (lv.H[i] < 0 || lv.W[i] < 0 || level_index[i] < 0))
      return (int)cudaErrorInvalidValue;
  }
  const int64_t bq = (int64_t)B * Q;
  if (bq == 0) return (int)cudaSuccess;
  return launch_windows<true>(lv, coords, out, bq, radius, corr_dtype, out_dtype,
                              static_cast<cudaStream_t>(stream));
}

// K8: every level in one launch, levels 0..n_levels-1 in order, fp32 output
// [B*Q, n_levels*K*K] whatever the volume dtype (the Pallas kernel's output
// type); empty levels are written as zeros. No model path launches it: it is
// the port of corr_pyramid_lookup_pallas_fused, whose Pallas body does not
// trace (ROADMAP.md Queue 3), so it computes what that body was meant to: K1
// at every level. Bound: bytes, as K2.
extern "C" int raft_corr_lookup_all_levels(const void* const* level_ptrs,
                                           const int* level_h, const int* level_w,
                                           int n_levels, const void* coords, void* out,
                                           int B, int Q, int radius, int corr_dtype,
                                           void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  int level_index[kMaxLevels];
  for (int i = 0; i < n_levels; ++i) level_index[i] = i;
  return raft_corr_lookup_coarse_fused(level_ptrs, level_h, level_w, level_index,
                                       n_levels, coords, out, B, Q, radius, corr_dtype,
                                       /*out_dtype=*/0, stream);
}

// coords [B*Q, 2] fp32 level-scaled, g [B*Q, K*K] (g_dtype), dcorr [B*Q, H, W]
// (dcorr_dtype, the volume's), 16-byte aligned. dtype codes as above. Every
// element of dcorr is written. Returns a cudaError_t as int.
extern "C" int raft_corr_lookup_level_bwd(const void* coords, const void* g,
                                          void* dcorr, int B, int Q, int H, int W,
                                          int radius, int g_dtype, int dcorr_dtype,
                                          void* stream) {
  if (B < 0 || Q < 0 || H <= 0 || W <= 0 || radius < 0 || g_dtype < 0 ||
      g_dtype > 1 || dcorr_dtype < 0 || dcorr_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t bq = (int64_t)B * Q;
  if (bq == 0) return (int)cudaSuccess;
  // a block's patch items (queries meeting its span x their box) in an int
  const int64_t box = (int64_t)std::min(H, 2 * radius + 5) * std::min(W, 2 * radius + 5);
  if ((int64_t)H * W > 0x7fffffff || (kThreads * kBwdStores * 8 + 2) * box > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (reinterpret_cast<uintptr_t>(dcorr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int64_t n = bq * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype * 2 + dcorr_dtype) {
    case 0: return launch_level_bwd<float, float>(coords, g, dcorr, n, H, W, radius, s);
    case 1: return launch_level_bwd<float, __nv_bfloat16>(coords, g, dcorr, n, H, W, radius, s);
    case 2: return launch_level_bwd<__nv_bfloat16, float>(coords, g, dcorr, n, H, W, radius, s);
    default: return launch_level_bwd<__nv_bfloat16, __nv_bfloat16>(coords, g, dcorr, n, H, W, radius, s);
  }
}

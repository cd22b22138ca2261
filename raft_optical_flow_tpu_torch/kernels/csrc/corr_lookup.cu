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
// the card it is a gather: one thread per output value reads its four taps
// from the query's row and writes one element, so consecutive threads write
// consecutive outputs. The arithmetic is written without fused multiply-adds,
// in the operation order of ops/corr.py::sample_corr_window, so the kernels
// agree bit for bit with their plain PyTorch version.
//
// Bound on the card: bytes. Per query and level the kernel needs at most the
// (K+1)^2 volume elements of its patch, the query's two coords, and writes K^2
// outputs; a few flops per output are far below the compute rate. The taps of
// one output are reloaded by its neighbours from L1/L2 rather than shared
// through shared memory: this first version is simple and right; making it
// fast is later work.

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

// Window value at (a, b) of one query's [H, W] row around (cx, cy).
template <typename T>
__device__ __forceinline__ float window_value(const T* __restrict__ row, int H,
                                              int W, float cx, float cy, int a,
                                              int b, int radius) {
  const float px = __fadd_rn(cx, (float)(a - radius));
  const float py = __fadd_rn(cy, (float)(b - radius));
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float wx = __fsub_rn(px, x0);
  const float wy = __fsub_rn(py, y0);
  // Clamp in float before the int cast: a cast of a far out-of-range float is
  // undefined. [-2, W] keeps both x0 and x0 + 1 on their side of the bounds.
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

// K1: corr [BQ, H, W], coords [BQ, 2] level-scaled, out [BQ, K*K].
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    lookup_level_kernel(const TIn* __restrict__ corr,
                        const float* __restrict__ coords, TOut* __restrict__ out,
                        int64_t bq_total, int H, int W, int radius) {
  const int K = 2 * radius + 1;
  const int KK = K * K;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bq_total * KK) return;
  const int64_t q = idx / KK;
  const int k = (int)(idx - q * KK);
  const int a = k / K;
  const int b = k - a * K;
  const TIn* row = corr + q * ((int64_t)H * W);
  store_f(out + idx,
          window_value(row, H, W, coords[2 * q], coords[2 * q + 1], a, b, radius));
}

struct CoarseLevels {
  const void* corr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  float scale[kMaxLevels];  // 1 / 2^level, exact
  int n;
};

// K2: levels [BQ, H_i, W_i], coords [BQ, 2] level-0, out [BQ, n*K*K].
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    coarse_fused_kernel(CoarseLevels lv, const float* __restrict__ coords,
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
    const float s = lv.scale[li];
    const TIn* row = static_cast<const TIn*>(lv.corr[li]) + q * ((int64_t)H * W);
    const int a = k / K;
    v = window_value(row, H, W, __fmul_rn(coords[2 * q], s),
                     __fmul_rn(coords[2 * q + 1], s), a, k - a * K, radius);
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

bool grid_for(int64_t total, unsigned* blocks) {
  const int64_t n = (total + kThreads - 1) / kThreads;
  if (n > 0x7fffffff) return false;
  *blocks = (unsigned)n;
  return true;
}

template <typename TIn, typename TOut>
void launch_level(const void* corr, const void* coords, void* out, int64_t bq,
                  int H, int W, int radius, unsigned blocks, cudaStream_t s) {
  lookup_level_kernel<TIn, TOut><<<blocks, kThreads, 0, s>>>(
      static_cast<const TIn*>(corr), static_cast<const float*>(coords),
      static_cast<TOut*>(out), bq, H, W, radius);
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

template <typename TIn, typename TOut>
void launch_coarse(const CoarseLevels& lv, const void* coords, void* out,
                   int64_t bq, int radius, unsigned blocks, cudaStream_t s) {
  coarse_fused_kernel<TIn, TOut><<<blocks, kThreads, 0, s>>>(
      lv, static_cast<const float*>(coords), static_cast<TOut*>(out), bq, radius);
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
  const int K = 2 * radius + 1;
  const int64_t bq = (int64_t)B * Q;
  unsigned blocks;
  if (bq == 0) return (int)cudaSuccess;
  if (!grid_for(bq * K * K, &blocks)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (corr_dtype * 2 + out_dtype) {
    case 0: launch_level<float, float>(corr, coords, out, bq, H, W, radius, blocks, s); break;
    case 1: launch_level<float, __nv_bfloat16>(corr, coords, out, bq, H, W, radius, blocks, s); break;
    case 2: launch_level<__nv_bfloat16, float>(corr, coords, out, bq, H, W, radius, blocks, s); break;
    default: launch_level<__nv_bfloat16, __nv_bfloat16>(corr, coords, out, bq, H, W, radius, blocks, s); break;
  }
  return (int)cudaGetLastError();
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
  const int K = 2 * radius + 1;
  const int64_t bq = (int64_t)B * Q;
  unsigned blocks;
  if (bq == 0) return (int)cudaSuccess;
  if (!grid_for(bq * n_levels * K * K, &blocks))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (corr_dtype * 2 + out_dtype) {
    case 0: launch_coarse<float, float>(lv, coords, out, bq, radius, blocks, s); break;
    case 1: launch_coarse<float, __nv_bfloat16>(lv, coords, out, bq, radius, blocks, s); break;
    case 2: launch_coarse<__nv_bfloat16, float>(lv, coords, out, bq, radius, blocks, s); break;
    default: launch_coarse<__nv_bfloat16, __nv_bfloat16>(lv, coords, out, bq, radius, blocks, s); break;
  }
  return (int)cudaGetLastError();
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

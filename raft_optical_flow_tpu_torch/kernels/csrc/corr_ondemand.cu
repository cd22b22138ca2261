// On-demand windowed correlation (alt_cuda_corr) for Hopper (sm_90a): the
// windows of RAFT's correlation pyramid computed from the feature maps,
// without the HW x HW volume. Built by kernels/_build.py with plain nvcc;
// bound through ctypes by kernels/corr_ondemand.py. No PyTorch headers.
//
// Replaces the Pallas TPU kernels of
// raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:
//   raft_corr_ondemand_fwd      <- _fwd_level_kernel, _fwd_level_stream_kernel (K4)
//   raft_corr_ondemand_bwd_df1  <- _bwd_df1_kernel, _bwd_df1_stream_kernel     (K5)
//   raft_corr_ondemand_bwd_df2  <- _bwd_df2_kernel, _bwd_df2_stream_kernel     (K6)
// The TPU's resident and streaming variants differ only in how a level of
// fmap2 is cut to fit VMEM; here each pair is one kernel. The TPU's selector
// matmuls (_tri_kq, _tri_qk), one-hot placement matmuls (_flatten_win,
// _unflatten_g) and lane-padded fmap2 layout (_flatten_f2) are workarounds
// for Mosaic and are not carried over.
//
// What they compute, for query q of batch b and level l (K = 2r + 1):
//   out[b, q, l*K*K + a*K + c] =
//       <f1[b, q, :], bilinear_zero(f2_l[b], coords[b, q] / 2^l + (a - r, c - r))> / sqrt(C)
// with taps outside [0, Wl-1] x [0, Hl-1] reading zero. All window points of
// one query and level share one fractional offset (fx, fy): with
// x0 = floor(cx), the (2r+1)^2 bilinear samples need only the (2r+2)^2
// integer taps (x0 - r + i, y0 - r + j), i, j in [0, 2r+1]. The kernels work
// on those taps (alt_cuda_corr's design):
//   D[j][i]  = <f1[q], f2_l[tap(i, j)]>         (0 for a tap out of bounds)
//   out(a,c) = ((1-fy)((1-fx) D[c][a] + fx D[c][a+1])
//              + fy((1-fx) D[c+1][a] + fx D[c+1][a+1])) / sqrt(C)
// and the backward spreads the window cotangent gs = g / sqrt(C) back onto
// the taps with the same weights:
//   drows[j][i] = (1-fx)((1-fy) gs[i][j] + fy gs[i][j-1])
//               + fx((1-fy) gs[i-1][j] + fy gs[i-1][j-1])   (terms outside [0, K) drop)
//   df1[q, :]   = sum_l sum_{taps in bounds} drows[j][i] * f2_l[tap(i, j), :]
//   df2_l[p, :] = sum_q drows_q(p) * f1[q, :]
// fp32 or bf16 operands (bf16 products are exact in fp32), fp32 sums, one
// rounding to the output dtype. Coords stay fp32; level l scales them by the
// exact 2^-l, as the JAX package's coords / 2**l.
//
// Bound on the card. A query reads its (2r+2)^2 taps of C channels at each
// level: 400 C-long dot products at r = 4 with four levels, against one
// C-long read of f1 and 324 outputs. At the batch-16 serving shape (bf16,
// C = 256) the compulsory bytes are about 208 MB, 0.062 ms at 3.35 TB/s,
// and the products 17 GFLOP: bytes bound the function, but this first
// version does its products on the CUDA cores (fp32 multiply-adds, about
// 0.26 ms at 67 TFLOP/s), and it re-reads each query's taps through L1/L2
// rather than sharing them between neighbouring queries, which is likely
// what holds it back (it ran at about 1% of the bytes bound on an H100).
// The tap products as tensor-core tiles (wgmma / mma.sync) over a tile of
// queries with their taps staged in shared memory are later work. K5 and K6
// do the same products backwards; K6 also walks each band's queries (see
// its note).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;            // K4, K5: one warp per query, 4 per block
constexpr int kChunk = 32;           // K6: channels per block, one per lane
constexpr int kMaxBandRows = 8;      // K6: fmap2 rows per block, one per warp
constexpr int kSmemBudget = 96 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* ptr[kMaxLevels];  // K4, K5: fmap2 levels; K6: df2 levels
  int H[kMaxLevels];
  int W[kMaxLevels];
  int band_start[kMaxLevels + 1];  // K6: first band (block) of each level
  int n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack2(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);  // bf16 -> fp32 is exact: the high half
  v[1] = __uint_as_float(u & 0xffff0000u);
}

// CPL consecutive channels at p (16-byte aligned for CPL = 8 bf16 or 4 fp32).
template <int CPL>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < CPL; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}
template <int CPL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (CPL == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    unpack2(a.x, v); unpack2(a.y, v + 2); unpack2(a.z, v + 4); unpack2(a.w, v + 6);
  } else {
    static_assert(CPL == 4, "4 or 8 channels per lane");
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    unpack2(a.x, v); unpack2(a.y, v + 2);
  }
}

// One query at one level: the first tap (x0 - r, y0 - r) and the fraction.
// The floor is clamped in float before the int cast (a cast of a far
// out-of-range float is undefined); [-(r+2), n+r] keeps every tap of a
// clamped query on the side of the bounds it was on.
struct Taps {
  int x, y;
  float fx, fy;
};
template <int R>
__device__ __forceinline__ Taps query_taps(float cx0, float cy0, int l, int H, int W) {
  const float s = ldexpf(1.0f, -l);
  const float cx = cx0 * s, cy = cy0 * s;
  const float x0 = floorf(cx), y0 = floorf(cy);
  Taps t;
  t.fx = cx - x0;
  t.fy = cy - y0;
  t.x = (int)fminf(fmaxf(x0, -(float)(R + 2)), (float)(W + R)) - R;
  t.y = (int)fminf(fmaxf(y0, -(float)(R + 2)), (float)(H + R)) - R;
  return t;
}

// Lanes hold p[0..15] (partial sums of 16 taps over their channels). After
// the call lane L holds the full sum of tap (L >> 1) & 15 (lanes 2t and
// 2t+1 both). A reduce-scatter: 16 shuffles for 16 sums, in a fixed order.
__device__ __forceinline__ float reduce16(float* p, int lane) {
#pragma unroll
  for (int half = 8, bit = 16; half >= 1; half >>= 1, bit >>= 1) {
    const bool up = lane & bit;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const float send = up ? p[m] : p[m + half];
      const float keep = up ? p[m + half] : p[m];
      p[m] = keep + __shfl_xor_sync(kFull, send, bit);
    }
  }
  return p[0] + __shfl_xor_sync(kFull, p[0], 1);
}

// ---------------------------------------------------------------------------
// K4. One warp per query; lane owns channels [lane*CPL, lane*CPL + CPL) of
// f1 in registers. For each level and tap row j the lanes form partial dots
// of the row's 2r+2 taps, reduce them (reduce16), and lane 2a combines rows
// j-1 and j into window row c = j-1 at column a. Writes every output of its
// query, zeros for an empty level.
template <typename T, typename TO, int R, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
    ondemand_fwd_kernel(const T* __restrict__ f1, Levels lv,
                        const float* __restrict__ coords, TO* __restrict__ out,
                        int64_t bq_total, int Q, float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int64_t bq = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bq >= bq_total) return;  // whole warps
  const int64_t b = bq / Q;
  float a1[CPL];
  load_vec<CPL>(f1 + bq * C + lane * CPL, a1);
  const float cx0 = coords[2 * bq], cy0 = coords[2 * bq + 1];
  TO* o = out + bq * (int64_t)(lv.n * K * K);
  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    TO* ol = o + l * K * K;
    if (H <= 0 || W <= 0) {
      for (int k = lane; k < K * K; k += 32) store_f(ol + k, 0.0f);
      continue;
    }
    const Taps t = query_taps<R>(cx0, cy0, l, H, W);
    const T* f2 = static_cast<const T*>(lv.ptr[l]) + b * ((int64_t)H * W * C) + lane * CPL;
    float prev = 0.0f;
    for (int j = 0; j < NT; ++j) {
      const int y = t.y + j;
      float cur = 0.0f;
      if (y >= 0 && y < H) {  // uniform over the warp
        float p[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) p[i] = 0.0f;
        const T* row = f2 + (int64_t)y * W * C;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int x = t.x + i;
          if (x >= 0 && x < W) {
            float v[CPL];
            load_vec<CPL>(row + (int64_t)x * C, v);
            float acc = 0.0f;
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc = fmaf(a1[c], v[c], acc);
            p[i] = acc;
          }
        }
        cur = reduce16(p, lane);
      }
      if (j > 0) {
        const float prev_n = __shfl_down_sync(kFull, prev, 2);  // tap a+1, row j-1
        const float cur_n = __shfl_down_sync(kFull, cur, 2);    // tap a+1, row j
        const float top = (1.0f - t.fx) * prev + t.fx * prev_n;
        const float bot = (1.0f - t.fx) * cur + t.fx * cur_n;
        const float v = ((1.0f - t.fy) * top + t.fy * bot) * inv_sqrt_c;
        const int a = lane >> 1;
        if (!(lane & 1) && a < K) store_f(ol + a * K + (j - 1), v);
      }
      prev = cur;
    }
  }
}

// The cotangent of window row c = j (weight 1-fy on tap row j) and c = j-1
// (weight fy), summed for column a = lane, times 1/sqrt(C); 0 on lanes >= K.
template <typename TG, int R>
__device__ __forceinline__ float row_cotangent(const TG* __restrict__ gl, int j,
                                               float fy, float inv_sqrt_c, int lane) {
  constexpr int K = 2 * R + 1;
  float gy = 0.0f;
  if (lane < K) {
    const float g0 = j < K ? to_f(gl[lane * K + j]) * inv_sqrt_c : 0.0f;
    const float g1 = j >= 1 ? to_f(gl[lane * K + j - 1]) * inv_sqrt_c : 0.0f;
    gy = (1.0f - fy) * g0 + fy * g1;
  }
  return gy;
}

// drows of tap i from the row cotangents held by lanes 0..K-1.
__device__ __forceinline__ float tap_cotangent(float gy, int i, float fx) {
  const float gi = __shfl_sync(kFull, gy, i);                // column a = i
  const float gm = __shfl_sync(kFull, gy, i > 0 ? i - 1 : 31);  // a = i-1 (lane 31: 0)
  return (1.0f - fx) * gi + fx * gm;
}

// ---------------------------------------------------------------------------
// K5. One warp per query; lane owns channels [lane*CPL, +CPL) of df1 in
// registers and sums drows * f2 over every level and in-bounds tap, levels
// and taps in order. Every df1 element written once: no atomics, no memset.
template <typename T, typename TG, int R, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
    ondemand_bwd_df1_kernel(Levels lv, const float* __restrict__ coords,
                            const TG* __restrict__ g, float* __restrict__ df1,
                            int64_t bq_total, int Q, float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  constexpr int C = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int64_t bq = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bq >= bq_total) return;
  const int64_t b = bq / Q;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  const float cx0 = coords[2 * bq], cy0 = coords[2 * bq + 1];
  const TG* gq = g + bq * (int64_t)(lv.n * K * K);
  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    if (H <= 0 || W <= 0) continue;
    const Taps t = query_taps<R>(cx0, cy0, l, H, W);
    const T* f2 = static_cast<const T*>(lv.ptr[l]) + b * ((int64_t)H * W * C) + lane * CPL;
    for (int j = 0; j < NT; ++j) {
      const int y = t.y + j;
      if (y < 0 || y >= H) continue;  // uniform over the warp
      const float gy = row_cotangent<TG, R>(gq + l * K * K, j, t.fy, inv_sqrt_c, lane);
      const T* row = f2 + (int64_t)y * W * C;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float d = tap_cotangent(gy, i, t.fx);
        const int x = t.x + i;
        if (x >= 0 && x < W) {
          float v[CPL];
          load_vec<CPL>(row + (int64_t)x * C, v);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[c] = fmaf(d, v[c], acc[c]);
        }
      }
    }
  }
  float* o = df1 + bq * C + lane * CPL;
#pragma unroll
  for (int c = 0; c < CPL; c += 4)
    *reinterpret_cast<float4*>(o + c) = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
}

// ---------------------------------------------------------------------------
// K6, the scatter df2_l[p, :] = sum_q drows_q(p) f1[q, :], made a gather so
// that it needs no atomics and gives the same bits on every run.
// A block owns a band of `rows` fmap2 rows (all Wl columns) of one batch
// element and level, and 32 channels: warp w owns row y0 + w, lane the
// channel, and the band's sums live in shared memory [rows][Wl][32] (lane =
// bank: no conflicts). The block walks the batch element's queries in
// order, blockDim at a time: each thread tests one query's tap rows and
// columns against the band (8 bytes of coords), a ballot and a prefix sum
// list the hits in query order, and then each warp adds every hit's
// contribution to its own row. So each df2 element is summed by one thread,
// over the queries in ascending order, one term per query: deterministic.
// Every element of every level is written once at the end: no memset.
template <typename T, typename TG, int R>
__global__ void ondemand_bwd_df2_kernel(Levels lv, const float* __restrict__ coords,
                                        const TG* __restrict__ g,
                                        const T* __restrict__ f1, int Q, int C,
                                        int rows, float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  extern __shared__ float smem[];
  __shared__ int hits[kMaxBandRows * 32];
  __shared__ int warp_hits[kMaxBandRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nthreads = blockDim.x;
  int l = 0;
  while (l + 1 < lv.n && (int)blockIdx.x >= lv.band_start[l + 1]) ++l;
  const int H = lv.H[l], W = lv.W[l];
  const int y0 = ((int)blockIdx.x - lv.band_start[l]) * rows;
  const int c0 = blockIdx.y * kChunk;
  const int64_t b = blockIdx.z;
  const int y = y0 + warp;  // this warp's fmap2 row (may be past H: idle)
  float* acc = smem + (size_t)warp * W * kChunk;
  for (int x = 0; x < W; ++x) acc[x * kChunk + lane] = 0.0f;
  const float* cb = coords + b * 2 * (int64_t)Q;
  const TG* gb = g + b * (int64_t)Q * (lv.n * K * K) + l * K * K;
  const T* f1b = f1 + b * (int64_t)Q * C + c0 + lane;
  const int band_end = min(y0 + rows, H);
  for (int q0 = 0; q0 < Q; q0 += nthreads) {
    const int q = q0 + (int)threadIdx.x;
    bool hit = false;
    if (q < Q) {
      const Taps t = query_taps<R>(cb[2 * q], cb[2 * q + 1], l, H, W);
      hit = t.y + NT - 1 >= y0 && t.y < band_end && t.x + NT - 1 >= 0 && t.x < W;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nthreads / 32; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) hits[before + __popc(mask & ((1u << lane) - 1))] = q;
    __syncthreads();
    if (y < band_end) {
      for (int h = 0; h < total; ++h) {
        const int qh = hits[h];
        const Taps t = query_taps<R>(cb[2 * qh], cb[2 * qh + 1], l, H, W);
        const int j = y - t.y;
        if (j < 0 || j >= NT) continue;  // uniform over the warp
        const float gy = row_cotangent<TG, R>(gb + (int64_t)qh * (lv.n * K * K), j, t.fy,
                                              inv_sqrt_c, lane);
        const float fv = to_f(f1b[(int64_t)qh * C]);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float d = tap_cotangent(gy, i, t.fx);
          const int x = t.x + i;
          if (x >= 0 && x < W) acc[x * kChunk + lane] = fmaf(d, fv, acc[x * kChunk + lane]);
        }
      }
    }
    __syncthreads();  // hits[] is rewritten by the next round
  }
  if (y < band_end) {
    float* out = static_cast<float*>(const_cast<void*>(lv.ptr[l])) +
                 ((b * H + y) * (int64_t)W) * C + c0 + lane;
    for (int x = 0; x < W; ++x) out[(int64_t)x * C] = acc[x * kChunk + lane];
  }
}

bool fill_levels(Levels* lv, const void* const* ptrs, const int* h, const int* w, int n) {
  if (n < 1 || n > kMaxLevels) return false;
  lv->n = n;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < n;
    lv->ptr[i] = used ? ptrs[i] : nullptr;
    lv->H[i] = used ? h[i] : 0;
    lv->W[i] = used ? w[i] : 0;
    if (used && (lv->H[i] < 0 || lv->W[i] < 0)) return false;
  }
  return true;
}

bool kernel_shape_ok(int B, int Q, int C, int radius) {
  return B >= 0 && Q >= 0 && (C == 128 || C == 256) && (radius == 3 || radius == 4);
}

float inv_sqrt(int C) { return (float)(1.0 / sqrt((double)C)); }

template <typename T, typename TO, int R, int CPL>
void launch_fwd(const void* f1, const Levels& lv, const void* coords, void* out,
                int64_t bq, int Q, int C, cudaStream_t s) {
  const unsigned blocks = (unsigned)((bq + kWarps - 1) / kWarps);
  ondemand_fwd_kernel<T, TO, R, CPL><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const T*>(f1), lv, static_cast<const float*>(coords),
      static_cast<TO*>(out), bq, Q, inv_sqrt(C));
}

template <typename T, typename TO, int R>
void fwd_by_width(const void* f1, const Levels& lv, const void* coords, void* out,
                  int64_t bq, int Q, int C, cudaStream_t s) {
  if (C == 256) launch_fwd<T, TO, R, 8>(f1, lv, coords, out, bq, Q, C, s);
  else launch_fwd<T, TO, R, 4>(f1, lv, coords, out, bq, Q, C, s);
}

template <typename T, typename TO>
void fwd_by_radius(const void* f1, const Levels& lv, const void* coords, void* out,
                   int64_t bq, int Q, int C, int radius, cudaStream_t s) {
  if (radius == 4) fwd_by_width<T, TO, 4>(f1, lv, coords, out, bq, Q, C, s);
  else fwd_by_width<T, TO, 3>(f1, lv, coords, out, bq, Q, C, s);
}

template <typename T, typename TG, int R, int CPL>
void launch_df1(const Levels& lv, const void* coords, const void* g, void* df1,
                int64_t bq, int Q, int C, cudaStream_t s) {
  const unsigned blocks = (unsigned)((bq + kWarps - 1) / kWarps);
  ondemand_bwd_df1_kernel<T, TG, R, CPL><<<blocks, kWarps * 32, 0, s>>>(
      lv, static_cast<const float*>(coords), static_cast<const TG*>(g),
      static_cast<float*>(df1), bq, Q, inv_sqrt(C));
}

template <typename T, typename TG>
void df1_by_shape(const Levels& lv, const void* coords, const void* g, void* df1,
                  int64_t bq, int Q, int C, int radius, cudaStream_t s) {
  if (radius == 4) {
    if (C == 256) launch_df1<T, TG, 4, 8>(lv, coords, g, df1, bq, Q, C, s);
    else launch_df1<T, TG, 4, 4>(lv, coords, g, df1, bq, Q, C, s);
  } else {
    if (C == 256) launch_df1<T, TG, 3, 8>(lv, coords, g, df1, bq, Q, C, s);
    else launch_df1<T, TG, 3, 4>(lv, coords, g, df1, bq, Q, C, s);
  }
}

template <typename T, typename TG, int R>
cudaError_t launch_df2(const Levels& lv, const void* coords, const void* g,
                       const void* f1, int B, int Q, int C, int rows, size_t smem,
                       cudaStream_t s) {
  auto kernel = ondemand_bwd_df2_kernel<T, TG, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)lv.band_start[lv.n], (unsigned)(C / kChunk), (unsigned)B);
  kernel<<<grid, rows * 32, smem, s>>>(lv, static_cast<const float*>(coords),
                                       static_cast<const TG*>(g), static_cast<const T*>(f1),
                                       Q, C, rows, inv_sqrt(C));
  return cudaSuccess;
}

template <typename T, typename TG>
cudaError_t df2_by_radius(const Levels& lv, const void* coords, const void* g,
                          const void* f1, int B, int Q, int C, int radius, int rows,
                          size_t smem, cudaStream_t s) {
  if (radius == 4) return launch_df2<T, TG, 4>(lv, coords, g, f1, B, Q, C, rows, smem, s);
  return launch_df2<T, TG, 3>(lv, coords, g, f1, B, Q, C, rows, smem, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each function returns a
// cudaError_t as int. level_ptrs, level_h, level_w: host arrays of n_levels
// entries. All tensors contiguous, 16-byte aligned; C in {128, 256}, radius
// in {3, 4}.

// f1 [B, Q, C] and fmap2 levels [B, Hl, Wl, C] (in_dtype), coords [B, Q, 2]
// fp32 level-0, out [B, Q, n_levels*K*K] (out_dtype).
extern "C" int raft_corr_ondemand_fwd(const void* f1, const void* const* level_ptrs,
                                      const int* level_h, const int* level_w,
                                      int n_levels, const void* coords, void* out,
                                      int B, int Q, int C, int radius, int in_dtype,
                                      int out_dtype, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, level_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t bq = (int64_t)B * Q;
  if (bq == 0) return (int)cudaSuccess;
  if ((bq + kWarps - 1) / kWarps > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0: fwd_by_radius<float, float>(f1, lv, coords, out, bq, Q, C, radius, s); break;
    case 1: fwd_by_radius<float, __nv_bfloat16>(f1, lv, coords, out, bq, Q, C, radius, s); break;
    case 2: fwd_by_radius<__nv_bfloat16, float>(f1, lv, coords, out, bq, Q, C, radius, s); break;
    default: fwd_by_radius<__nv_bfloat16, __nv_bfloat16>(f1, lv, coords, out, bq, Q, C, radius, s); break;
  }
  return (int)cudaGetLastError();
}

// fmap2 levels [B, Hl, Wl, C] (f2_dtype), coords [B, Q, 2] fp32 level-0,
// g [B, Q, n_levels*K*K] (g_dtype), df1 [B, Q, C] fp32 (every element written).
extern "C" int raft_corr_ondemand_bwd_df1(const void* const* level_ptrs, const int* level_h,
                                          const int* level_w, int n_levels,
                                          const void* coords, const void* g, void* df1,
                                          int B, int Q, int C, int radius, int f2_dtype,
                                          int g_dtype, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, level_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || f2_dtype < 0 || f2_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t bq = (int64_t)B * Q;
  if (bq == 0) return (int)cudaSuccess;
  if ((bq + kWarps - 1) / kWarps > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f2_dtype * 2 + g_dtype) {
    case 0: df1_by_shape<float, float>(lv, coords, g, df1, bq, Q, C, radius, s); break;
    case 1: df1_by_shape<float, __nv_bfloat16>(lv, coords, g, df1, bq, Q, C, radius, s); break;
    case 2: df1_by_shape<__nv_bfloat16, float>(lv, coords, g, df1, bq, Q, C, radius, s); break;
    default: df1_by_shape<__nv_bfloat16, __nv_bfloat16>(lv, coords, g, df1, bq, Q, C, radius, s); break;
  }
  return (int)cudaGetLastError();
}

// df2 levels [B, Hl, Wl, C] fp32 (every element written; empty levels
// allowed), coords [B, Q, 2] fp32 level-0, g [B, Q, n_levels*K*K] (g_dtype),
// f1 [B, Q, C] (f1_dtype).
extern "C" int raft_corr_ondemand_bwd_df2(const void* const* df2_ptrs, const int* level_h,
                                          const int* level_w, int n_levels,
                                          const void* coords, const void* g, const void* f1,
                                          int B, int Q, int C, int radius, int f1_dtype,
                                          int g_dtype, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, df2_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || f1_dtype < 0 || f1_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return (int)cudaSuccess;
  // rows per band: as many as fit the shared-memory budget at the widest level
  int w_max = 1;
  for (int i = 0; i < n_levels; ++i) w_max = lv.W[i] > w_max ? lv.W[i] : w_max;
  const size_t row_bytes = (size_t)w_max * kChunk * sizeof(float);
  if (row_bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int rows = (int)(kSmemBudget / row_bytes);
  rows = rows < 1 ? 1 : (rows > kMaxBandRows ? kMaxBandRows : rows);
  lv.band_start[0] = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int bands = (i < n_levels && lv.W[i] > 0) ? (lv.H[i] + rows - 1) / rows : 0;
    lv.band_start[i + 1] = lv.band_start[i] + bands;
  }
  if (lv.band_start[n_levels] == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)rows * row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (f1_dtype * 2 + g_dtype) {
    case 0: err = df2_by_radius<float, float>(lv, coords, g, f1, B, Q, C, radius, rows, smem, s); break;
    case 1: err = df2_by_radius<float, __nv_bfloat16>(lv, coords, g, f1, B, Q, C, radius, rows, smem, s); break;
    case 2: err = df2_by_radius<__nv_bfloat16, float>(lv, coords, g, f1, B, Q, C, radius, rows, smem, s); break;
    default: err = df2_by_radius<__nv_bfloat16, __nv_bfloat16>(lv, coords, g, f1, B, Q, C, radius, rows, smem, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

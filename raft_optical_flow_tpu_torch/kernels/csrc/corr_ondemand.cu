// On-demand windowed correlation (alt_cuda_corr) for Hopper (sm_90a): the
// windows of RAFT's correlation pyramid computed from the feature maps,
// without the HW x HW volume. Built by kernels/_build.py with plain nvcc;
// bound through ctypes by kernels/corr_ondemand.py. No PyTorch headers.
//
// Replaces the Pallas TPU kernels of
// raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:
//   raft_corr_ondemand_fwd      <- _fwd_level_kernel, _fwd_level_stream_kernel (K4)
//   raft_corr_ondemand_bwd_df1  <- _bwd_df1_kernel, _bwd_df1_stream_kernel     (K5)
//   raft_corr_ondemand_bwd_df2  <- _bwd_df2_kernel, _bwd_df2_stream_kernel     (K6,
//                                  with its prepass raft_corr_ondemand_df2_plan)
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
// K4, bound on the card and design. A query reads its (2r+2)^2 taps of C
// channels at each level: 400 C-long dot products at r = 4 with four
// levels, against one C-long read of f1 and 324 outputs. At the batch-16
// serving shape (bf16, C = 256) the compulsory bytes are about 208 MB,
// 0.062 ms at 3.35 TB/s, and the products 17 GFLOP: bytes bound the
// function. A warp per query that re-reads its own taps through L1/L2 (the
// first design, now only the per-query route below) moves about 23 GB of
// cache traffic per launch there. Both dtypes instead share taps between
// neighbouring queries; the bf16 tiles:
// a block takes a tile of 4 x 16 queries of the query grid (the level-0
// map's own grid when Q = H0 * W0, as RAFT's coords are, or the grid width
// the caller gives; else rows of 16 consecutive queries; the tiles decide
// the speed and the route of each tile, see below),
// a warp per row of 16 (the M of mma.sync m16n8k16), and per level stages,
// row by row, the fmap2 pixels of the box that holds the in-bounds taps of
// all 64 windows in shared memory (128 channels a unit, cp.async,
// double-buffered), once per block. Each warp keeps its 16 queries' f1 rows
// as mma A fragments in registers for the whole launch, and multiplies them
// with its own columns of each staged row on the tensor cores (bf16 in,
// fp32 accumulate): 16 queries x 8 pixels a product, so its dots cover the
// union of its queries' tap columns, and a query whose row or column lies
// outside that union just takes products it never reads. The dots of a row
// go through shared memory to the lanes of their query, which blend them in
// fp32 as above (tap row j, once both rows j-1 and j are in) into a
// per-warp window tile; the tile is written to device memory once per level
// with consecutive stores. What bounds it: each staged unit is a trip to L2
// and back (about (16 + 9 + spread) pixels x 256 B; spread is how far the
// tile's displacements differ) that the block waits for, one unit ahead, so
// three blocks an SM (168 registers, 67 KB of shared memory each) keep
// three trips in flight; the products (a few times the useful ones) stay
// well under the tensor cores' rate.
// A tile whose box is wider than kMaxBoxW pixels, or taller than kMaxBoxRows
// rows, or whose warp's columns exceed kMaxWarpCols (coords spread over the
// whole level, wrapped rows of a very wide map) takes the per-query route
// for that level inside the kernel: a warp per query, the taps read from
// device memory and dotted on the CUDA cores (the first design's body). The
// two routes sum a dot's products in other orders, so a query's bf16 output
// may round one bf16 step apart between them: other tiles of the same
// queries (another grid) may change a value by that step. A far
// out-of-bounds query has no in-bounds tap and adds nothing to the box.
// Each tile and level records the route it took (g_fwd_route), which
// raft_corr_ondemand_fwd_routes counts for the last launch of either dtype.
// fp32 operands take the same tiles, boxes and routes. One TF32 product
// keeps 11 significant bits, which the fp32 gate (max_rel 2e-5) and policy
// do not allow; so each fp32 operand goes in as two TF32 parts (hi, lo) and
// each product as three TF32 mma (lo*hi, hi*lo, hi*hi), the product to
// about 2^-21 as the JAX package's Precision.HIGHEST does it on the TPU
// (multi-pass bf16). f1 as hi and lo parts at C = 256 would take 256
// registers a lane, so the fp32 tiles stage 64-channel units (the bf16
// unit's 256 bytes a pixel), load each unit's f1 as A fragments when the
// unit starts, and sum each unit's products into a per-warp table of the
// (2r+2)^2 tap dots in shared memory, blended into the windows at the end;
// warps take 4 x 4 patches of the tile, whose windows span fewer columns
// than a row of 16, and a block one level of its tile (a batch-1 frame's
// 112 tiles make 448 blocks). Each fp32 tap dot sums its units and k-steps
// in a fixed order whatever the query's place in its tile, so an fp32
// output depends on its own inputs and its tile's route only; the two
// routes sum in other orders (a few ulp).
// K5 does the products of K4 backwards on K4's tiles and staged boxes,
// drows times the staged pixels on the tensor cores: bf16 fmap2 in three
// exact bf16 pieces of drows, fp32 fmap2 in three TF32 passes. K6 sums over
// queries for each fmap2 pixel after a prepass (see their notes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

// K4 bf16 (tiled): 4 warps, each 16 queries of one row of the query grid;
// staged units of 128 channels
constexpr int kTileWarps = 4;
constexpr int kTileCols = 16;               // the mma's M
constexpr int kUnitC = 128;
constexpr int kPixBytes = kUnitC * 2 + 64;  // a staged pixel: 2 pixels of a 128-byte
                                            // LDS.128 phase fall in other banks
constexpr int kMaxBoxW = 56;                // box columns a unit stages
constexpr int kMaxBoxRows = 48;             // box rows a tile may walk
constexpr int kMaxWarpCols = 56;            // columns of one warp's products (7 n-tiles)
constexpr int kStageBytes = (kMaxBoxW + 8) * kPixBytes;  // + 8: a warp's last n-tile may
                                                         // reach past the box
constexpr int kStages = 2;                  // staged units in flight and in use
constexpr int kSRow = kMaxWarpCols + 4;     // fp32 stride of a warp's dot rows
constexpr int kMaxKK = 81;                  // (2r+1)^2 at r = 4
template <typename TO>
constexpr size_t fwd_smem() {
  return kStages * (size_t)kStageBytes + (size_t)kTileWarps * 16 * kSRow * 4 +
         (size_t)kTileWarps * 16 * kMaxKK * sizeof(TO);
}
constexpr int kMaxRecordedTiles = 1 << 16;

// K4 fp32 (tiled): the same tiles; staged units of 64 fp32 channels (the
// bf16 unit's 256 bytes a pixel), and per warp a table of its 16 queries'
// (2r+2)^2 tap dots
constexpr int kUnit32 = 64;
constexpr int kPitch32 = kUnit32 * 4 + 64;  // lanes (g, t) read pixel g's chunk t: 8 banks apart
constexpr int kStage32Bytes = (kMaxBoxW + 8) * kPitch32;
static_assert(kUnit32 * 4 == kUnitC * 2, "one unit is 256 bytes a pixel in either dtype");
template <int R>
constexpr size_t fwd32_smem() {
  return kStages * (size_t)kStage32Bytes + (size_t)kTileWarps * 16 * (2 * R + 2) * (2 * R + 2) * 4;
}

// K6: 8 warps; a warp sums 4 columns of a row over 32*cpl channels
constexpr int kDf2Warps = 8;
constexpr int kDf2Threads = kDf2Warps * 32;
constexpr int kDf2TargetBlocks = 264;  // two blocks per SM of an H100 at every level
constexpr int kDf2F1Bytes = 32 * 1024;  // a round's f1 rows in shared memory
constexpr int kHdW = 16;               // a hit's padded tap cotangents: 3 + (2r + 2) + 3
constexpr int kPlanWarps = 16;         // prepass: warps per (level, batch element)
constexpr int kPlanSmem = 48 * 1024;   // its counts: warps x fmap2 rows ints

struct Levels {
  const void* ptr[kMaxLevels];  // fmap2 levels (K4, K5) or df2 levels (K6)
  int H[kMaxLevels];
  int W[kMaxLevels];
  int n;
};

// K6's launch plan, per level: cg column groups of 4 columns per block
// times cs channel groups of 32*cpl (a warp each), nseg blocks across a row,
// ncb channel blocks of cs*32*cpl channels; blocks [block_start[l],
// block_start[l+1]) of each batch element.
struct Df2Grid {
  int cg[kMaxLevels];
  int cs[kMaxLevels];
  int nseg[kMaxLevels];
  int ncb[kMaxLevels];
  int cpl[kMaxLevels];
  int block_start[kMaxLevels + 1];
};

// Route of each (tile, level) of the last K4 launch (either dtype): 0 empty
// level, 1 tiled, 2 per query. Each block writes only its own entries.
__device__ unsigned char g_fwd_route[kMaxRecordedTiles * kMaxLevels];
int g_last_tiles = 0;
int g_last_levels = 0;

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

// CPL consecutive channels at p (aligned to CPL elements, 16 bytes at most).
template <int CPL>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (CPL >= 4) {
#pragma unroll
    for (int i = 0; i < CPL; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  } else if constexpr (CPL == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}
template <int CPL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (CPL == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    unpack2(a.x, v); unpack2(a.y, v + 2); unpack2(a.z, v + 4); unpack2(a.w, v + 6);
  } else if constexpr (CPL == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    unpack2(a.x, v); unpack2(a.y, v + 2);
  } else if constexpr (CPL == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), v);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int CPL>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (CPL >= 4) {
#pragma unroll
    for (int i = 0; i < CPL; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (CPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
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

// One query at one level, a warp per query on the CUDA cores: lane owns
// channels [lane*CPL, lane*CPL + CPL) of f1 (a1, in registers). For each tap
// row j the lanes form partial dots of the row's 2r+2 taps, reduce them
// (reduce16), and lane 2a combines rows j-1 and j into window row c = j-1 at
// column a, stored at o[a*K + c]. Every window value is stored.
template <typename T, typename TO, int R, int CPL>
__device__ __forceinline__ void query_window(const float* a1, const T* __restrict__ f2, int H,
                                             int W, const Taps& t, TO* o, float inv_sqrt_c,
                                             int lane) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  constexpr int C = 32 * CPL;
  f2 += lane * CPL;
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
      if (!(lane & 1) && a < K) store_f(o + a * K + (j - 1), v);
    }
    prev = cur;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups landed
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += A (16 x 16, bf16, row-major) x B (16 x 8, bf16, col-major), fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A (16 x 8, TF32, row-major) x B (8 x 8, TF32, col-major), fp32. A
// fragment: a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4); B: b0 (k t, n g), b1 (t + 4, g); lane = 4 g + t.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as two TF32 parts (bit patterns): hi = v rounded to TF32's 11
// significant bits (to nearest, ties away), lo = v - hi (exact in fp32),
// whose low 13 bits the mma ignores (it truncates lo to TF32); v - hi - lo
// as the mma reads them is below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a * b to fp32 precision on the tensor cores: three TF32 products of
// the parts, smallest first (lo*hi, hi*lo, hi*hi), into one accumulator;
// lo*lo (below 2^-21 of the product) is left out. Never one TF32 pass.
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Stages one unit of a box row: bw pixels x 256 bytes (kUnitC bf16 or
// kUnit32 fp32 channels) from src (pixel stride `stride` bytes) into shared
// memory at dst, PITCH bytes a pixel, 16 bytes a cp.async, by the block's
// NTHREADS threads. K4 and K5 stage their boxes with it.
template <int PITCH, int NTHREADS>
__device__ __forceinline__ void stage_unit(uint32_t dst, const void* src, int bw, int stride,
                                           int tid) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int e = tid; e < bw * 16; e += NTHREADS) {
    const int px = e >> 4, v = e & 15;
    cp_async16(dst + px * PITCH + v * 16, s + (int64_t)px * stride + v * 16);
  }
}

// The box of a tile of kTileWarps warps at one level. Each lane gives the
// in-bounds tap range of one query of its warp (has: any; every query of the
// warp on some lane); the warp's union (wx0..wy1), then the block's (bx0..,
// through wrange, with a __syncthreads), and whether the tile stages it
// (tiled) or takes the per-query route. Called by every thread.
struct TileBox {
  int wx0, wx1, wy0, wy1;  // the warp's union (warp_has: not empty)
  int bx0, by0, bw, bh;    // the block's (bw = bh = 0: empty)
  bool warp_has, tiled;
};
__device__ __forceinline__ TileBox tile_box(bool has, int xlo, int xhi, int ylo, int yhi,
                                            int (*wrange)[5], int warp, int lane) {
  TileBox t;
  t.wx0 = __reduce_min_sync(kFull, has ? xlo : INT_MAX);
  t.wx1 = __reduce_max_sync(kFull, has ? xhi : INT_MIN);
  t.wy0 = __reduce_min_sync(kFull, has ? ylo : INT_MAX);
  t.wy1 = __reduce_max_sync(kFull, has ? yhi : INT_MIN);
  t.warp_has = t.wx0 <= t.wx1;
  if (lane == 0) {
    wrange[warp][0] = t.wx0; wrange[warp][1] = t.wx1;
    wrange[warp][2] = t.wy0; wrange[warp][3] = t.wy1;
    wrange[warp][4] = !t.warp_has || t.wx1 - t.wx0 + 1 <= kMaxWarpCols;
  }
  __syncthreads();
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
  bool fits = true;
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    bx0 = min(bx0, wrange[w][0]); bx1 = max(bx1, wrange[w][1]);
    by0 = min(by0, wrange[w][2]); by1 = max(by1, wrange[w][3]);
    fits = fits && wrange[w][4];
  }
  const bool any = bx0 <= bx1;
  t.bx0 = bx0;
  t.by0 = by0;
  t.bw = any ? bx1 - bx0 + 1 : 0;
  t.bh = any ? by1 - by0 + 1 : 0;
  t.tiled = !any || (fits && t.bw <= kMaxBoxW && t.bh <= kMaxBoxRows);
  return t;
}

// The tiles of K4's and K5's bf16 kernels: the query grid (grid_w columns
// when the caller gives them, e.g. a slab of the level-0 map's rows; else
// level 0's when the queries are its pixels, else rows of 16), tiles of
// kTileWarps rows x kTileCols queries of it per batch element.
struct TileGrid {
  int grid_w, tiles_x, tiles_per_b;
  int64_t tiles;
};
TileGrid tile_grid(const Levels& lv, int B, int Q, int grid_w = 0) {
  TileGrid tg;
  tg.grid_w = grid_w > 0 ? grid_w
              : (lv.W[0] > 0 && (int64_t)lv.H[0] * lv.W[0] == Q) ? lv.W[0] : kTileCols;
  tg.tiles_x = (tg.grid_w + kTileCols - 1) / kTileCols;
  const int64_t grid_h = ((int64_t)Q + tg.grid_w - 1) / tg.grid_w;
  const int64_t per_b = tg.tiles_x * ((grid_h + kTileWarps - 1) / kTileWarps);
  tg.tiles = B * per_b;
  tg.tiles_per_b = per_b > 0x7fffffff ? 0 : (int)per_b;
  return tg;
}

// ---------------------------------------------------------------------------
// K4, bf16 operands: the tiled kernel (see the note at the top). The queries
// are read as a grid of grid_w columns (query q at row q / grid_w, column
// q % grid_w): the grid width the caller gives (a slab of level 0's rows),
// else the level-0 map's own grid when Q = H0 * W0, as RAFT's coords are
// (so neighbouring queries look at neighbouring pixels), else rows of 16
// consecutive queries. The tiles, and so each tile's route, depend on it
// (a route may round a bf16 output one step apart). A block owns a tile of
// 4 grid rows x 16 columns of batch element b; warp w the (up to) 16
// queries qw + m of row w, m < nq. Lane (g, t) = (lane / 4, lane % 4) holds
// the A fragments of queries g and g + 8: for each 32-channel group kk,
// channels 32kk + 8t .. 32kk + 8t + 7 of both rows (two 16-byte loads). The
// k order of the mma is permuted the same way in A and B (k-step 2kk:
// channels 8t..8t+3 of each group, k-step 2kk+1: 8t+4..8t+7), so B comes
// from one 16-byte shared load of pixel g's channels 8t..8t+7 and no
// ldmatrix is needed. For the blend,
// lane (m, h) = (lane / 2, lane % 2) owns query m and window columns a of
// half h.
template <typename TO, int R, int C>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
    ondemand_fwd_tiled_kernel(const __nv_bfloat16* __restrict__ f1, Levels lv,
                              const float* __restrict__ coords, TO* __restrict__ out, int Q,
                              int grid_w, int tiles_x, int tiles_per_b, float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int NT = 2 * R + 2;
  constexpr int KG = C / 32;          // 32-channel groups
  constexpr int CU = C / kUnitC;      // staged units per box row
  constexpr int KH = (K + 1) / 2;     // window columns of blend half 0
  constexpr int CPL = C / 32;
  static_assert(KK <= kMaxKK, "window");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* dots_all = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  TO* win_all = reinterpret_cast<TO*>(dots_all + kTileWarps * 16 * kSRow);
  __shared__ int wrange[kTileWarps][5];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m = lane >> 1, half = lane & 1;
  const int64_t b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x % tiles_per_b;
  const int col0 = (tile % tiles_x) * kTileCols;
  const int qw = ((tile / tiles_x) * kTileWarps + warp) * grid_w + col0;  // warp's first query
  const int nq = max(0, min(min(kTileCols, grid_w - col0), Q - qw));      // its queries
  float* dots = dots_all + warp * 16 * kSRow;
  TO* win = win_all + warp * 16 * kMaxKK;

  // A fragments of queries qw + g and qw + g + 8 (zero past the warp's nq)
  uint32_t A[KG][8];
  {
    const __nv_bfloat16* fa = f1 + ((int64_t)b * Q + qw + g) * C + 8 * t4;
    const __nv_bfloat16* fb = fa + 8 * C;
    const bool va = g < nq, vb = g + 8 < nq;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      const uint4 ua = va ? *reinterpret_cast<const uint4*>(fa + 32 * kk) : make_uint4(0, 0, 0, 0);
      const uint4 ub = vb ? *reinterpret_cast<const uint4*>(fb + 32 * kk) : make_uint4(0, 0, 0, 0);
      A[kk][0] = ua.x; A[kk][1] = ua.y; A[kk][2] = ua.z; A[kk][3] = ua.w;
      A[kk][4] = ub.x; A[kk][5] = ub.y; A[kk][6] = ub.z; A[kk][7] = ub.w;
    }
  }
  const int qm = qw + m;  // the query this lane blends
  const bool valid_m = m < nq;
  float cx0 = 0.0f, cy0 = 0.0f;
  if (valid_m) {
    cx0 = coords[2 * ((int64_t)b * Q + qm)];
    cy0 = coords[2 * ((int64_t)b * Q + qm) + 1];
  }
  const int row_stride = lv.n * KK;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    for (int k = lane; k < 16 * KK; k += 32) store_f(win + k, 0.0f);
    int route = 0;
    if (H > 0 && W > 0) {  // uniform over the block
      const Taps tp = query_taps<R>(cx0, cy0, l, H, W);
      const int xlo = max(tp.x, 0), xhi = min(tp.x + NT - 1, W - 1);
      const int ylo = max(tp.y, 0), yhi = min(tp.y + NT - 1, H - 1);
      const bool has = valid_m && xlo <= xhi && ylo <= yhi;
      // the warp's box (the union of its queries' in-bounds taps), the block's
      const TileBox box = tile_box(has, xlo, xhi, ylo, yhi, wrange, warp, lane);
      const int wx0 = box.wx0, wx1 = box.wx1, wy0 = box.wy0, wy1 = box.wy1;
      const int bx0 = box.bx0, by0 = box.by0, bw = box.bw, bh = box.bh;
      const bool warp_has = box.warp_has, tiled = box.tiled;
      route = tiled ? 1 : 2;
      __syncwarp();
      if (tiled) {
        const __nv_bfloat16* f2 =
            static_cast<const __nv_bfloat16*>(lv.ptr[l]) + b * ((int64_t)H * W * C);
        const int ntw = warp_has ? (wx1 - wx0 + 8) / 8 : 0;  // the warp's n-tiles
        float hp[KH];                                        // h of the previous tap row
#pragma unroll
        for (int i = 0; i < KH; ++i) hp[i] = 0.0f;
        float acc[kMaxWarpCols / 8][4];
        const int nunits = bh * CU;
        const uint32_t stage_s = smem_addr(stage);
        auto issue = [&](int u) {
          const int y = by0 + u / CU, cu = u % CU;
          stage_unit<kPixBytes, kTileWarps * 32>(stage_s + (u % kStages) * kStageBytes,
                                                 f2 + ((int64_t)y * W + bx0) * C + cu * kUnitC,
                                                 bw, C * 2, tid);
        };
#pragma unroll
        for (int u = 0; u < kStages - 1; ++u) {
          if (u < nunits) issue(u);
          cp_async_commit();
        }
        for (int u = 0; u < nunits; ++u) {
          if (u + kStages - 1 < nunits) issue(u + kStages - 1);
          cp_async_commit();
          cp_async_wait<kStages - 1>();
          __syncthreads();
          const int y = by0 + u / CU, cu = u % CU;
          if (warp_has && y >= wy0 && y <= wy1) {  // uniform over the warp
            const unsigned char* st = stage + (u % kStages) * kStageBytes;
#pragma unroll
            for (int c2 = 0; c2 < CU; ++c2) {
              if (c2 != cu) continue;
              if (c2 == 0) {
#pragma unroll
                for (int nt = 0; nt < kMaxWarpCols / 8; ++nt)
                  acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
              }
#pragma unroll
              for (int nt = 0; nt < kMaxWarpCols / 8; ++nt) {
                if (nt < ntw) {
                  const unsigned char* px =
                      st + (wx0 - bx0 + nt * 8 + g) * kPixBytes + t4 * 16;
#pragma unroll
                  for (int kk = 0; kk < kUnitC / 32; ++kk) {
                    const uint4 bv = *reinterpret_cast<const uint4*>(px + kk * 64);
                    const uint32_t* a = A[c2 * (kUnitC / 32) + kk];
                    mma_bf16(acc[nt], a[0], a[4], a[1], a[5], bv.x, bv.y);
                    mma_bf16(acc[nt], a[2], a[6], a[3], a[7], bv.z, bv.w);
                  }
                }
              }
            }
            if (cu == CU - 1) {
              // the row's dots, query-major, then the blend of each lane's query
#pragma unroll
              for (int nt = 0; nt < kMaxWarpCols / 8; ++nt) {
                if (nt < ntw) {
                  const int col = nt * 8 + 2 * t4;
                  *reinterpret_cast<float2*>(dots + g * kSRow + col) =
                      make_float2(acc[nt][0], acc[nt][1]);
                  *reinterpret_cast<float2*>(dots + (g + 8) * kSRow + col) =
                      make_float2(acc[nt][2], acc[nt][3]);
                }
              }
              __syncwarp();
              if (has && y >= ylo && y <= yhi) {
                const int j = y - tp.y;
                const float* drow = dots + m * kSRow - wx0;
                const int a0 = half ? KH : 0;
                float d[KH + 1];
#pragma unroll
                for (int i = 0; i <= KH; ++i) {
                  const int x = tp.x + a0 + i;
                  d[i] = (a0 + i < NT && x >= xlo && x <= xhi) ? drow[x] : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < KH; ++i) {
                  const int a = a0 + i;
                  if (a < K) {
                    const float hc = (1.0f - tp.fx) * d[i] + tp.fx * d[i + 1];
                    if (j >= 1)
                      store_f(win + m * KK + a * K + (j - 1),
                              ((1.0f - tp.fy) * hp[i] + tp.fy * hc) * inv_sqrt_c);
                    if (y == yhi && j < K)
                      store_f(win + m * KK + a * K + j,
                              ((1.0f - tp.fy) * hc + tp.fy * 0.0f) * inv_sqrt_c);
                    hp[i] = hc;
                  }
                }
              }
              __syncwarp();
            }
          }
          __syncthreads();
        }
      } else {
        // per-query route: the warp's 16 queries one by one
        const __nv_bfloat16* f2 =
            static_cast<const __nv_bfloat16*>(lv.ptr[l]) + b * ((int64_t)H * W * C);
        for (int mm = 0; mm < 16; ++mm) {
          const float cx = __shfl_sync(kFull, cx0, 2 * mm);
          const float cy = __shfl_sync(kFull, cy0, 2 * mm);
          if (mm >= nq) break;  // uniform over the warp
          float a1[CPL];
          load_vec<CPL>(f1 + ((int64_t)b * Q + qw + mm) * C + lane * CPL, a1);
          query_window<__nv_bfloat16, TO, R, CPL>(a1, f2, H, W,
                                                    query_taps<R>(cx, cy, l, H, W),
                                                    win + mm * KK, inv_sqrt_c, lane);
        }
      }
    }
    if (tid == 0 && blockIdx.x < kMaxRecordedTiles)
      g_fwd_route[blockIdx.x * kMaxLevels + l] = (unsigned char)route;
    __syncwarp();
    // the warp's window tile: 16 queries x KK values, consecutive stores
    TO* o = out + ((int64_t)b * Q + qw) * row_stride + l * KK;
    for (int e = lane; e < 16 * KK; e += 32) {
      const int mq = e / KK, k = e - mq * KK;
      if (mq < nq) o[(int64_t)mq * row_stride + k] = win[e];
    }
    __syncthreads();  // wrange and win are rewritten for the next level
  }
}

// ---------------------------------------------------------------------------
// K4, fp32 operands: the tiled kernel in fp32 (see the note at the top). A
// block takes the bf16 kernel's tile of 4 grid rows x 16 columns at one
// level (blockIdx.y: a tile's levels run in parallel, so a batch-1 frame
// still fills the card) with the same box, route and route record; warp w
// its 4 x 4 patch of columns 4w..4w+3, the mma's 16 rows (query of row mr:
// grid row mr / 4, column mr % 4 of the patch). The block stages the box
// unit by unit (64 channels), each unit's rows in turn (cp.async, one
// ahead, one barrier a row). When a unit starts, each warp loads its
// queries' 64 channels of f1 from device memory into registers, the A
// fragments' fp32 values (lane (g, t): rows g and g + 8, channels 16v + 4t
// .. + 3 with one 16-byte load each; k-step 2v + e takes channel 16v + 4t +
// 2e as k = t and the next as k = t + 4, and B the same, so a lane reads
// pixel g's 16 bytes 16v + 4t of the staged row, bank-free at kPitch32),
// split into hi and lo parts where used (32 registers, not 64). For each
// staged row of its rows the warp multiplies them with its columns (n-tiles
// of 8 pixels from its first column) in three TF32 passes, the hi*hi
// products into one accumulator and the cross terms into another (two
// shorter chains of dependent mma, added before use), and each lane adds
// the products it holds that land on a tap of their query's window (a
// mask per lane and level: tap inside the (2r+2)^2, x < W) into the warp's
// tap table tab[mr][j][i] in shared memory: the lane that holds a (query,
// column) product is the same for every unit, so each entry has one writer,
// and a tap out of bounds stays 0. Once the units are in, the warp blends
// each window value from its table, a value a lane in the output's order
// (consecutive stores). A tap dot sums its units in order, each unit's
// k-steps and passes in order, whatever the query's place in its tile.
template <typename TO, int R, int C>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
    ondemand_fwd_tiled_fp32_kernel(const float* __restrict__ f1, Levels lv,
                                   const float* __restrict__ coords, TO* __restrict__ out, int Q,
                                   int grid_w, int tiles_x, int tiles_per_b, float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int NT = 2 * R + 2;
  constexpr int NT2 = NT * NT;
  constexpr int CU = C / kUnit32;         // staged units per box row
  constexpr int CPL = C / 32;
  constexpr int NTW = kMaxWarpCols / 8;   // n-tiles a warp may take
  constexpr int KS = kUnit32 / 8;         // k-steps of a unit
  static_assert(KK <= kMaxKK, "window");
  static_assert(2 * NTW <= 32, "a lane's hit mask");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* tab = reinterpret_cast<float*>(smem + kStages * kStage32Bytes);
  __shared__ int wrange[kTileWarps][5];
  __shared__ float frac[kTileWarps][16][2];  // (fx, fy) of each query at this level

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int l = blockIdx.y;
  const int64_t b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x % tiles_per_b;
  const int row0 = (tile / tiles_x) * kTileWarps;             // the tile's first grid row
  const int colw = (tile % tiles_x) * kTileCols + 4 * warp;  // the warp's first column
  tab += warp * 16 * NT2;
  auto query = [&](int mr) {
    const int col = colw + (mr & 3);
    const int q = (row0 + (mr >> 2)) * grid_w + col;
    return col < grid_w && q < Q ? q : -1;
  };
  const int64_t bq0 = b * Q;
  const int row_stride = lv.n * KK;
  const int H = lv.H[l], W = lv.W[l];
  int route = 0;
  if (H > 0 && W > 0) {  // uniform over the block
    const float* f2 = static_cast<const float*>(lv.ptr[l]) + b * ((int64_t)H * W * C);
    // query lane / 2 (the box, the blend's fractions) and the lane's mma rows g8, g8 + 8
    const int qm = query(lane >> 1), qa = query(g8), qb = query(g8 + 8);
    float cxm = 0.0f, cym = 0.0f;
    if (qm >= 0) { cxm = coords[2 * (bq0 + qm)]; cym = coords[2 * (bq0 + qm) + 1]; }
    const Taps tpm = query_taps<R>(cxm, cym, l, H, W);
    const int xlo = max(tpm.x, 0), xhi = min(tpm.x + NT - 1, W - 1);
    const int ylo = max(tpm.y, 0), yhi = min(tpm.y + NT - 1, H - 1);
    const bool has = qm >= 0 && xlo <= xhi && ylo <= yhi;
    if (!(lane & 1)) {
      frac[warp][lane >> 1][0] = tpm.fx;
      frac[warp][lane >> 1][1] = tpm.fy;
    }
    for (int k = lane; k < 16 * NT2; k += 32) tab[k] = 0.0f;
    const TileBox box = tile_box(has, xlo, xhi, ylo, yhi, wrange, warp, lane);
    route = box.tiled ? 1 : 2;
    __syncwarp();
    if (box.tiled) {
      // the first taps of the lane's rows' queries (those of lane 2 g8 and 2 g8 + 16)
      const int txa = __shfl_sync(kFull, tpm.x, 2 * g8), tya = __shfl_sync(kFull, tpm.y, 2 * g8);
      const int txb = __shfl_sync(kFull, tpm.x, 2 * g8 + 16);
      const int tyb = __shfl_sync(kFull, tpm.y, 2 * g8 + 16);
      // which of the lane's products (n-tile nt, column 2 t4 + e: bit 2 nt + e) land on a
      // tap of their query's window: the tap's column offsets ia0 + 8 nt + e
      const int ia0 = box.wx0 + 2 * t4 - txa, ib0 = box.wx0 + 2 * t4 - txb;
      unsigned hit_a = 0, hit_b = 0;
#pragma unroll
      for (int k = 0; k < 2 * NTW; ++k) {
        const int off = 8 * (k >> 1) + (k & 1);
        const bool in_w = box.wx0 + 2 * t4 + off < W;
        hit_a |= (qa >= 0 && in_w && ia0 + off >= 0 && ia0 + off < NT) ? 1u << k : 0u;
        hit_b |= (qb >= 0 && in_w && ib0 + off >= 0 && ib0 + off < NT) ? 1u << k : 0u;
      }
      const int ntw = box.warp_has ? (box.wx1 - box.wx0 + 8) / 8 : 0;  // the warp's n-tiles
      const int nunits = box.bh * CU;  // (unit, row) pairs, unit by unit
      const uint32_t stage_s = smem_addr(stage);
      auto issue = [&](int u) {
        const int cu = u / box.bh, y = box.by0 + u % box.bh;
        stage_unit<kPitch32, kTileWarps * 32>(
            stage_s + (u % kStages) * kStage32Bytes,
            f2 + ((int64_t)y * W + box.bx0) * C + cu * kUnit32, box.bw, C * 4, tid);
      };
#pragma unroll
      for (int u = 0; u < kStages - 1; ++u) {
        if (u < nunits) issue(u);
        cp_async_commit();
      }
      float4 af[KS / 2][2];  // the unit's f1 of queries qa, qb (split when used: fewer registers)
      for (int u = 0; u < nunits; ++u) {
        const int cu = u / box.bh, y = box.by0 + u % box.bh;
        if (y == box.by0) {  // a unit starts: its A fragments (0 past the tile's queries)
          const float* fa = f1 + (bq0 + qa) * C + cu * kUnit32 + 4 * t4;
          const float* fb = f1 + (bq0 + qb) * C + cu * kUnit32 + 4 * t4;
#pragma unroll
          for (int v = 0; v < KS / 2; ++v) {
            const float4 xa = qa >= 0 ? *reinterpret_cast<const float4*>(fa + 16 * v)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float4 xb = qb >= 0 ? *reinterpret_cast<const float4*>(fb + 16 * v)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            af[v][0] = xa;
            af[v][1] = xb;
          }
        }
        cp_async_wait<kStages - 2>();  // unit u has landed
        __syncthreads();               // ... for every thread; unit u - 1 is done
        if (u + kStages - 1 < nunits) issue(u + kStages - 1);  // into unit u - 1's stage
        cp_async_commit();
        if (box.warp_has && y >= box.wy0 && y <= box.wy1) {  // uniform over the warp
          // hi*hi products in acc, the two cross terms in accx (two shorter mma chains)
          float acc[NTW][4], accx[NTW][4];
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] = accx[nt][i] = 0.0f;
          }
          const unsigned char* st = stage + (u % kStages) * kStage32Bytes +
                                    (box.wx0 - box.bx0 + g8) * kPitch32 + t4 * 16;
#pragma unroll
          for (int v = 0; v < KS / 2; ++v) {
            // A of k-steps 2v (ahi[0], alo[0]) and 2v + 1
            uint32_t ahi[2][4], alo[2][4];
            const float4 xa = af[v][0], xb = af[v][1];
            split_tf32(xa.x, ahi[0][0], alo[0][0]);
            split_tf32(xb.x, ahi[0][1], alo[0][1]);
            split_tf32(xa.y, ahi[0][2], alo[0][2]);
            split_tf32(xb.y, ahi[0][3], alo[0][3]);
            split_tf32(xa.z, ahi[1][0], alo[1][0]);
            split_tf32(xb.z, ahi[1][1], alo[1][1]);
            split_tf32(xa.w, ahi[1][2], alo[1][2]);
            split_tf32(xb.w, ahi[1][3], alo[1][3]);
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              if (nt < ntw) {
                const float4 bv = *reinterpret_cast<const float4*>(st + nt * 8 * kPitch32 + v * 64);
                uint32_t bh[4], bl[4];
                split_tf32(bv.x, bh[0], bl[0]);
                split_tf32(bv.y, bh[1], bl[1]);
                split_tf32(bv.z, bh[2], bl[2]);
                split_tf32(bv.w, bh[3], bl[3]);
                mma_tf32(accx[nt], alo[0], bh[0], bh[1]);
                mma_tf32(accx[nt], ahi[0], bl[0], bl[1]);
                mma_tf32(acc[nt], ahi[0], bh[0], bh[1]);
                mma_tf32(accx[nt], alo[1], bh[2], bh[3]);
                mma_tf32(accx[nt], ahi[1], bl[2], bl[3]);
                mma_tf32(acc[nt], ahi[1], bh[2], bh[3]);
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] += accx[nt][i];
          }
          // the products that land on a tap of their query's window
          const int ja = y - tya, jb = y - tyb;
          float* ra = tab + g8 * NT2 + ja * NT + ia0;
          float* rb = tab + (g8 + 8) * NT2 + jb * NT + ib0;
          const unsigned ma = ja >= 0 && ja < NT ? hit_a : 0u;
          const unsigned mb = jb >= 0 && jb < NT ? hit_b : 0u;
#pragma unroll
          for (int k = 0; k < 2 * NTW; ++k) {
            const int off = 8 * (k >> 1) + (k & 1);
            if (ma & (1u << k)) ra[off] += acc[k >> 1][k & 1];
            if (mb & (1u << k)) rb[off] += acc[k >> 1][2 + (k & 1)];
          }
        }
      }
    } else {
      // per-query route: the warp's 16 queries one by one, straight to device memory
      for (int mr = 0; mr < 16; ++mr) {
        const float cx = __shfl_sync(kFull, cxm, 2 * mr);
        const float cy = __shfl_sync(kFull, cym, 2 * mr);
        const int q = query(mr);
        if (q < 0) continue;  // uniform over the warp
        float a1[CPL];
        load_vec<CPL>(f1 + (bq0 + q) * C + lane * CPL, a1);
        query_window<float, TO, R, CPL>(a1, f2, H, W, query_taps<R>(cx, cy, l, H, W),
                                        out + (bq0 + q) * row_stride + l * KK, inv_sqrt_c, lane);
      }
    }
  }
  if (tid == 0 && blockIdx.x < kMaxRecordedTiles)
    g_fwd_route[blockIdx.x * kMaxLevels + l] = (unsigned char)route;
  __syncwarp();
  if (route == 2) return;
  // the windows from the tap table (zeros for an empty level), consecutive stores
  for (int e = lane; e < 16 * KK; e += 32) {
    const int mr = e / KK, k = e - mr * KK;
    const int q = query(mr);
    if (q < 0) continue;
    float v = 0.0f;
    if (route == 1) {
      const int a = k / K, c = k - a * K;
      const float* d = tab + mr * NT2 + c * NT + a;
      const float fx = frac[warp][mr][0], fy = frac[warp][mr][1];
      const float top = (1.0f - fx) * d[0] + fx * d[1];
      const float bot = (1.0f - fx) * d[NT] + fx * d[NT + 1];
      v = ((1.0f - fy) * top + fy * bot) * inv_sqrt_c;
    }
    store_f(out + (bq0 + q) * row_stride + l * KK + k, v);
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

// One query at one level of K5 on the CUDA cores: lane owns CPL channels of
// df1 (f2 already offset to them; C the pixel stride) and adds drows * f2
// over the in-bounds taps, rows then columns in order. gl: the query's
// cotangent at this level.
template <typename T, typename TG, int R, int CPL>
__device__ __forceinline__ void df1_query_level(float* acc, const T* __restrict__ f2, int H,
                                                int W, int C, const Taps& t,
                                                const TG* __restrict__ gl, float inv_sqrt_c,
                                                int lane) {
  constexpr int NT = 2 * R + 2;
  for (int j = 0; j < NT; ++j) {
    const int y = t.y + j;
    if (y < 0 || y >= H) continue;  // uniform over the warp
    const float gy = row_cotangent<TG, R>(gl, j, t.fy, inv_sqrt_c, lane);
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

// One query's tap cotangents at one level, tq[j * NT + i] = drows[j][i],
// with the per-query route's arithmetic (row cotangents gy, then the tap's
// two columns): lane half h of the query's two fills columns [h NT / 2,
// (h + 1) NT / 2), each from two columns of gy, each column from K loads of
// the query's cotangent gl issued together. K5's tiles build their A from it.
template <typename TG, int R>
__device__ __forceinline__ void tap_cotangents(float* tq, const TG* __restrict__ gl,
                                               const Taps& tp, float inv_sqrt_c, int half) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  constexpr int HALF = NT / 2;
  const int i0 = half * HALF;
  auto gy_col = [&](int a, float (&col)[NT]) {  // gy at column a, 0 outside [0, K)
    float gv[K];
#pragma unroll
    for (int c = 0; c < K; ++c) gv[c] = a >= 0 && a < K ? to_f(gl[a * K + c]) * inv_sqrt_c : 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float g0 = j < K ? gv[j] : 0.0f;
      const float g1 = j >= 1 ? gv[j - 1] : 0.0f;
      col[j] = (1.0f - tp.fy) * g0 + tp.fy * g1;
    }
  };
  float gprev[NT], gcur[NT];
  gy_col(i0 - 1, gprev);
#pragma unroll
  for (int ii = 0; ii < HALF; ++ii) {
    gy_col(i0 + ii, gcur);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tq[j * NT + i0 + ii] = (1.0f - tp.fx) * gcur[j] + tp.fx * gprev[j];
      gprev[j] = gcur[j];
    }
  }
}

// ---------------------------------------------------------------------------
// K5, bf16 fmap2: the tiled kernel, K4's tiles run backwards. A block owns
// K4's tile of 4 grid rows x 16 queries and one 128-channel unit of df1
// (blockIdx.y): the channels are independent, so splitting them changes no
// sum, and at the training shape it doubles the blocks (384 for 132 SMs).
// Warp w takes the tile's 4 x 4 patch of columns 4w..4w+3, whose windows
// span fewer columns than a row of 16 queries (for a smooth field 14 rather
// than 26 at level 0: one k-step of 16 pixels instead of two). Per level,
// the block stages the fmap2 box of its windows row by row (stage_unit, as
// K4; one row ahead, one barrier a row) and each warp, for each staged row
// in its own rows, multiplies its queries' drows with the row's pixels on
// the tensor cores: mma.sync m16n8k16, M = the warp's 16 queries, K = 16
// pixels of the row (k-steps from the warp's first column), N = 8 channels
// (16 n-tiles, 64 fp32 accumulators a lane for the whole launch). A (drows)
// is built in registers from a per-warp table of each query's (2r+2)^2 tap
// cotangents at this level (zero outside its window and past the box); B
// comes from the staged row by ldmatrix.trans (pixel pitch 272 bytes: the 8
// pixel rows of a matrix in distinct banks). drows is fp32 and its products
// with bf16 fmap2 are exact in fp32; so drows goes in as the exact sum of
// three bf16 pieces (hi, mid, lo: 8 + 8 + 8 significand bits), three mma
// into one accumulator: the products stay exact and only the order of the
// fp32 sums changes. A tile whose box does not fit (kMaxBoxW, kMaxBoxRows,
// kMaxWarpCols) takes the per-query route at that level, as K4: the warp's
// queries one by one on the CUDA cores (df1_query_level) into a
// shared buffer, then added to the accumulators. Each df1 element is
// written once, at the end.
constexpr int kDf1Pitch = kUnitC * 2 + 16;   // bytes a staged pixel
constexpr int kDf1StagePx = kMaxBoxW + 16;   // a warp's last k-step may read 15 past the box
constexpr int kDf1StageBytes = kDf1StagePx * kDf1Pitch;
constexpr int kDf1Stages = 2;
constexpr int kDf1FbStride = kUnitC + 4;     // floats a query in the per-query route's buffer
static_assert(kTileWarps * 16 * kDf1FbStride * 4 <= kDf1Stages * kDf1StageBytes,
              "the per-query route's buffer lives in the stages");
template <int R>
constexpr size_t df1_smem() {
  return kDf1Stages * (size_t)kDf1StageBytes + (size_t)kTileWarps * 16 * (2 * R + 2) * (2 * R + 2) * 4;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// v as three bf16 pieces whose sum is v exactly (24 significand bits).
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename TG, int R>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
    ondemand_bwd_df1_tiled_kernel(Levels lv, const float* __restrict__ coords,
                                  const TG* __restrict__ g, float* __restrict__ df1, int Q,
                                  int C, int grid_w, int tiles_x, int tiles_per_b,
                                  float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int NT = 2 * R + 2;
  constexpr int NT2 = NT * NT;
  constexpr int NTILES = kUnitC / 8;  // n-tiles of the block's channels
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* tab = reinterpret_cast<float*>(smem + kDf1Stages * kDf1StageBytes);
  __shared__ int wrange[kTileWarps][5];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int64_t b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x % tiles_per_b;
  const int ch0 = blockIdx.y * kUnitC;
  const int row0 = (tile / tiles_x) * kTileWarps;                 // the tile's first grid row
  const int colw = (tile % tiles_x) * kTileCols + 4 * warp;      // the warp's first column
  tab += warp * 16 * NT2;
  // query of the warp's mma row mr: grid row row0 + mr / 4, column colw + mr % 4
  auto query = [&](int mr) {
    const int col = colw + (mr & 3);
    const int q = (row0 + (mr >> 2)) * grid_w + col;
    return col < grid_w && q < Q ? q : -1;
  };
  const int64_t bq0 = (int64_t)b * Q;

  // zero the stages once: a k-step past a box multiplies what lies there by 0
  for (int i = tid; i < kDf1Stages * kDf1StageBytes / 16; i += kTileWarps * 32)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0, 0, 0, 0);

  // coords of query lane / 2 (the box) and of the lane's mma rows g8, g8 + 8
  const int qm = query(lane >> 1), qa = query(g8), qb = query(g8 + 8);
  float cxm = 0.0f, cym = 0.0f, cxa = 0.0f, cya = 0.0f, cxb = 0.0f, cyb = 0.0f;
  if (qm >= 0) { cxm = coords[2 * (bq0 + qm)]; cym = coords[2 * (bq0 + qm) + 1]; }
  if (qa >= 0) { cxa = coords[2 * (bq0 + qa)]; cya = coords[2 * (bq0 + qa) + 1]; }
  if (qb >= 0) { cxb = coords[2 * (bq0 + qb)]; cyb = coords[2 * (bq0 + qb) + 1]; }

  float acc[NTILES][4];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    if (H <= 0 || W <= 0) continue;  // uniform over the block
    const __nv_bfloat16* f2 =
        static_cast<const __nv_bfloat16*>(lv.ptr[l]) + b * ((int64_t)H * W * C) + ch0;
    const Taps tpm = query_taps<R>(cxm, cym, l, H, W);
    const int xlo = max(tpm.x, 0), xhi = min(tpm.x + NT - 1, W - 1);
    const int ylo = max(tpm.y, 0), yhi = min(tpm.y + NT - 1, H - 1);
    const bool has = qm >= 0 && xlo <= xhi && ylo <= yhi;
    const TileBox box = tile_box(has, xlo, xhi, ylo, yhi, wrange, warp, lane);
    if (box.tiled) {
      const uint32_t stage_s = smem_addr(stage);
      // ldmatrix rows: lane gives pixel (lane & 7) + 8 (lane >> 3 & 1), channels 8 (lane >> 4) on
      const uint32_t lm_off =
          ((lane & 7) + ((lane >> 3) & 1) * 8) * kDf1Pitch + (lane >> 4) * 16;
      auto issue = [&](int u) {
        stage_unit<kDf1Pitch, kTileWarps * 32>(stage_s + (u % kDf1Stages) * kDf1StageBytes,
                                               f2 + ((int64_t)(box.by0 + u) * W + box.bx0) * C,
                                               box.bw, C * 2, tid);
      };
      // the first rows load while the table below is built
#pragma unroll
      for (int u = 0; u < kDf1Stages - 1; ++u) {
        if (u < box.bh) issue(u);
        cp_async_commit();
      }
      // the warp's tap cotangents tab[mr][j][i]
      if (qm >= 0)
        tap_cotangents<TG, R>(tab + (lane >> 1) * NT2, g + (bq0 + qm) * (lv.n * KK) + l * KK,
                              tpm, inv_sqrt_c, lane & 1);
      __syncwarp();
      const Taps ta = query_taps<R>(cxa, cya, l, H, W);
      const Taps tb = query_taps<R>(cxb, cyb, l, H, W);
      const float* taba = tab + g8 * NT2;
      const float* tabb = tab + (g8 + 8) * NT2;
      const int nks = box.warp_has ? (box.wx1 - box.wx0 + 16) / 16 : 0;  // k-steps of 16 pixels
      const int bx_last = box.bx0 + box.bw - 1;  // past it a k-step reads stale pixels: A = 0
      for (int u = 0; u < box.bh; ++u) {
        cp_async_wait<kDf1Stages - 2>();  // row u has landed
        __syncthreads();                  // ... for every thread; row u - 1 is done
        if (u + kDf1Stages - 1 < box.bh) issue(u + kDf1Stages - 1);  // into row u - 1's stage
        cp_async_commit();
        const int y = box.by0 + u;
        if (box.warp_has && y >= box.wy0 && y <= box.wy1) {  // uniform over the warp
          const int ja = y - ta.y, jb = y - tb.y;
          const bool ra = qa >= 0 && ja >= 0 && ja < NT, rb = qb >= 0 && jb >= 0 && jb < NT;
          const uint32_t st = stage_s + (u % kDf1Stages) * kDf1StageBytes + lm_off;
          for (int ks = 0; ks < nks; ++ks) {
            const int xs = box.wx0 + 16 * ks;
            // A: rows g8 (query qa) and g8 + 8 (qb), pixels xs + 2 t4 + {0, 1, 8, 9}
            uint32_t A[3][4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              __nv_bfloat16 pa[2][3], pb[2][3];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = xs + 2 * t4 + 8 * hh + e;
                const int ia = x - ta.x, ib = x - tb.x;
                const bool in = x <= bx_last;
                split3(in && ra && ia >= 0 && ia < NT ? taba[ja * NT + ia] : 0.0f, pa[e]);
                split3(in && rb && ib >= 0 && ib < NT ? tabb[jb * NT + ib] : 0.0f, pb[e]);
              }
#pragma unroll
              for (int p = 0; p < 3; ++p) {
                A[p][2 * hh] = pack2(pa[0][p], pa[1][p]);
                A[p][2 * hh + 1] = pack2(pb[0][p], pb[1][p]);
              }
            }
            // B: the k-step's 16 pixels x 128 channels, then the pieces' products
            // (each piece's 16 independent mma before the next piece's)
            const uint32_t bk = st + (uint32_t)((xs - box.bx0) * kDf1Pitch);
            uint32_t bf[NTILES / 2][4];
#pragma unroll
            for (int np = 0; np < NTILES / 2; ++np) ldsm_x4_trans(bf[np], bk + np * 32);
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int np = 0; np < NTILES / 2; ++np) {
                mma_bf16(acc[2 * np], A[p][0], A[p][1], A[p][2], A[p][3], bf[np][0], bf[np][1]);
                mma_bf16(acc[2 * np + 1], A[p][0], A[p][1], A[p][2], A[p][3], bf[np][2],
                         bf[np][3]);
              }
          }
        }
      }
    } else {
      // per-query route: the warp's queries one by one, lane channels 4 lane..
      // of the block's unit, into a buffer in the stages, then into the
      // accumulators
      float* fb = reinterpret_cast<float*>(stage) + warp * 16 * kDf1FbStride;
      for (int mr = 0; mr < 16; ++mr) {
        const float cx = __shfl_sync(kFull, cxm, 2 * mr);
        const float cy = __shfl_sync(kFull, cym, 2 * mr);
        const int q = query(mr);
        if (q < 0) continue;  // uniform over the warp
        float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        df1_query_level<__nv_bfloat16, TG, R, 4>(
            a4, f2 + lane * 4, H, W, C, query_taps<R>(cx, cy, l, H, W),
            g + (bq0 + q) * (lv.n * KK) + l * KK, inv_sqrt_c, lane);
        store_vec<4>(fb + mr * kDf1FbStride + lane * 4, a4);
      }
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const int n = nt * 8 + 2 * t4;
        if (qa >= 0) {
          acc[nt][0] += fb[g8 * kDf1FbStride + n];
          acc[nt][1] += fb[g8 * kDf1FbStride + n + 1];
        }
        if (qb >= 0) {
          acc[nt][2] += fb[(g8 + 8) * kDf1FbStride + n];
          acc[nt][3] += fb[(g8 + 8) * kDf1FbStride + n + 1];
        }
      }
      __syncthreads();
      // zero the stages again: the buffer's floats, read as bf16, need not be
      // finite, and a k-step may read past a box into them
      for (int i = tid; i < kDf1Stages * kDf1StageBytes / 16; i += kTileWarps * 32)
        reinterpret_cast<uint4*>(stage)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // wrange and the stages are rewritten for the next level
  }
  float* oa = df1 + (bq0 + qa) * C + ch0 + 2 * t4;
  float* ob = df1 + (bq0 + qb) * C + ch0 + 2 * t4;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    if (qa >= 0) *reinterpret_cast<float2*>(oa + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    if (qb >= 0) *reinterpret_cast<float2*>(ob + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// K5, fp32 fmap2: the bf16 tiles in fp32. The block, its warps' 4 x 4
// patches, the boxes, the staging one row ahead, the tap table and the
// per-query route are the bf16 kernel's; the unit is 64 channels
// (blockIdx.y; 256 bytes a pixel as the bf16 unit) and the products are
// TF32 mma.sync m16n8k8 in three passes (mma3_tf32): M = the warp's 16
// queries, K = 8 pixels of the row (k-steps from the warp's first column),
// N = 8 channels (8 n-tiles, 32 fp32 accumulators a lane for the whole
// launch). A (drows, from the table, 0 outside the query's window and past
// the box) is split into hi and lo parts in registers; B comes from the
// staged row with 16-byte loads: n-tile 4h + i, column n holds channel 32h
// + 4n + i, so lane (g, t) reads channels 32h + 4g .. + 3 of pixels t and t
// + 4 (bank-free at kDf1Pitch32) and writes channels 32h + 8t .. + 7 of its
// queries at the end. Each df1 element is written once.
constexpr int kDf1Pitch32 = kUnit32 * 4 + 32;      // bytes a staged pixel
constexpr int kDf1Stage32Bytes = (kMaxBoxW + 8) * kDf1Pitch32;  // a k-step may read 7 past the box
constexpr int kDf1FbStride32 = kUnit32 + 4;        // floats a query in the per-query route's buffer
static_assert(kTileWarps * 16 * kDf1FbStride32 * 4 <= kDf1Stages * kDf1Stage32Bytes,
              "the per-query route's buffer lives in the stages");
template <int R>
constexpr size_t df1_smem32() {
  return kDf1Stages * (size_t)kDf1Stage32Bytes + (size_t)kTileWarps * 16 * (2 * R + 2) * (2 * R + 2) * 4;
}

template <typename TG, int R>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
    ondemand_bwd_df1_tiled_fp32_kernel(Levels lv, const float* __restrict__ coords,
                                       const TG* __restrict__ g, float* __restrict__ df1, int Q,
                                       int C, int grid_w, int tiles_x, int tiles_per_b,
                                       float inv_sqrt_c) {
  constexpr int K = 2 * R + 1;
  constexpr int KK = K * K;
  constexpr int NT = 2 * R + 2;
  constexpr int NT2 = NT * NT;
  constexpr int NTILES = kUnit32 / 8;  // n-tiles of the block's channels
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  float* tab = reinterpret_cast<float*>(smem + kDf1Stages * kDf1Stage32Bytes);
  __shared__ int wrange[kTileWarps][5];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int64_t b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x % tiles_per_b;
  const int ch0 = blockIdx.y * kUnit32;
  const int row0 = (tile / tiles_x) * kTileWarps;             // the tile's first grid row
  const int colw = (tile % tiles_x) * kTileCols + 4 * warp;  // the warp's first column
  tab += warp * 16 * NT2;
  auto query = [&](int mr) {
    const int col = colw + (mr & 3);
    const int q = (row0 + (mr >> 2)) * grid_w + col;
    return col < grid_w && q < Q ? q : -1;
  };
  const int64_t bq0 = b * Q;

  // zero the stages once: a k-step past a box multiplies what lies there by 0
  for (int i = tid; i < kDf1Stages * kDf1Stage32Bytes / 16; i += kTileWarps * 32)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0, 0, 0, 0);

  const int qm = query(lane >> 1), qa = query(g8), qb = query(g8 + 8);
  float cxm = 0.0f, cym = 0.0f, cxa = 0.0f, cya = 0.0f, cxb = 0.0f, cyb = 0.0f;
  if (qm >= 0) { cxm = coords[2 * (bq0 + qm)]; cym = coords[2 * (bq0 + qm) + 1]; }
  if (qa >= 0) { cxa = coords[2 * (bq0 + qa)]; cya = coords[2 * (bq0 + qa) + 1]; }
  if (qb >= 0) { cxb = coords[2 * (bq0 + qb)]; cyb = coords[2 * (bq0 + qb) + 1]; }

  float acc[NTILES][4];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l];
    if (H <= 0 || W <= 0) continue;  // uniform over the block
    const float* f2 = static_cast<const float*>(lv.ptr[l]) + b * ((int64_t)H * W * C) + ch0;
    const Taps tpm = query_taps<R>(cxm, cym, l, H, W);
    const int xlo = max(tpm.x, 0), xhi = min(tpm.x + NT - 1, W - 1);
    const int ylo = max(tpm.y, 0), yhi = min(tpm.y + NT - 1, H - 1);
    const bool has = qm >= 0 && xlo <= xhi && ylo <= yhi;
    const TileBox box = tile_box(has, xlo, xhi, ylo, yhi, wrange, warp, lane);
    if (box.tiled) {
      const uint32_t stage_s = smem_addr(stage);
      auto issue = [&](int u) {
        stage_unit<kDf1Pitch32, kTileWarps * 32>(
            stage_s + (u % kDf1Stages) * kDf1Stage32Bytes,
            f2 + ((int64_t)(box.by0 + u) * W + box.bx0) * C, box.bw, C * 4, tid);
      };
      // the first rows load while the table below is built
#pragma unroll
      for (int u = 0; u < kDf1Stages - 1; ++u) {
        if (u < box.bh) issue(u);
        cp_async_commit();
      }
      if (qm >= 0)
        tap_cotangents<TG, R>(tab + (lane >> 1) * NT2, g + (bq0 + qm) * (lv.n * KK) + l * KK,
                              tpm, inv_sqrt_c, lane & 1);
      __syncwarp();
      const Taps ta = query_taps<R>(cxa, cya, l, H, W);
      const Taps tb = query_taps<R>(cxb, cyb, l, H, W);
      const float* taba = tab + g8 * NT2;
      const float* tabb = tab + (g8 + 8) * NT2;
      const int nks = box.warp_has ? (box.wx1 - box.wx0 + 8) / 8 : 0;  // k-steps of 8 pixels
      const int bx_last = box.bx0 + box.bw - 1;  // past it a k-step reads stale pixels: A = 0
      for (int u = 0; u < box.bh; ++u) {
        cp_async_wait<kDf1Stages - 2>();  // row u has landed
        __syncthreads();                  // ... for every thread; row u - 1 is done
        if (u + kDf1Stages - 1 < box.bh) issue(u + kDf1Stages - 1);  // into row u - 1's stage
        cp_async_commit();
        const int y = box.by0 + u;
        if (box.warp_has && y >= box.wy0 && y <= box.wy1) {  // uniform over the warp
          const int ja = y - ta.y, jb = y - tb.y;
          const bool ra = qa >= 0 && ja >= 0 && ja < NT, rb = qb >= 0 && jb >= 0 && jb < NT;
          const unsigned char* st = stage + (u % kDf1Stages) * kDf1Stage32Bytes +
                                    t4 * kDf1Pitch32 + g8 * 16;
          for (int ks = 0; ks < nks; ++ks) {
            const int xs = box.wx0 + 8 * ks;
            // A: rows g8 (query qa) and g8 + 8 (qb), pixels xs + t4 (k = t4) and xs + t4 + 4
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = xs + t4 + 4 * e;
              const int ia = x - ta.x, ib = x - tb.x;
              const bool in = x <= bx_last;
              split_tf32(in && ra && ia >= 0 && ia < NT ? taba[ja * NT + ia] : 0.0f, ah[2 * e],
                         al[2 * e]);
              split_tf32(in && rb && ib >= 0 && ib < NT ? tabb[jb * NT + ib] : 0.0f,
                         ah[2 * e + 1], al[2 * e + 1]);
            }
            // B: pixels xs + t4 (b0) and xs + t4 + 4 (b1), channels 32h + 4 g8 + i
            const unsigned char* px = st + (xs - box.bx0) * kDf1Pitch32;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 c0 = *reinterpret_cast<const float4*>(px + h * 128);
              const float4 c1 = *reinterpret_cast<const float4*>(px + 4 * kDf1Pitch32 + h * 128);
              const float v0[4] = {c0.x, c0.y, c0.z, c0.w}, v1[4] = {c1.x, c1.y, c1.z, c1.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(v0[i], bh0, bl0);
                split_tf32(v1[i], bh1, bl1);
                mma3_tf32(acc[4 * h + i], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
    } else {
      // per-query route: the warp's queries one by one, lane channels 2 lane..
      // of the block's unit, into a buffer in the stages, then into the
      // accumulators
      float* fb = reinterpret_cast<float*>(stage) + warp * 16 * kDf1FbStride32;
      for (int mr = 0; mr < 16; ++mr) {
        const float cx = __shfl_sync(kFull, cxm, 2 * mr);
        const float cy = __shfl_sync(kFull, cym, 2 * mr);
        const int q = query(mr);
        if (q < 0) continue;  // uniform over the warp
        float a2[2] = {0.0f, 0.0f};
        df1_query_level<float, TG, R, 2>(a2, f2 + lane * 2, H, W, C, query_taps<R>(cx, cy, l, H, W),
                                         g + (bq0 + q) * (lv.n * KK) + l * KK, inv_sqrt_c, lane);
        store_vec<2>(fb + mr * kDf1FbStride32 + lane * 2, a2);
      }
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const int n = 32 * (nt >> 2) + 8 * t4 + (nt & 3);  // channels of columns 2 t4, 2 t4 + 1
        if (qa >= 0) {
          acc[nt][0] += fb[g8 * kDf1FbStride32 + n];
          acc[nt][1] += fb[g8 * kDf1FbStride32 + n + 4];
        }
        if (qb >= 0) {
          acc[nt][2] += fb[(g8 + 8) * kDf1FbStride32 + n];
          acc[nt][3] += fb[(g8 + 8) * kDf1FbStride32 + n + 4];
        }
      }
      __syncthreads();
      // zero the stages again: a k-step may read past a box into the buffer
      for (int i = tid; i < kDf1Stages * kDf1Stage32Bytes / 16; i += kTileWarps * 32)
        reinterpret_cast<uint4*>(stage)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // wrange and the stages are rewritten for the next level
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = ch0 + 32 * h + 8 * t4;
    if (qa >= 0) {
      float* o = df1 + (bq0 + qa) * C + n;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[4 * h][0], acc[4 * h + 1][0], acc[4 * h + 2][0], acc[4 * h + 3][0]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[4 * h][1], acc[4 * h + 1][1], acc[4 * h + 2][1], acc[4 * h + 3][1]);
    }
    if (qb >= 0) {
      float* o = df1 + (bq0 + qb) * C + n;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[4 * h][2], acc[4 * h + 1][2], acc[4 * h + 2][2], acc[4 * h + 3][2]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[4 * h][3], acc[4 * h + 1][3], acc[4 * h + 2][3], acc[4 * h + 3][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6's prepass: for each level and fmap2 row y, the queries whose taps
// cover row y (t.y <= y <= t.y + 2r + 1), in ascending query order: a list
// of (query, row) pairs sorted stably by row. One block per (level, batch
// element); warp w takes the w-th of nw contiguous segments of the queries.
// Each warp counts its segment's pairs per row (lanes of equal row find
// each other with __match_any_sync and only the lowest moves the count), a
// scan over (row, warp) gives each warp its cursor in each row, and each
// warp writes its segment's pairs a query at a time in lane order: the
// query's in-bounds rows are distinct, so lanes j = 0..2r+1 write one pair
// each. No atomics. Each pair carries what K6 needs: {q, (t.y << 16) +
// (t.x & 0xffff), fx bits, fy bits}. starts[y] is the first pair of row y,
// starts[Hl] (and on, up to nb_stride) the number of pairs; a level with an
// empty side has starts 0.
template <int R>
__global__ void __launch_bounds__(kPlanWarps * 32, 1)
    ondemand_df2_plan_kernel(Levels lv, const float* __restrict__ coords, int Q,
                             int64_t pair_stride, int nb_stride, int4* __restrict__ entries,
                             int* __restrict__ starts) {
  constexpr int NT = 2 * R + 2;
  extern __shared__ int cnt[];  // [nw][Hl]: counts, then cursors
  const int l = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t b = blockIdx.y;
  const int H = lv.H[l], W = lv.W[l];
  int* st = starts + (b * lv.n + l) * (int64_t)nb_stride;
  if (H <= 0 || W <= 0) {  // no rows
    for (int k = threadIdx.x; k < nb_stride; k += blockDim.x) st[k] = 0;
    return;
  }
  const float2* cb = reinterpret_cast<const float2*>(coords) + b * (int64_t)Q;
  int4* ent = entries + (b * lv.n + l) * pair_stride;
  int* wc = cnt + warp * H;
  for (int k = threadIdx.x; k < nw * H; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int seg = (Q + nw - 1) / nw;
  const int qa = min(Q, warp * seg), qb = min(Q, qa + seg);
  for (int pass = 0; pass < 2; ++pass) {
    float2 next = qa + lane < qb ? cb[qa + lane] : make_float2(0.0f, 0.0f);
    for (int q0 = qa; q0 < qb; q0 += 32) {
      const int q = q0 + lane;
      const float2 c = next;
      if (q + 32 < qb) next = cb[q + 32];  // the next round's coords, in flight
      const Taps t = query_taps<R>(c.x, c.y, l, H, W);
      const bool cols = q < qb && t.x + NT - 1 >= 0 && t.x < W;  // any tap column in bounds
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int y = t.y + j;
          const bool in = cols && y >= 0 && y < H;
          const unsigned active = __ballot_sync(kFull, in);
          if (in) {
            const unsigned peers = __match_any_sync(active, y);
            if (lane == __ffs(peers) - 1) wc[y] += __popc(peers);
          }
          __syncwarp();
        }
      } else {
        const int4 pair = make_int4(q, t.y * 65536 + (t.x & 0xffff), __float_as_int(t.fx),
                                    __float_as_int(t.fy));
        for (int src = 0; src < 32; ++src) {  // queries in lane (query) order
          const int sq = __shfl_sync(kFull, q, src);
          const int sy = __shfl_sync(kFull, t.y, src);
          const bool scols = __shfl_sync(kFull, (int)cols, src);
          const int4 sp = make_int4(sq, __shfl_sync(kFull, pair.y, src),
                                    __shfl_sync(kFull, pair.z, src),
                                    __shfl_sync(kFull, pair.w, src));
          const int y = sy + lane;
          if (scols && lane < NT && y >= 0 && y < H) ent[wc[y]++] = sp;
          __syncwarp();
        }
      }
    }
    __syncthreads();
    if (pass == 0 && warp == 0) {
      // row starts (over rows, then warps within a row) and each warp's cursors
      int run = 0;
      for (int k0 = 0; k0 < nb_stride; k0 += 32) {
        const int k = k0 + lane;
        int v = 0;
        for (int w = 0; w < nw && k < H; ++w) v += cnt[w * H + k];
        int incl = v;
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1) {
          const int n = __shfl_up_sync(kFull, incl, sh);
          if (lane >= sh) incl += n;
        }
        const int first = run + incl - v;
        if (k < nb_stride) st[k] = first;  // the total from k = Hl on
        if (k < H) {
          int cur = first;
          for (int w = 0; w < nw; ++w) {
            const int n = cnt[w * H + k];
            cnt[w * H + k] = cur;
            cur += n;
          }
        }
        run += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K6, the scatter df2_l[p, :] = sum_q drows_q(p) f1[q, :], made a gather so
// that it needs no atomics and gives the same bits on every run. A block owns
// one fmap2 row y of one level and batch element, 4*cg columns of it, and
// cs*32*cpl channels of channel block cb (Df2Grid); it reads only the
// prepass's list of the (query, row y) pairs, so no block walks a level's
// queries. Rounds of up to 256 pairs (as many as 32 KB of f1 rows hold):
// each thread takes one pair and tests its tap columns against the block's;
// a ballot and a prefix sum list the hits in pair order; every thread then
// copies a share of the hits' f1 rows (the block's channels) into shared
// memory with cp.async, while each hit's own thread computes its tap
// cotangents for row y (drows, from the pair's fx, fy and 2K values of g),
// stored with 3 zeros on each side. Warp w owns columns 4*(w % cg) .. +3
// and channel group w / cg, lists the round's hits that touch its columns,
// and adds drows * f1 for each, in order, into registers (lane channels
// lane*cpl .. +cpl of its group); the zero padding makes the 4 columns'
// multiply-adds branch-free, and a zero term leaves an fp32 sum unchanged.
// So each df2 element is summed by one thread over its queries in
// ascending order, one fmaf per query: deterministic, and the order in
// which the RAFT-small train-step gate (kernel vs plain, 2e-5 a layer)
// reads about 1.2e-5 (orders by first tap row with sums split over warps
// read 1.5e-5 and 2.3e-5 on the H100).
// Bound: 28.75 MB of compulsory bytes at the training shape, 0.0086 ms; the
// multiply-adds (1.49 GFLOP with the taps' cotangents) on the CUDA cores
// (the tensor cores would round drows to bf16) take at least 0.022 ms at
// the card's fp32 rate. What holds it back: the coarse levels, whose rows
// are covered by nearly every query (2,852 at 5x7), so each warp adds
// about as many hits in one chain, a few shared-memory reads and 4*cpl
// multiply-adds each, with a round's latency (the pairs, then g and f1)
// every 256 hits. Splitting a row's hits over warps would shorten the chain
// but change the order of the sums, and so the train step's gradients.
template <typename T, int R, int CPL>
__device__ __forceinline__ void df2_block(const Levels& lv, const Df2Grid& gd, int l, int idx,
                                          int64_t b, const int4* __restrict__ entries,
                                          int64_t pair_stride, const int* __restrict__ starts,
                                          int nb_stride, const void* __restrict__ g_any,
                                          bool g_bf16, const T* __restrict__ f1, int Q, int C,
                                          float inv_sqrt_c, unsigned char* smem) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = 2 * R + 2;
  const int cg = gd.cg[l], cs_n = gd.cs[l], ncb = gd.ncb[l];
  const int CB = cs_n * 32 * CPL;  // the block's channels
  const int NR = min(kDf2Threads, kDf2F1Bytes / (CB * (int)sizeof(T)));  // pairs a round
  T* f1s = reinterpret_cast<T*>(smem);                                    // [NR][CB]
  // [NR][HDW]: a hit's tap cotangents at 3 + i, zeros on both sides, so
  // any 4 columns that touch its taps read in range
  float (*hd)[kHdW] = reinterpret_cast<float (*)[kHdW]>(smem + kDf2F1Bytes);
  int* hq = reinterpret_cast<int*>(smem + kDf2F1Bytes + kDf2Threads * kHdW * 4);
  int* htx = hq + kDf2Threads;
  int* warp_hits = htx + kDf2Threads;
  int* wl = warp_hits + kDf2Warps + (threadIdx.x >> 5) * kDf2Threads;  // the warp's hits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = lv.H[l], W = lv.W[l];
  const int per_row = gd.nseg[l] * ncb;
  const int y = idx / per_row, seg = (idx % per_row) / ncb, cb = idx % ncb;
  const int x0 = seg * 4 * cg, x_end = min(x0 + 4 * cg, W);
  const int xw0 = x0 + 4 * (warp % cg);
  const int cw = (warp / cg) * 32 * CPL + lane * CPL;  // the lane's channels in the block's
  // the warp sums columns xw0 .. xw0 + 3 over its channel group warp / cg
  const bool owner = warp < cg * cs_n && xw0 < x_end;
  const int4* ent = entries + (b * lv.n + l) * pair_stride;
  const int* st = starts + (b * lv.n + l) * (int64_t)nb_stride;
  const int e_begin = st[y], e_end = st[y + 1];
  const int row_g = lv.n * K * K;
  const T* f1b = f1 + (int64_t)b * Q * C + cb * CB;
  const uint32_t f1s_s = smem_addr(f1s);
  float acc[4][CPL];
#pragma unroll
  for (int xx = 0; xx < 4; ++xx)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[xx][c] = 0.0f;
  for (int e0 = e_begin; e0 < e_end; e0 += NR) {
    const int e = e0 + tid;
    bool hit = false;
    int4 en = make_int4(0, 0, 0, 0);
    int tx = 0;
    if (tid < NR && e < e_end) {
      en = ent[e];
      tx = (int)(short)(en.y & 0xffff);
      hit = tx + NT - 1 >= x0 && tx < x_end;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kDf2Warps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    const int slot = before + __popc(mask & ((1u << lane) - 1));
    if (hit) {
      hq[slot] = en.x;
      htx[slot] = tx;
    }
    __syncthreads();
    // the hits' f1 rows (the block's channels) into shared memory ...
    const int kChunks = CB * (int)sizeof(T) / 16;
    for (int k = tid; k < total * kChunks; k += kDf2Threads) {
      const int h = k / kChunks, v = k % kChunks;
      cp_async16(f1s_s + (uint32_t)(h * CB * (int)sizeof(T) + v * 16),
                 reinterpret_cast<const unsigned char*>(f1b + (int64_t)hq[h] * C) + v * 16);
    }
    cp_async_commit();
    // ... while each hit's thread computes its tap cotangents for row y
    if (hit) {
      const int j = y - (en.y >> 16);  // in [0, NT): the pair covers row y
      const float fx = __int_as_float(en.z), fy = __int_as_float(en.w);
      const int64_t go = ((int64_t)b * Q + en.x) * row_g + l * K * K;
      float gy[K];
#pragma unroll
      for (int a = 0; a < K; ++a) {
        float g0 = 0.0f, g1 = 0.0f;
        if (g_bf16) {
          const __nv_bfloat16* gl = static_cast<const __nv_bfloat16*>(g_any) + go;
          if (j < K) g0 = to_f(gl[a * K + j]) * inv_sqrt_c;
          if (j >= 1) g1 = to_f(gl[a * K + j - 1]) * inv_sqrt_c;
        } else {
          const float* gl = static_cast<const float*>(g_any) + go;
          if (j < K) g0 = gl[a * K + j] * inv_sqrt_c;
          if (j >= 1) g1 = gl[a * K + j - 1] * inv_sqrt_c;
        }
        gy[a] = (1.0f - fy) * g0 + fy * g1;
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float gi = i < K ? gy[i] : 0.0f;
        const float gm = i > 0 ? gy[i - 1] : 0.0f;
        hd[slot][3 + i] = (1.0f - fx) * gi + fx * gm;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) hd[slot][i] = hd[slot][3 + NT + i] = 0.0f;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (owner) {  // uniform over the warp
      int nw = 0;  // the round's hits that touch the warp's columns, in order
      for (int h0 = 0; h0 < total; h0 += 32) {
        const int h = h0 + lane;
        const bool touch = h < total && htx[h] + NT - 1 >= xw0 && htx[h] <= xw0 + 3;
        const unsigned tm = __ballot_sync(kFull, touch);
        if (touch) wl[nw + __popc(tm & ((1u << lane) - 1))] = h;
        nw += __popc(tm);
      }
      __syncwarp();
      // a tap outside a hit's window adds d = 0: fmaf(0, v, acc) is acc
      // exactly (v finite; acc starts at +0 and is never -0), so the sums
      // are those of the hit's taps alone
#pragma unroll 4
      for (int k = 0; k < nw; ++k) {
        const int h = wl[k];
        float v[CPL];
        load_vec<CPL>(f1s + h * CB + cw, v);
        const float* dh = hd[h] + 3 + xw0 - htx[h];  // column xw0's cotangent, in range
#pragma unroll
        for (int xx = 0; xx < 4; ++xx) {
          const float d = dh[xx];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[xx][c] = fmaf(d, v[c], acc[xx][c]);
        }
      }
    }
    __syncthreads();  // the round's buffers are rewritten by the next round
  }
  if (owner) {
    float* out = static_cast<float*>(const_cast<void*>(lv.ptr[l])) +
                 ((b * H + y) * (int64_t)W) * C + cb * CB + cw;
#pragma unroll
    for (int xx = 0; xx < 4; ++xx)
      if (xw0 + xx < x_end) store_vec<CPL>(out + (int64_t)(xw0 + xx) * C, acc[xx]);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kDf2Threads, 2)
    ondemand_bwd_df2_kernel(Levels lv, Df2Grid gd, const int4* __restrict__ entries,
                            int64_t pair_stride, const int* __restrict__ starts, int nb_stride,
                            const void* __restrict__ g, bool g_bf16, const T* __restrict__ f1,
                            int Q, int C, float inv_sqrt_c) {
  extern __shared__ __align__(16) unsigned char df2_shared[];
  int l = 0;
  while (l + 1 < lv.n && (int)blockIdx.x >= gd.block_start[l + 1]) ++l;
  const int idx = (int)blockIdx.x - gd.block_start[l];
  const int64_t b = blockIdx.y;
  switch (gd.cpl[l]) {
    case 8:
      df2_block<T, R, 8>(lv, gd, l, idx, b, entries, pair_stride, starts, nb_stride, g, g_bf16,
                         f1, Q, C, inv_sqrt_c, df2_shared);
      break;
    case 4:
      df2_block<T, R, 4>(lv, gd, l, idx, b, entries, pair_stride, starts, nb_stride, g, g_bf16,
                         f1, Q, C, inv_sqrt_c, df2_shared);
      break;
    case 2:
      df2_block<T, R, 2>(lv, gd, l, idx, b, entries, pair_stride, starts, nb_stride, g, g_bf16,
                         f1, Q, C, inv_sqrt_c, df2_shared);
      break;
    default:
      df2_block<T, R, 1>(lv, gd, l, idx, b, entries, pair_stride, starts, nb_stride, g, g_bf16,
                         f1, Q, C, inv_sqrt_c, df2_shared);
      break;
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

// K4's tiled kernel for operand type T (bf16 or fp32).
template <typename T, typename TO, int R, int C>
cudaError_t launch_fwd_tiled(const void* f1, const Levels& lv, const void* coords, void* out,
                             int B, int Q, int grid_w, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  auto kernel = [] {
    if constexpr (kBf16) return ondemand_fwd_tiled_kernel<TO, R, C>;
    else return ondemand_fwd_tiled_fp32_kernel<TO, R, C>;
  }();
  const size_t smem = kBf16 ? fwd_smem<TO>() : fwd32_smem<R>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg = tile_grid(lv, B, Q, grid_w);
  if (tg.tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  g_last_tiles = (int)tg.tiles;
  g_last_levels = lv.n;
  const dim3 grid((unsigned)tg.tiles, kBf16 ? 1u : (unsigned)lv.n);  // fp32: a block a level
  kernel<<<grid, kTileWarps * 32, smem, s>>>(
      static_cast<const T*>(f1), lv, static_cast<const float*>(coords), static_cast<TO*>(out),
      Q, tg.grid_w, tg.tiles_x, tg.tiles_per_b, inv_sqrt(C));
  return cudaSuccess;
}

template <typename T, typename TO>
cudaError_t fwd_by_shape(const void* f1, const Levels& lv, const void* coords, void* out, int B,
                         int Q, int C, int radius, int grid_w, cudaStream_t s) {
  if (radius == 4) {
    return C == 256 ? launch_fwd_tiled<T, TO, 4, 256>(f1, lv, coords, out, B, Q, grid_w, s)
                    : launch_fwd_tiled<T, TO, 4, 128>(f1, lv, coords, out, B, Q, grid_w, s);
  }
  return C == 256 ? launch_fwd_tiled<T, TO, 3, 256>(f1, lv, coords, out, B, Q, grid_w, s)
                  : launch_fwd_tiled<T, TO, 3, 128>(f1, lv, coords, out, B, Q, grid_w, s);
}

// K5's tiled kernel for fmap2 type T (bf16 or fp32): a block per tile and
// staged unit of channels.
template <typename T, typename TG, int R>
cudaError_t launch_df1_tiled(const Levels& lv, const void* coords, const void* g, void* df1,
                             int B, int Q, int C, int grid_w, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  auto kernel = [] {
    if constexpr (kBf16) return ondemand_bwd_df1_tiled_kernel<TG, R>;
    else return ondemand_bwd_df1_tiled_fp32_kernel<TG, R>;
  }();
  const size_t smem = kBf16 ? df1_smem<R>() : df1_smem32<R>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg = tile_grid(lv, B, Q, grid_w);
  if (tg.tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tg.tiles, (unsigned)(C / (kBf16 ? kUnitC : kUnit32)));
  kernel<<<grid, kTileWarps * 32, smem, s>>>(lv, static_cast<const float*>(coords),
                                             static_cast<const TG*>(g), static_cast<float*>(df1),
                                             Q, C, tg.grid_w, tg.tiles_x, tg.tiles_per_b,
                                             inv_sqrt(C));
  return cudaSuccess;
}

template <typename T, typename TG>
cudaError_t df1_by_shape(const Levels& lv, const void* coords, const void* g, void* df1, int B,
                         int Q, int C, int radius, int grid_w, cudaStream_t s) {
  return radius == 4 ? launch_df1_tiled<T, TG, 4>(lv, coords, g, df1, B, Q, C, grid_w, s)
                     : launch_df1_tiled<T, TG, 3>(lv, coords, g, df1, B, Q, C, grid_w, s);
}

constexpr size_t df2_smem() {
  return kDf2F1Bytes + (size_t)kDf2Threads * kHdW * 4 +
         (size_t)(2 * kDf2Threads + kDf2Warps + kDf2Warps * kDf2Threads) * 4;
}

template <typename T, int R>
cudaError_t launch_df2(const Levels& lv, const Df2Grid& gd, const void* entries,
                       int64_t pair_stride, const void* starts, int nb_stride, const void* g,
                       bool g_bf16, const void* f1, int B, int Q, int C, cudaStream_t s) {
  auto kernel = ondemand_bwd_df2_kernel<T, R>;
  const size_t smem = df2_smem();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)gd.block_start[lv.n], (unsigned)B);
  kernel<<<grid, kDf2Threads, smem, s>>>(lv, gd, static_cast<const int4*>(entries), pair_stride,
                                         static_cast<const int*>(starts), nb_stride, g, g_bf16,
                                         static_cast<const T*>(f1), Q, C, inv_sqrt(C));
  return cudaSuccess;
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
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
                                      int out_dtype, int grid_w, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, level_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || grid_w < 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (in_dtype * 2 + out_dtype) {
    case 0: err = fwd_by_shape<float, float>(f1, lv, coords, out, B, Q, C, radius, grid_w, s); break;
    case 1: err = fwd_by_shape<float, __nv_bfloat16>(f1, lv, coords, out, B, Q, C, radius, grid_w, s); break;
    case 2: err = fwd_by_shape<__nv_bfloat16, float>(f1, lv, coords, out, B, Q, C, radius, grid_w, s); break;
    default: err = fwd_by_shape<__nv_bfloat16, __nv_bfloat16>(f1, lv, coords, out, B, Q, C, radius, grid_w, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Routes of the last raft_corr_ondemand_fwd launch in this process (either
// dtype): counts[0] (tile, level) pairs tiled, counts[1] per query, counts[2]
// the tiles recorded (at most 65536). Synchronous.
extern "C" int raft_corr_ondemand_fwd_routes(long long* counts) {
  counts[0] = counts[1] = counts[2] = 0;
  const int tiles = g_last_tiles < kMaxRecordedTiles ? g_last_tiles : kMaxRecordedTiles;
  if (tiles == 0) return (int)cudaSuccess;
  static unsigned char host[kMaxRecordedTiles * kMaxLevels];
  const cudaError_t err =
      cudaMemcpyFromSymbol(host, g_fwd_route, (size_t)tiles * kMaxLevels);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < tiles; ++i)
    for (int l = 0; l < g_last_levels; ++l) {
      const unsigned char r = host[i * kMaxLevels + l];
      if (r == 1) ++counts[0];
      if (r == 2) ++counts[1];
    }
  counts[2] = tiles;
  return (int)cudaSuccess;
}

// fmap2 levels [B, Hl, Wl, C] (f2_dtype), coords [B, Q, 2] fp32 level-0,
// g [B, Q, n_levels*K*K] (g_dtype), df1 [B, Q, C] fp32 (every element written).
// grid_w: the query grid's width for the kernel's tiles, as for
// raft_corr_ondemand_fwd (0: level 0's when Q = H0 * W0, else 16).
extern "C" int raft_corr_ondemand_bwd_df1(const void* const* level_ptrs, const int* level_h,
                                          const int* level_w, int n_levels,
                                          const void* coords, const void* g, void* df1,
                                          int B, int Q, int C, int radius, int f2_dtype,
                                          int g_dtype, int grid_w, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, level_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || f2_dtype < 0 || f2_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1 || grid_w < 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (f2_dtype * 2 + g_dtype) {
    case 0: err = df1_by_shape<float, float>(lv, coords, g, df1, B, Q, C, radius, grid_w, s); break;
    case 1: err = df1_by_shape<float, __nv_bfloat16>(lv, coords, g, df1, B, Q, C, radius, grid_w, s); break;
    case 2: err = df1_by_shape<__nv_bfloat16, float>(lv, coords, g, df1, B, Q, C, radius, grid_w, s); break;
    default: err = df1_by_shape<__nv_bfloat16, __nv_bfloat16>(lv, coords, g, df1, B, Q, C, radius, grid_w, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K6's prepass. coords [B, Q, 2] fp32 level-0; level_h, level_w: the df2
// levels' shapes (host arrays); entries [B, n_levels, pair_stride] int4,
// pair_stride >= Q * (2r + 2) (a level's first starts[Hl] written) and
// starts [B, n_levels, nb_stride] int32, nb_stride >= Hl + 1 for every level.
extern "C" int raft_corr_ondemand_df2_plan(const void* coords, const int* level_h,
                                           const int* level_w, int n_levels, int B, int Q,
                                           int radius, void* entries, long long pair_stride,
                                           void* starts, int nb_stride, void* stream) {
  Levels lv;
  const void* none[kMaxLevels] = {};
  if (!fill_levels(&lv, none, level_h, level_w, n_levels) || B < 0 || B > 65535 || Q < 0 ||
      (radius != 3 && radius != 4) || pair_stride < (long long)Q * (2 * radius + 2))
    return (int)cudaErrorInvalidValue;
  int h_max = 0;
  for (int i = 0; i < n_levels; ++i) {
    if (lv.H[i] > 32767 || lv.W[i] > 32767) return (int)cudaErrorInvalidValue;  // packed taps
    if (lv.W[i] > 0 && lv.H[i] > h_max) h_max = lv.H[i];
  }
  if (h_max + 1 > nb_stride || h_max * (int)sizeof(int) > kPlanSmem)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return (int)cudaSuccess;
  // as many warps as their counts fit in kPlanSmem, and no more than 32 queries each
  int nw = kPlanWarps;
  while (nw > 1 && ((size_t)nw * h_max * sizeof(int) > (size_t)kPlanSmem || 32 * nw > Q))
    nw /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_levels, (unsigned)B);
  const size_t smem = (size_t)nw * h_max * sizeof(int);
  auto kernel = radius == 4 ? ondemand_df2_plan_kernel<4> : ondemand_df2_plan_kernel<3>;
  kernel<<<grid, nw * 32, smem, s>>>(lv, static_cast<const float*>(coords), Q,
                                     (int64_t)pair_stride, nb_stride,
                                     static_cast<int4*>(entries), static_cast<int*>(starts));
  return (int)cudaGetLastError();
}

// df2 levels [B, Hl, Wl, C] fp32 (every element written; empty levels
// allowed); entries, pair_stride, starts and nb_stride from
// raft_corr_ondemand_df2_plan on the same coords, shapes and radius; g [B, Q,
// n_levels*K*K] (g_dtype), f1 [B, Q, C] (f1_dtype).
extern "C" int raft_corr_ondemand_bwd_df2(const void* const* df2_ptrs, const int* level_h,
                                          const int* level_w, int n_levels,
                                          const void* entries, long long pair_stride,
                                          const void* starts, int nb_stride, const void* g,
                                          const void* f1, int B, int Q, int C, int radius,
                                          int f1_dtype, int g_dtype, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, df2_ptrs, level_h, level_w, n_levels) ||
      !kernel_shape_ok(B, Q, C, radius) || f1_dtype < 0 || f1_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1 || B > 65535 || pair_stride < (long long)Q * (2 * radius + 2))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return (int)cudaSuccess;
  Df2Grid gd;
  gd.block_start[0] = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    int blocks = 0;
    gd.cg[i] = gd.cs[i] = gd.nseg[i] = gd.ncb[i] = gd.cpl[i] = 1;
    if (i < n_levels && lv.H[i] > 0 && lv.W[i] > 0) {
      if (lv.H[i] + 1 > nb_stride) return (int)cudaErrorInvalidValue;
      const int W = lv.W[i];
      const int cg = next_pow2((W < 32 ? W + 3 : 35) / 4);  // column groups of 4
      const int cs = min(kDf2Warps / cg, C / 32);            // the other warps: channels
      const int nseg = (W + 4 * cg - 1) / (4 * cg);
      const int64_t base = (int64_t)B * lv.H[i] * nseg;
      int ncb = 1;  // channel blocks: until the level fills the card or a lane has 1 channel
      while (ncb * cs < C / 32 && base * ncb < kDf2TargetBlocks) ncb *= 2;
      gd.cg[i] = cg;
      gd.cs[i] = cs;
      gd.nseg[i] = nseg;
      gd.ncb[i] = ncb;
      gd.cpl[i] = C / (32 * cs * ncb);
      const int64_t nbk = (int64_t)lv.H[i] * nseg * ncb;
      if (nbk + gd.block_start[i] > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
      blocks = (int)nbk;
    }
    gd.block_start[i + 1] = gd.block_start[i] + blocks;
  }
  if (gd.block_start[n_levels] == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g_bf16 = g_dtype == 1;
  cudaError_t err;
  if (f1_dtype == 1)
    err = radius == 4 ? launch_df2<__nv_bfloat16, 4>(lv, gd, entries, pair_stride, starts,
                                                     nb_stride, g, g_bf16, f1, B, Q, C, s)
                      : launch_df2<__nv_bfloat16, 3>(lv, gd, entries, pair_stride, starts,
                                                     nb_stride, g, g_bf16, f1, B, Q, C, s);
  else
    err = radius == 4 ? launch_df2<float, 4>(lv, gd, entries, pair_stride, starts, nb_stride,
                                             g, g_bf16, f1, B, Q, C, s)
                      : launch_df2<float, 3>(lv, gd, entries, pair_stride, starts, nb_stride,
                                             g, g_bf16, f1, B, Q, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One directional pass of RAFT's SepConvGRU, fused, for Hopper (sm_90a).
// Built by kernels/_build.py with plain nvcc; bound through ctypes by
// kernels/gru_fused.py. No PyTorch headers.
//
// Replaces the Pallas TPU kernel raft_optical_flow_tpu/kernels/gru_fused.py::
// _gru_pass_kernel (K7), launched by _sepconv_gru_fwd_impl.run_pass once for
// the horizontal (1x5) and once for the vertical (5x1) pass:
//
//   raft_sepconv_gru_pass   <- _gru_pass_kernel (K7)
//
// What it computes, per pixel of h [B, H, W, D] and x [B, H, W, X] (NHWC):
//   z  = sigmoid(sum_t W_z[t] . cat(h, x)[p + t - 2] + b_z)
//   r  = sigmoid(sum_t W_r[t] . cat(h, x)[p + t - 2] + b_r)
//   rh = r * h                       (r rounded to the dtype, product in it)
//   q  = tanh(sum_t W_q[t] . cat(rh, x)[p + t - 2] + b_q)
//   h' = (1 - z) * h + z * q         (fp32, one rounding to the dtype)
// t = 0..4 walks the pass axis (W for the 1x5 pass, H for the 5x1 pass); taps
// outside the image read 0 for h, x and rh. The weights come as one tensor
// w [5, D + X, 3D] in the dtype of h (columns z | r | q, rows h | x) and one
// fp32 bias [3D]. Sums are fp32. cat(h, x), z, r, rh and q never reach device
// memory.
//
// Design. A block owns a strip of kT = 44 positions of one line along the
// pass axis. q at a position needs rh at +-2, and r there needs h and x at
// +-4, so the block stages h and x of the strip with a 4-position halo
// (positions [t0 - 4, t0 + 48)) in shared memory, computes z and r over the
// strip plus a 2-position halo (48 GEMM rows, [t0 - 2, t0 + 46)), overwrites
// the staged h with rh there, computes q over the strip, and writes h'. Each
// pass is one launch; nothing is recomputed across blocks but r on the
// 2-position halo (and z on it, whose columns share the GEMM with r). The
// TPU kernel sidestepped the halo by blocking full rows or columns (the tiles
// of VMEM were large enough); shared memory is not.
//
// The two GEMMs per block are [48 x 5(D+X)] x [5(D+X) x 2D] (z and r) and
// [48 x 5(D+X)] x [5(D+X) x D] (q); the A operand is the staged strip itself,
// read at a row offset per tap, so no im2col copy exists. bf16: warp-level
// tensor-core products (nvcuda::wmma 16x16x16, bf16 in, fp32 accumulator),
// the weights' B tiles loaded straight from global memory (L2 serves them:
// 1.47 MB per pass at D = 128, X = 256). fp32: full-precision FMAs on the
// CUDA cores (no TF32: the fp32 policy is exact fp32), each thread a 6 x 8
// (z, r) or 6 x 4 (q) register tile, A broadcast from shared memory and the
// weights as float4 rows.
//
// Bound on the card: operations. At the serving shape (batch 16, 55x128,
// D = 128, X = 256) a pass is 166 GFLOP against about 117 MB of bytes: 0.168
// ms at the bf16 tensor-core peak, 2.48 ms at the fp32 CUDA-core peak. This
// first version pays for its simplicity: each block streams every weight from
// L2, the halo rows are computed twice, a ragged last strip computes 48 rows
// for a few, and mma.sync reaches a fraction of what wgmma would. Making it
// fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 128;       // hidden channels (RAFT-standard)
constexpr int kTaps = 5;      // 1x5 / 5x1 window
constexpr int kT = 44;        // output positions per block
constexpr int kM = 48;        // GEMM rows: z and r over [t0 - 2, t0 + 46)
constexpr int kRows = 56;     // staged rows: [t0 - 4, t0 + 48) and 4 zero rows
constexpr int kLive = kT + 8; // staged rows that can hold image data
constexpr int kThreads = 256; // 8 warps
constexpr int kLdg = 2 * kD + 4;  // row stride of the fp32 gate buffer

template <typename T> struct Pad;  // staged row padding, in elements
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 16; };  // 32 B rows for wmma

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// r.astype(dtype) * h, the product in the dtype.
__device__ __forceinline__ float gate_product(float r, float h) { return r * h; }
__device__ __forceinline__ __nv_bfloat16 gate_product(float r, __nv_bfloat16 h) {
  const float rb = __bfloat162float(__float2bfloat16_rn(r));
  return __float2bfloat16_rn(rb * __bfloat162float(h));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

template <typename T>
size_t smem_bytes(int C) {
  return align128((size_t)kRows * (C + Pad<T>::v) * sizeof(T)) +
         (size_t)kM * kLdg * sizeof(float);
}

// fp32 GEMMs on the CUDA cores. Thread (tr, tc) = (warp, lane) owns rows
// tr + 8i (i < 6) and 4 columns per 128-column group; a warp's A reads are
// one broadcast address, its weight reads one 512-byte row segment.
// z and r: G[m][0, 2D) = sum_t,c hx[m + t][c] * w[t][c][0, 2D).
__device__ void gemm_zr_fp32(const float* hx, int lda, const float* __restrict__ w,
                             int C, float* G) {
  const int tc = threadIdx.x & 31, tr = threadIdx.x >> 5;
  const int n3 = 3 * kD;
  float acc[6][8];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int t = 0; t < kTaps; ++t) {
    const float* a0 = hx + (tr + t) * lda;
    const float* wt = w + (size_t)t * C * n3 + 4 * tc;
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const float4 wz = __ldg(reinterpret_cast<const float4*>(wt + (size_t)c * n3));
      const float4 wr = __ldg(reinterpret_cast<const float4*>(wt + (size_t)c * n3 + kD));
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float a = a0[8 * i * lda + c];
        acc[i][0] += a * wz.x; acc[i][1] += a * wz.y;
        acc[i][2] += a * wz.z; acc[i][3] += a * wz.w;
        acc[i][4] += a * wr.x; acc[i][5] += a * wr.y;
        acc[i][6] += a * wr.z; acc[i][7] += a * wr.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float* g = G + (tr + 8 * i) * kLdg + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j] = acc[i][j];
      g[kD + j] = acc[i][4 + j];
    }
  }
}

// q: G[m][D, 2D) = sum_t,c hx[m + t + 2][c] * w[t][c][2D, 3D).
__device__ void gemm_q_fp32(const float* hx, int lda, const float* __restrict__ w,
                            int C, float* G) {
  const int tc = threadIdx.x & 31, tr = threadIdx.x >> 5;
  const int n3 = 3 * kD;
  float acc[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int t = 0; t < kTaps; ++t) {
    const float* a0 = hx + (tr + t + 2) * lda;
    const float* wt = w + (size_t)t * C * n3 + 2 * kD + 4 * tc;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 wq = __ldg(reinterpret_cast<const float4*>(wt + (size_t)c * n3));
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float a = a0[8 * i * lda + c];
        acc[i][0] += a * wq.x; acc[i][1] += a * wq.y;
        acc[i][2] += a * wq.z; acc[i][3] += a * wq.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float* g = G + (tr + 8 * i) * kLdg + kD + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = acc[i][j];
  }
}

// bf16 GEMMs on the tensor cores: warp wid owns GEMM columns
// [32 wid, 32 wid + 32) of z|r (two 16-wide tiles) and [16 wid, 16 wid + 16)
// of q, over the three 16-row tiles. A from the staged strip (row offset =
// tap), B straight from the weights in global memory.
using namespace nvcuda;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ void gemm_zr_bf16(const __nv_bfloat16* hx, int lda,
                             const __nv_bfloat16* __restrict__ w, int C, float* G) {
  const int wid = threadIdx.x >> 5;
  const int n3 = 3 * kD;
  FragC acc[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wmma::fill_fragment(acc[i][0], 0.0f);
    wmma::fill_fragment(acc[i][1], 0.0f);
  }
  FragA a;
  FragB b0, b1;
  for (int t = 0; t < kTaps; ++t) {
    const __nv_bfloat16* wt = w + (size_t)t * C * n3 + 32 * wid;
    for (int c0 = 0; c0 < C; c0 += 16) {
      wmma::load_matrix_sync(b0, wt + (size_t)c0 * n3, n3);
      wmma::load_matrix_sync(b1, wt + (size_t)c0 * n3 + 16, n3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wmma::load_matrix_sync(a, hx + (16 * i + t) * lda + c0, lda);
        wmma::mma_sync(acc[i][0], a, b0, acc[i][0]);
        wmma::mma_sync(acc[i][1], a, b1, acc[i][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wmma::store_matrix_sync(G + 16 * i * kLdg + 32 * wid, acc[i][0], kLdg, wmma::mem_row_major);
    wmma::store_matrix_sync(G + 16 * i * kLdg + 32 * wid + 16, acc[i][1], kLdg,
                            wmma::mem_row_major);
  }
}

__device__ void gemm_q_bf16(const __nv_bfloat16* hx, int lda,
                            const __nv_bfloat16* __restrict__ w, int C, float* G) {
  const int wid = threadIdx.x >> 5;
  const int n3 = 3 * kD;
  FragC acc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) wmma::fill_fragment(acc[i], 0.0f);
  FragA a;
  FragB b;
  for (int t = 0; t < kTaps; ++t) {
    const __nv_bfloat16* wt = w + (size_t)t * C * n3 + 2 * kD + 16 * wid;
    for (int c0 = 0; c0 < C; c0 += 16) {
      wmma::load_matrix_sync(b, wt + (size_t)c0 * n3, n3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wmma::load_matrix_sync(a, hx + (16 * i + t + 2) * lda + c0, lda);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    wmma::store_matrix_sync(G + 16 * i * kLdg + kD + 16 * wid, acc[i], kLdg,
                            wmma::mem_row_major);
}

// Grid: x = line (b and the index across the pass axis), y = strip along it.
// axis 2: the 1x5 pass, lines are rows; axis 1: the 5x1 pass, lines are
// columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_pass_kernel(const T* __restrict__ h, const T* __restrict__ x,
                    const T* __restrict__ w, const float* __restrict__ bias,
                    T* __restrict__ out, int H, int W, int X, int axis) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = kD + X;
  const int lda = C + Pad<T>::v;
  T* hx = reinterpret_cast<T*>(smem);
  float* G = reinterpret_cast<float*>(smem + align128((size_t)kRows * lda * sizeof(T)));

  const bool horizontal = axis == 2;
  const int len = horizontal ? W : H;
  const int across = horizontal ? H : W;
  const int b = blockIdx.x / across;
  const int o = blockIdx.x - b * across;
  const int t0 = blockIdx.y * kT;
  // pixel index of position p on this line
  const int64_t line0 = horizontal ? ((int64_t)b * H + o) * W : (int64_t)b * H * W + o;
  const int64_t step = horizontal ? 1 : W;

  // 1. stage h | x of positions [t0 - 4, t0 + 48), zero outside the image,
  //    16-byte vectors (the wrapper checks the alignment)
  constexpr int vec = 16 / sizeof(T);
  const int hv = kD / vec, rowv = C / vec;
  for (int i = threadIdx.x; i < kRows * rowv; i += kThreads) {
    const int row = i / rowv;
    const int v = i - row * rowv;
    const int p = t0 - 4 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < kLive && p >= 0 && p < len) {
      const int64_t pix = line0 + p * step;
      val = v < hv ? __ldg(reinterpret_cast<const uint4*>(h + pix * kD) + v)
                   : __ldg(reinterpret_cast<const uint4*>(x + pix * X) + (v - hv));
    }
    *(reinterpret_cast<uint4*>(hx + row * lda) + v) = val;
  }
  __syncthreads();

  // 2. z and r over GEMM rows m = 0..47 (positions t0 - 2 + m)
  if constexpr (std::is_same<T, float>::value) {
    gemm_zr_fp32(hx, lda, w, C, G);
  } else {
    gemm_zr_bf16(hx, lda, w, C, G);
  }
  __syncthreads();

  // 3. z kept in place; the staged h of row m + 2 becomes rh (h is 0 outside
  //    the image, so rh is too)
  for (int i = threadIdx.x; i < kM * kD; i += kThreads) {
    const int m = i / kD;
    const int n = i - m * kD;
    float* g = G + m * kLdg;
    g[n] = sigmoid(g[n] + bias[n]);
    const float r = sigmoid(g[kD + n] + bias[kD + n]);
    T* hp = hx + (m + 2) * lda + n;
    *hp = gate_product(r, *hp);
  }
  __syncthreads();

  // 4. q over GEMM rows m = 0..47 (positions t0 + m; rows past kT are dropped)
  if constexpr (std::is_same<T, float>::value) {
    gemm_q_fp32(hx, lda, w, C, G);
  } else {
    gemm_q_bf16(hx, lda, w, C, G);
  }
  __syncthreads();

  // 5. h' = (1 - z) h + z q, h re-read from global memory (L2)
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int j = i / kD;
    const int n = i - j * kD;
    const int p = t0 + j;
    if (p >= len) break;  // rows are in order: the rest of the strip is past the end
    const int64_t off = (line0 + p * step) * kD + n;
    const float z = G[(j + 2) * kLdg + n];
    const float q = tanhf(G[j * kLdg + kD + n] + bias[2 * kD + n]);
    from_f(out + off, (1.0f - z) * to_f(h[off]) + z * q);
  }
}

template <typename T>
int launch(const void* h, const void* x, const void* w, const void* bias, void* out,
           int B, int H, int W, int X, int axis, cudaStream_t s) {
  const int C = kD + X;
  const size_t smem = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(gru_pass_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int len = axis == 2 ? W : H;
  const int across = axis == 2 ? H : W;
  const dim3 grid((unsigned)((int64_t)B * across), (unsigned)((len + kT - 1) / kT));
  gru_pass_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W, X, axis);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B, H, W, D], x [B, H, W, X], out [B, H, W, D]: contiguous NHWC, 16-byte
// aligned, out not overlapping h or x; w [5, D + X, 3D] contiguous in the
// dtype of h; bias [3D] fp32. D must be 128 and X a positive multiple of 16.
// axis: 2 = the 1x5 pass (along W), 1 = the 5x1 pass (along H). dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int raft_sepconv_gru_pass(const void* h, const void* x, const void* w,
                                     const void* bias, void* out, int B, int H, int W,
                                     int D, int X, int axis, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || D != kD || X <= 0 || X % 16 != 0 ||
      (axis != 1 && axis != 2) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * (axis == 2 ? H : W) > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = dtype == 0 ? smem_bytes<float>(kD + X) : smem_bytes<__nv_bfloat16>(kD + X);
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;  // 227 KB per block
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(h, x, w, bias, out, B, H, W, X, axis, s)
                    : launch<__nv_bfloat16>(h, x, w, bias, out, B, H, W, X, axis, s);
}

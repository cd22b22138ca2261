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
// Bound on the card: operations. At the serving shape (batch 16, 55x128,
// D = 128, X = 256) a pass is 166 GFLOP against about 117 MB of bytes: 0.168
// ms at the bf16 tensor-core peak, 2.48 ms at the fp32 CUDA-core peak.
//
// bf16 design (gru_pass_tc_kernel). A block owns 128 GEMM rows, each one
// position of a line along the pass axis, and computes for them z|r (a
// [128 x 5(D+X)] x [5(D+X) x 2D] product), then rh, then q ([128 x 5(D+X)] x
// [5(D+X) x D]), then h'. Lines of at most 62 positions are packed whole
// into each warpgroup's 64 rows (the 5x1 pass's 55-position columns: one per
// warpgroup, two per block), lines of 63..128 take a block each (the 1x5
// pass's 128-position rows), longer lines are cut into segments of 124
// written positions whose 128 rows carry 2 positions of halo on each side
// (r there feeds rh, which q at the segment's edge needs). Since a block's
// rows cover each line it writes whole or with that halo, z, r and q share
// one row set and no block needs another's rh.
//   - Weights. Every row of the block shares each weight tile: a block reads
//     the pass's 1.47 MB of bf16 weights (D = 128, X = 256) once for its 128
//     rows, against once per 48 rows before (L2 traffic per launch down by
//     the ratio of blocks: 2,640 -> 880 for the 1x5 pass, 4,096 -> 1,024 for
//     the 5x1 pass at the serving shape). A small kernel first lays the
//     weights out once per pass as a run of 32-channel chunks, each the exact
//     shared-memory image that wgmma reads (K-major, 64-byte swizzle), so one
//     producer warp streams them with cp.async.bulk into a ring of up to six
//     16 KB slots, completion on an mbarrier per slot, and the two consumer
//     warpgroups release a slot on another once their products on it are
//     done: the next chunks load while this one is multiplied.
//   - Products. wgmma m64n128k16 (bf16 in, fp32 accumulators in registers),
//     B (weights) from the swizzled slot through a descriptor, A from
//     registers: the staged strip is read with ldmatrix at the row offset of
//     each tap (a shared-memory descriptor cannot start at an arbitrary row
//     of a swizzled tile; ldmatrix takes any 16-byte-aligned row address), so
//     no im2col copy exists. A's registers are double-buffered per chunk, so
//     one chunk's products run while the next chunk's fragments load.
//   - State. h | x of the block's positions (plus 2 zero or halo rows on each
//     side of each line) is staged once in shared memory; rh overwrites the
//     staged h; z stays in the accumulators through the q product, and h' is
//     computed in registers (h re-read from L2).
// fp32 design (gru_pass_fp32_gemm_kernel): full-precision FMAs on the CUDA cores
// (no TF32: the fp32 policy is exact fp32), two launches a pass. The first
// is the z|r GEMM over every position ([P x 5(D+X)] x [5(D+X) x 2D]): z goes
// to the output buffer, r * h to a scratch buffer. The second is the q GEMM
// over cat(r * h, x) and the update, in place over z. Splitting the pass
// there removes the halo that one kernel must recompute (r at 2 positions
// beyond each side of its strip) and lets each GEMM's rows run over the
// positions of all lines, line after line, so that short lines (46 and 62 at
// the training shape) fill blocks whole.
//   - Bound: operations. Batch 2, 46x62 (5,704 positions), D = 128, X = 256:
//     8.41 GFLOP a pass, 0.1255 ms at the card's 67 TFLOP/s of fp32 FMA.
//   - Weights. A block owns 8 TM positions (TM rows per thread, 4..8, chosen
//     per launch so that the blocks, one an SM, end soonest: TM = 6 at the
//     training shape, 119 blocks) and streams the GEMM's weights once through
//     a ring of 32-channel chunks (16 where C is no multiple of 32) in shared
//     memory, three in flight (cp.async), read by all 8 warps: 119 x 2.95 MB
//     = 0.35 GB of L2 reads a pass, against 0.54 GB (1x5) and 0.73 GB (5x1)
//     for the kernel this replaces (a block per 44-position strip of one
//     line, each thread reading its weights from L2).
//   - Products. Thread tiles of TM x 8 (z|r) or TM x 4 (q) fp32 accumulators,
//     both operands read from shared memory as float4: per 4 channels, TM
//     loads of A (each row a broadcast to 8 lanes) and 8 (or 4) weight loads
//     for 32 TM (16 TM) FMAs.
//   - Sum order. Each output is one fmaf chain over taps ascending, then
//     channels ascending, starting from 0, and the gate arithmetic is the
//     strip kernel's, so the outputs are that kernel's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kD = 128;       // hidden channels (RAFT-standard)
constexpr int kTaps = 5;      // 1x5 / 5x1 window
constexpr int kN3 = 3 * kD;   // weight columns z | r | q
constexpr int kSmemLimit = 232448;  // 227 KB per block

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// r.astype(dtype) * h, the product in the dtype.
__device__ __forceinline__ float gate_product(float r, float h) { return r * h; }
__device__ __forceinline__ __nv_bfloat16 gate_product(float r, __nv_bfloat16 h) {
  const float rb = __bfloat162float(__float2bfloat16_rn(r));
  return __float2bfloat16_rn(rb * __bfloat162float(h));
}

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// pixel index of position p of line `line`: axis 2 (1x5 pass) lines are rows,
// axis 1 (5x1 pass) lines are columns
__device__ __forceinline__ int64_t line_pixel(int64_t line, int p, int H, int W, bool horizontal) {
  if (horizontal) return line * W + p;
  const int64_t b = line / W;
  return (b * H + p) * W + (line - b * W);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

// ---------------------------------------------------------------------------
// fp32: two CUDA-core GEMMs a pass, over runs of positions.

constexpr int kF32Threads = 256;  // 8 warps: 2 along the rows, 4 along the columns
constexpr int kF32Stages = 4;     // weight chunks in flight and in use
constexpr int kF32Pad = 4;        // staged row pad: rows r..r+3 fall in distinct banks
constexpr int kF32MinTm = 4;      // rows per thread: a block owns 8 TM positions
constexpr int kF32MaxTm = 8;

// Shared memory of a block: BM + 4 staged rows and one zero row, then the
// weight ring of chunks of kc channels.
__host__ __device__ constexpr int f32_block_rows(int tm) { return 8 * tm; }

size_t f32_smem_bytes(int C, int tm, int ncol, int kc) {
  return (size_t)(f32_block_rows(tm) + 5) * (C + kF32Pad) * 4 +
         (size_t)kF32Stages * kc * ncol * 4;
}

// One of the pass's two GEMMs over the positions of all lines, line after
// line (f = line * L + p); block b owns rows f in [BM b, BM (b + 1)), BM = 8 TM.
// ZR: G = cat(h, x) taps x w[:, :, 0:2D]; z goes to out, r * h to rh.
// Q: G = cat(rh, x) taps x w[:, :, 2D:3D]; h' = (1 - z) h + z q over the z in out.
// The block stages the rows f0 - 2 .. f0 + BM + 1 whole (C channels) once;
// the A operand of row m at tap t is staged row m + t when position p + t - 2
// lies on the line, else a zero row. The weights come through a ring of
// KC-channel chunks (cp.async, three ahead), read by every warp. Thread
// (warp, lane) owns rows row0 + 4i (i < TM) and columns colw + 32j + e
// (e < 4): per 4 channels it loads TM float4 of A (each a 4-row broadcast,
// no bank conflicts with lda = C + 4) and TN float4 of weights (each 128
// contiguous bytes), for 4 * TM * TN FMAs. Each output is one fmaf chain
// over taps ascending, then channels ascending, from 0: the strip kernel's
// order, so the same bits.
template <int TM, int KC, bool ZR>
__global__ void __launch_bounds__(kF32Threads, 1)
    gru_pass_fp32_gemm_kernel(const float* __restrict__ hin, const float* __restrict__ x,
                         const float* __restrict__ w, const float* __restrict__ bias,
                         const float* __restrict__ h, float* __restrict__ out,
                         float* __restrict__ rh, int H, int W, int X, int axis,
                         int64_t total) {
  constexpr int BM = f32_block_rows(TM);
  constexpr int NCOL = ZR ? 2 * kD : kD;
  constexpr int TN = NCOL / 32;
  extern __shared__ __align__(16) float f32s[];
  const int C = kD + X;
  const int lda = C + kF32Pad;
  float* A = f32s;                      // [BM + 5][lda], row BM + 4 all zero
  float* ring = f32s + (BM + 5) * lda;  // [kF32Stages][KC][NCOL]
  const int tid = threadIdx.x;
  const bool horizontal = axis == 2;
  const int L = horizontal ? W : H;
  const int64_t f0 = (int64_t)blockIdx.x * BM;
  const int cpt = C / KC;  // chunks per tap
  const int nk = kTaps * cpt;

  // chunk k: tap k / cpt, channels KC (k % cpt) .., this GEMM's columns
  auto issue = [&](int k) {
    const int t = k / cpt;
    const int c0 = (k - t * cpt) * KC;
    const float* src = w + ((size_t)t * C + c0) * kN3 + (ZR ? 0 : 2 * kD);
    const uint32_t dst = smem_u32(ring + (k % kF32Stages) * (KC * NCOL));
    for (int e = tid; e < KC * NCOL / 4; e += kF32Threads) {
      const int r = e / (NCOL / 4);
      const int v = e - r * (NCOL / 4);
      cp_async16(dst + (r * NCOL + 4 * v) * 4, src + (size_t)r * kN3 + 4 * v);
    }
  };

  // stage rows f0 - 2 + s (h | x, or rh | x), zero outside [0, total), and
  // the zero row
  {
    const int hv = kD / 4, rowv = C / 4;
    for (int i = tid; i < (BM + 5) * rowv; i += kF32Threads) {
      const int s = i / rowv;
      const int v = i - s * rowv;
      const int64_t f = f0 - 2 + s;
      float* dst = A + s * lda + 4 * v;
      if (s < BM + 4 && f >= 0 && f < total) {
        const int64_t line = f / L;
        const int64_t pix = line_pixel(line, (int)(f - line * L), H, W, horizontal);
        cp_async16(smem_u32(dst), v < hv ? (const void*)(hin + pix * kD + 4 * v)
                                         : (const void*)(x + pix * X + 4 * (v - hv)));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < kF32Stages - 1; ++k) {
    if (k < nk) issue(k);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp >> 2) * (BM / 2) + (lane >> 3);
  const int colw = (warp & 3) * (NCOL / 4) + 4 * (lane & 7);
  int pos[TM];  // position on its line of each row; far negative past the end
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t f = f0 + row0 + 4 * i;
    pos[i] = f < total ? (int)(f % L) : -8;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kF32Stages - 2>();  // the rows and chunk k have landed
    __syncthreads();                  // ... for every thread; chunk k - 1 is done
    if (k + kF32Stages - 1 < nk) issue(k + kF32Stages - 1);  // into chunk k - 1's slot
    cp_async_commit();
    const int t = k / cpt;
    const int c0 = (k - t * cpt) * KC;
    const float* arow[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = pos[i] + t - 2;
      arow[i] = A + ((p >= 0 && p < L) ? row0 + 4 * i + t : BM + 4) * lda + c0;
    }
    const float* wk = ring + (k % kF32Stages) * (KC * NCOL) + colw;
#pragma unroll
    for (int cc = 0; cc < KC; cc += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(arow[i] + cc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[TN / 4];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(wk + (cc + kk) * NCOL + 32 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) {
            acc[i][4 * j] = fmaf(av, b[j].x, acc[i][4 * j]);
            acc[i][4 * j + 1] = fmaf(av, b[j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(av, b[j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(av, b[j].w, acc[i][4 * j + 3]);
          }
        }
      }
    }
  }

  // the strip kernel's gate arithmetic, element by element
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t f = f0 + row0 + 4 * i;
    if (f >= total) continue;
    const int64_t line = f / L;
    const int64_t pix = line_pixel(line, (int)(f - line * L), H, W, horizontal);
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n0 = colw + 32 * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (ZR) {
          if (n < kD) {  // z (uniform over the warp)
            out[pix * kD + n] = sigmoid(acc[i][4 * j + e] + bias[n]);
          } else {
            const float r = sigmoid(acc[i][4 * j + e] + bias[n]);
            rh[pix * kD + n - kD] = gate_product(r, h[pix * kD + n - kD]);
          }
        } else {
          const int64_t off = pix * kD + n;
          const float z = out[off];
          const float q = tanhf(acc[i][4 * j + e] + bias[2 * kD + n]);
          out[off] = (1.0f - z) * h[off] + z * q;
        }
      }
    }
  }
}

// The rows per thread of one launch: of the TMs whose block fits in shared
// memory, the one whose blocks, one an SM, end soonest (waves x rows a
// block); ties to the larger block (fewer weight reads).
int f32_rows_per_thread(int64_t total, int nsm, int C, int kc) {
  int best = kF32MinTm;
  int64_t best_cost = INT64_MAX;
  for (int tm = kF32MaxTm; tm >= kF32MinTm; --tm) {
    if (f32_smem_bytes(C, tm, 2 * kD, kc) > (size_t)kSmemLimit) continue;
    const int64_t blocks = (total + f32_block_rows(tm) - 1) / f32_block_rows(tm);
    const int64_t cost = (blocks + nsm - 1) / nsm * f32_block_rows(tm);
    if (cost < best_cost) {
      best_cost = cost;
      best = tm;
    }
  }
  return best;
}

template <int TM, int KC, bool ZR>
cudaError_t launch_fp32_gemm(const float* hin, const float* x, const float* w,
                             const float* bias, const float* h, float* out, float* rh,
                             int H, int W, int X, int axis, int64_t total, cudaStream_t s) {
  auto kernel = gru_pass_fp32_gemm_kernel<TM, KC, ZR>;
  const size_t smem = f32_smem_bytes(kD + X, TM, ZR ? 2 * kD : kD, KC);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidConfiguration;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (total + f32_block_rows(TM) - 1) / f32_block_rows(TM);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kF32Threads, smem, s>>>(hin, x, w, bias, h, out, rh, H, W, X, axis,
                                                     total);
  return cudaGetLastError();
}

template <int TM, int KC>
cudaError_t launch_fp32_tm(const float* h, const float* x, const float* w, const float* bias,
                           float* rh, float* out, int H, int W, int X, int axis, int64_t total,
                           cudaStream_t s) {
  cudaError_t err =
      launch_fp32_gemm<TM, KC, true>(h, x, w, bias, h, out, rh, H, W, X, axis, total, s);
  if (err != cudaSuccess) return err;
  return launch_fp32_gemm<TM, KC, false>(rh, x, w, bias, h, out, nullptr, H, W, X, axis, total,
                                         s);
}

template <int KC>
cudaError_t launch_fp32_kc(const float* h, const float* x, const float* w, const float* bias,
                           float* rh, float* out, int H, int W, int X, int axis, int64_t total,
                           int nsm, cudaStream_t s) {
  switch (f32_rows_per_thread(total, nsm, kD + X, KC)) {
    case 4: return launch_fp32_tm<4, KC>(h, x, w, bias, rh, out, H, W, X, axis, total, s);
    case 5: return launch_fp32_tm<5, KC>(h, x, w, bias, rh, out, H, W, X, axis, total, s);
    case 6: return launch_fp32_tm<6, KC>(h, x, w, bias, rh, out, H, W, X, axis, total, s);
    case 7: return launch_fp32_tm<7, KC>(h, x, w, bias, rh, out, H, W, X, axis, total, s);
    default: return launch_fp32_tm<8, KC>(h, x, w, bias, rh, out, H, W, X, axis, total, s);
  }
}

// fp32 pass: the z|r GEMM (z into out, r * h into the scratch rh), then the
// q GEMM and the update, in place over out. Weight chunks of 32 channels
// where C allows (half the barriers of 16), else 16.
int launch_fp32(const void* h, const void* x, const void* w, const void* bias, void* scratch,
                void* out, int B, int H, int W, int X, int axis, cudaStream_t s) {
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * H * W;
  const auto* hf = static_cast<const float*>(h);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* rh = static_cast<float*>(scratch);
  auto* of = static_cast<float*>(out);
  if ((kD + X) % 32 == 0)
    return (int)launch_fp32_kc<32>(hf, xf, wf, bf, rh, of, H, W, X, axis, total, nsm, s);
  return (int)launch_fp32_kc<16>(hf, xf, wf, bf, rh, of, H, W, X, axis, total, nsm, s);
}

// ---------------------------------------------------------------------------
// bf16: wgmma over 128-row blocks, weights streamed through a shared ring.

using bf16 = __nv_bfloat16;

constexpr int kTcConsumers = 256;               // two warpgroups, 64 rows each
constexpr int kTcThreads = kTcConsumers + 32;   // and one producer warp
constexpr int kTcRows = 128;                    // GEMM rows per block
constexpr int kStagedMax = 132;                 // staged positions per block
constexpr int kSeg = 124;                       // written positions per segment of a long line
constexpr int kKc = 32;                         // channels per weight chunk (a 64-byte row)
constexpr int kChunkZR = 2 * kD * kKc;          // elements of a z|r chunk: 256 rows
constexpr int kChunkQ = kD * kKc;               // elements of a q chunk: 128 rows
constexpr int kSlotBytes = kChunkZR * 2;        // 16 KB
constexpr int kMaxSlots = 6;
constexpr int kPackMax = 62;                    // longest line packed whole per warpgroup

// Shared memory of a block besides the weight slots: 1024-byte alignment
// slack, the staged rows, the row tables (srow, live, opix), the mbarriers.
size_t tc_fixed_bytes(int C) {
  return 1024 + (size_t)kStagedMax * (2 * C + 16) + kTcRows * 16 + 2 * kMaxSlots * 8;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kTcConsumers) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major bf16 tile in the 64-byte swizzle: rows of 64 bytes
// (32 channels), 8-row atoms of 512 bytes (stride byte offset), start 16-byte
// units, layout type 2 (B64). The slot is 1024-byte aligned.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d[64 x 128] += A[64 x 16] (registers, four b32 of bf16 pairs per thread)
// x B[16 x 128] (descriptor), fp32 accumulators in the wgmma layout: d[4i +
// 2hi + lo] is row 16 warp + lane / 4 + 8 hi, column 8i + 2 (lane % 4) + lo.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The weight image: w [5, C, 3D] bf16 as a run of chunks, first the z|r
// chunks (tap t, channels [32 cb, 32 cb + 32), columns 0..2D-1), then the q
// chunks (columns 2D..3D-1), each in (t, cb) order. A chunk is K-major (row
// n holds its column's 32 channels, zero past C) in the 64-byte swizzle: the
// 16-byte unit j of row n sits at unit j ^ ((n >> 1) & 3). One thread per
// 16-byte unit.
__global__ void __launch_bounds__(256)
    gru_weight_image_kernel(const bf16* __restrict__ w, bf16* __restrict__ img, int C) {
  const int ncb = (C + kKc - 1) / kKc;
  const int zr_units = kTaps * ncb * (kChunkZR / 8);
  const int total = zr_units + kTaps * ncb * (kChunkQ / 8);
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= total) return;
  int chunk, rem, col0;
  if (u < zr_units) {
    chunk = u / (kChunkZR / 8);
    rem = u - chunk * (kChunkZR / 8);
    col0 = 0;
  } else {
    const int v = u - zr_units;
    chunk = v / (kChunkQ / 8);
    rem = v - chunk * (kChunkQ / 8);
    col0 = 2 * kD;
  }
  const int n = rem >> 2;
  const int j = (rem & 3) ^ ((n >> 1) & 3);
  const int t = chunk / ncb;
  const int c0 = (chunk - t * ncb) * kKc + 8 * j;
  alignas(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    v[e] = c < C ? w[((size_t)t * C + c) * kN3 + col0 + n] : __float2bfloat16_rn(0.0f);
  }
  *reinterpret_cast<uint4*>(img + (size_t)u * 8) = *reinterpret_cast<const uint4*>(v);
}

struct TcPlan {
  int L;        // positions per line
  int nlines;   // lines in the tensor
  int per_wg;   // lines per warpgroup when packed (0: a block per line segment)
  int nseg;     // segments per line when not packed
};

// One consumer warpgroup's share of one weight chunk: wait for its slot,
// load A for the chunk's (at most two) k-steps, issue the products, and
// release the previous chunk's slot once its products are done. NW = 2: the
// z|r chunk (z into acc0, r into acc1, rows 128.. of the slot); 1: q.
template <int NW>
__device__ __forceinline__ void consume_chunk(float (&acc0)[64], float (&acc1)[64],
                                              uint32_t (&a)[2][4], int c, int k, int ncb,
                                              int C, uint32_t a_base, int lda_b,
                                              uint32_t slots, uint32_t full, uint32_t empty,
                                              int nslots, int lane) {
  const int t = k / ncb;
  const int cb = k - t * ncb;
  const int slot = c % nslots;
  mbar_wait(full + 8 * slot, (uint32_t)(c / nslots) & 1);
  const bool two = C - cb * kKc >= kKc;  // else the last 16 channels
  const uint32_t aa = a_base + t * lda_b + cb * (2 * kKc);
  ldsm_x4(a[0], aa);
  if (two) ldsm_x4(a[1], aa + 32);
  wgmma_fence();
  const uint64_t desc = sw64_desc(slots + slot * kSlotBytes);
  constexpr uint64_t kRHalf = (kD * 64) >> 4;  // r's rows start 128 rows (8 KB) in
  wgmma_m64n128k16(acc0, a[0], desc);
  if (NW == 2) wgmma_m64n128k16(acc1, a[0], desc + kRHalf);
  if (two) {
    wgmma_m64n128k16(acc0, a[1], desc + 2);  // channels 16..31: 32 bytes on
    if (NW == 2) wgmma_m64n128k16(acc1, a[1], desc + kRHalf + 2);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (c > 0 && lane == 0) mbar_arrive(empty + 8 * ((c - 1) % nslots));
}

// One block: 128 GEMM rows (see the header). Warps 0-7 are the consumers
// (warpgroup g owns rows 64g..64g+63), warp 8 the producer of weight chunks.
__global__ void __launch_bounds__(kTcThreads, 1)
    gru_pass_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ x,
                       const bf16* __restrict__ img, const float* __restrict__ bias,
                       bf16* __restrict__ out, int H, int W, int X, int axis, TcPlan plan,
                       int nslots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = kD + X;
  const int lda_b = 2 * C + 16;  // staged row stride: 16 bytes of pad, no ldmatrix conflicts
  const int ncb = (C + kKc - 1) / kKc;
  const int nk = kTaps * ncb;
  unsigned char* hx = base + nslots * kSlotBytes;
  int* srow = reinterpret_cast<int*>(hx + kStagedMax * lda_b);
  int* live = srow + kTcRows;
  int64_t* opix = reinterpret_cast<int64_t*>(live + kTcRows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(opix + kTcRows);
  const uint32_t slots_s = smem_u32(base);
  const uint32_t full_s = smem_u32(bars);
  const uint32_t empty_s = full_s + 8 * kMaxSlots;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < nslots; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(empty_s + 8 * i, kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // producer warp: one thread streams the chunks
    if (tid == kTcConsumers) {
      const bf16* img_q = img + (size_t)nk * kChunkZR;
      for (int c = 0; c < 2 * nk; ++c) {
        const int slot = c % nslots;
        if (c >= nslots) mbar_wait(empty_s + 8 * slot, (uint32_t)(c / nslots + 1) & 1);
        const bool zr = c < nk;
        const uint32_t bytes = zr ? kChunkZR * 2 : kChunkQ * 2;
        const bf16* src = zr ? img + (size_t)c * kChunkZR : img_q + (size_t)(c - nk) * kChunkQ;
        mbar_expect_tx(full_s + 8 * slot, bytes);
        bulk_load(slots_s + slot * kSlotBytes, src, bytes, full_s + 8 * slot);
      }
    }
    return;
  }

  // ---- consumers ----
  const bool horizontal = axis == 2;
  const int L = plan.L;
  // rows of the block: staged row (centre), whether rh is computed there, and
  // the output pixel (-1: not written)
  int64_t line_first;  // packed: the block's first line
  int r0 = 0, wlo = 0, whi = 0, nstaged;
  if (plan.per_wg > 0) {
    line_first = (int64_t)blockIdx.x * 2 * plan.per_wg;
    nstaged = 2 * plan.per_wg * (L + 4);
  } else {
    line_first = blockIdx.x / plan.nseg;
    const int seg = blockIdx.x - (int)(line_first * plan.nseg);
    if (plan.nseg == 1) {
      whi = L;
    } else {
      r0 = seg * kSeg - 2;
      wlo = seg * kSeg;
      whi = min(wlo + kSeg, L);
    }
    nstaged = kStagedMax;
  }
  if (tid < kTcRows) {
    int sr = 2, lv = 0;
    int64_t pix = -1;
    if (plan.per_wg > 0) {
      const int g = tid / 64, m = tid % 64;
      const int s = g * plan.per_wg + m / L;
      const int p = m % L;
      if (m < plan.per_wg * L && line_first + s < plan.nlines) {
        sr = s * (L + 4) + 2 + p;
        lv = 1;
        pix = line_pixel(line_first + s, p, H, W, horizontal);
      }
    } else {
      const int p = r0 + tid;
      sr = tid + 2;
      lv = p >= 0 && p < L;
      if (p >= wlo && p < whi) pix = line_pixel(line_first, p, H, W, horizontal);
    }
    srow[tid] = sr;
    live[tid] = lv;
    opix[tid] = pix;
  }
  // stage h | x of the block's positions, zero outside the image
  {
    const int cv = C / 8;  // 16-byte units per staged row
    for (int i = tid; i < nstaged * cv; i += kTcConsumers) {
      const int j = i / cv;
      const int v = i - j * cv;
      int64_t line;
      int p;
      if (plan.per_wg > 0) {
        const int s = j / (L + 4);
        line = line_first + s;
        p = j - s * (L + 4) - 2;
      } else {
        line = line_first;
        p = r0 - 2 + j;
      }
      const uint32_t dst = smem_u32(hx + (size_t)j * lda_b + v * 16);
      if (p >= 0 && p < L && line < plan.nlines) {
        const int64_t pix = line_pixel(line, p, H, W, horizontal);
        cp_async16(dst, v < kD / 8 ? (const void*)(h + pix * kD + v * 8)
                                   : (const void*)(x + pix * X + (v - kD / 8) * 8));
      } else {
        *reinterpret_cast<uint4*>(hx + (size_t)j * lda_b + v * 16) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  }
  consumer_sync();

  const int warp = tid / 32, lane = tid % 32;
  const int row_base = 64 * (warp / 4) + 16 * (warp % 4);
  // ldmatrix: lane l gives the address of row l % 16, channels 8 (l / 16) on
  const uint32_t a_base =
      smem_u32(hx) + (srow[row_base + (lane & 15)] - 2) * lda_b + (lane >> 4) * 16;
  const int rlo = row_base + (lane >> 2);  // accumulator rows rlo and rlo + 8
  const int col = 2 * (lane & 3);          // and columns 8i + col, + 1

  float accz[64], accr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accz[i] = accr[i] = 0.0f;
  uint32_t a[2][2][4];
  int c = 0;
  for (int k = 0; k < nk; k += 2) {
    consume_chunk<2>(accz, accr, a[0], c++, k, ncb, C, a_base, lda_b, slots_s, full_s,
                     empty_s, nslots, lane);
    if (k + 1 < nk)
      consume_chunk<2>(accz, accr, a[1], c++, k + 1, ncb, C, a_base, lda_b, slots_s, full_s,
                       empty_s, nslots, lane);
  }
  wgmma_wait<0>();
  fence_acc(accz);
  fence_acc(accr);
  consumer_sync();  // every warp's ldmatrix of the staged h is done

  // rh = r * h over the live rows, into the staged h
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = rlo + 8 * hi;
    if (!live[row]) continue;
    bf16* hrow = reinterpret_cast<bf16*>(hx + (size_t)srow[row] * lda_b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = 8 * i + col;
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(hrow + n);
      const __nv_bfloat162 hv = *hp;
      const float r0v = sigmoid(accr[4 * i + 2 * hi] + bias[kD + n]);
      const float r1v = sigmoid(accr[4 * i + 2 * hi + 1] + bias[kD + n + 1]);
      __nv_bfloat162 rh;
      rh.x = gate_product(r0v, hv.x);
      rh.y = gate_product(r1v, hv.y);
      *hp = rh;
    }
  }
  consumer_sync();

  float accq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) accq[i] = 0.0f;
  for (int k = 0; k < nk; k += 2) {
    consume_chunk<1>(accq, accq, a[0], c++, k, ncb, C, a_base, lda_b, slots_s, full_s,
                     empty_s, nslots, lane);
    if (k + 1 < nk)
      consume_chunk<1>(accq, accq, a[1], c++, k + 1, ncb, C, a_base, lda_b, slots_s, full_s,
                       empty_s, nslots, lane);
  }
  wgmma_wait<0>();
  fence_acc(accq);

  // h' = (1 - z) h + z q, h re-read from global memory (L2)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = rlo + 8 * hi;
    const int64_t pix = opix[row];
    if (pix < 0) continue;
    const bf16* hp = h + pix * kD;
    bf16* op = out + pix * kD;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = 8 * i + col;
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(hp + n);
      const float z0 = sigmoid(accz[4 * i + 2 * hi] + bias[n]);
      const float z1 = sigmoid(accz[4 * i + 2 * hi + 1] + bias[n + 1]);
      const float q0 = tanhf(accq[4 * i + 2 * hi] + bias[2 * kD + n]);
      const float q1 = tanhf(accq[4 * i + 2 * hi + 1] + bias[2 * kD + n + 1]);
      const float o0 = (1.0f - z0) * __bfloat162float(hv.x) + z0 * q0;
      const float o1 = (1.0f - z1) * __bfloat162float(hv.y) + z1 * q1;
      *reinterpret_cast<__nv_bfloat162*>(op + n) = __floats2bfloat162_rn(o0, o1);
    }
  }
}

// elements of the weight image: kTaps x ceil(C / 32) chunks of each kind
size_t image_elems(int C) { return (size_t)kTaps * ((C + kKc - 1) / kKc) * (kChunkZR + kChunkQ); }

// The blocks of one bf16 launch: lines packed per warpgroup when short, else
// a block per segment.
TcPlan tc_plan(int B, int H, int W, int axis, int64_t* blocks) {
  TcPlan plan;
  plan.L = axis == 2 ? W : H;
  const int64_t nlines = (int64_t)B * (axis == 2 ? H : W);
  plan.nlines = (int)nlines;
  plan.per_wg = plan.L <= kPackMax ? std::min(64 / plan.L, (kStagedMax / 2) / (plan.L + 4)) : 0;
  plan.nseg = plan.L <= kTcRows ? 1 : (plan.L + kSeg - 1) / kSeg;
  *blocks = plan.per_wg > 0 ? (nlines + 2 * plan.per_wg - 1) / (2 * plan.per_wg)
                            : nlines * plan.nseg;
  return plan;
}

int launch_bf16(const void* h, const void* x, const void* w, const void* bias, void* img,
                void* out, int B, int H, int W, int X, int axis, cudaStream_t s) {
  const int C = kD + X;
  const size_t fixed = tc_fixed_bytes(C);
  if (fixed + 2 * (size_t)kSlotBytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidConfiguration;
  const int nslots = (int)std::min<size_t>(kMaxSlots, (kSmemLimit - fixed) / kSlotBytes);
  const size_t smem = fixed + (size_t)nslots * kSlotBytes;

  const int units = (int)(image_elems(C) / 8);
  gru_weight_image_kernel<<<(units + 255) / 256, 256, 0, s>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(img), C);

  cudaError_t err = cudaFuncSetAttribute(gru_pass_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks;
  const TcPlan plan = tc_plan(B, H, W, axis, &blocks);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  gru_pass_tc_kernel<<<(unsigned)blocks, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x), static_cast<const bf16*>(img),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, X, axis, plan, nslots);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer raft_sepconv_gru_pass takes for the given
// shape and dtype (0 for shapes it refuses).
extern "C" int64_t raft_sepconv_gru_scratch_bytes(int B, int H, int W, int D, int X, int dtype) {
  if (B <= 0 || H <= 0 || W <= 0 || D != kD || X <= 0 || X % 16 != 0) return 0;
  if (dtype == 0) return (int64_t)B * H * W * kD * 4;  // r * h of every position
  if (dtype == 1) return (int64_t)image_elems(kD + X) * 2;
  return 0;
}

// h [B, H, W, D], x [B, H, W, X], out [B, H, W, D]: contiguous NHWC, 16-byte
// aligned, out not overlapping h or x; w [5, D + X, 3D] contiguous in the
// dtype of h; bias [3D] fp32; scratch: raft_sepconv_gru_scratch_bytes bytes,
// 16-byte aligned, rewritten by every call (fp32: r * h; bf16: the weight
// image). D must be
// 128 and X a positive multiple of 16. axis: 2 = the 1x5 pass (along W), 1 =
// the 5x1 pass (along H). dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t as int.
extern "C" int raft_sepconv_gru_pass(const void* h, const void* x, const void* w,
                                     const void* bias, void* scratch, void* out, int B, int H,
                                     int W, int D, int X, int axis, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || D != kD || X <= 0 || X % 16 != 0 ||
      (axis != 1 && axis != 2) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * (axis == 2 ? H : W) > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fp32(h, x, w, bias, scratch, out, B, H, W, X, axis, s);
  return launch_bf16(h, x, w, bias, scratch, out, B, H, W, X, axis, s);
}

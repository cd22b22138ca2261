// RAFT-small's update-block convolutions in fp32, for Hopper (sm_90a): one
// implicit-GEMM convolution kernel (K9) with the ConvGRU's gates in its
// epilogue. Built by kernels/_build.py with plain nvcc; bound through ctypes
// by kernels/small_update.py. No PyTorch headers.
//
// Replaces no TPU kernel: the JAX package leaves SmallUpdateBlock's
// convolutions to XLA (raft_optical_flow_tpu/models/update.py reaches no
// pl.pallas_call). It was added because, under the fp32 policy (TF32 off),
// cuDNN runs the block's 3x3 convolutions as FFT convolutions: at the
// batch-16 Sintel serving shape they took 97% of the device's time of a
// RAFT-small call (2.18 of 2.26 s, NVIDIA H100 80GB HBM3, 700 W), 23x the
// bound of their operations at the fp32 CUDA-core rate.
//
// What one launch computes, for an NHWC output of N channels over the
// pixels of B frames of H x W:
//   acc[p, n] = sum over taps (ky, kx) of a ksize x ksize window (zero
//               outside the frame) and over the channels c of the input,
//               x[p + (ky - k/2, kx - k/2), c] * w[tap, c, n]
// where the input x is the concatenation along channels of up to four
// segments, each read from its own pointer with its own strides (NCHW or
// NHWC), so that nothing is concatenated in memory. Then one epilogue:
//   bias       out = acc + b
//   bias_relu  out = max(acc + b, 0)
//   gru_zr     (N = 2D, over cat(h, x)) z = sigmoid(acc + b)[:, :D] -> out,
//              r = sigmoid(acc + b)[:, D:], r * h -> out2
//   gru_q      (N = D, over cat(r * h, x)) q = tanh(acc + b),
//              h' = (1 - z) * h + z * q -> out
// The ConvGRU step is the two gate launches; the q convolution needs r * h
// over its 3x3 halo, so r * h goes through memory between them.
//
// Launches per GRU iteration of RAFT-small (models/update.py::
// SmallUpdateBlock): 8 (the motion encoder's four convolutions, the two gate
// launches, the flow head's two convolutions).
//
// Bound on the card: operations. At the batch-16 Sintel serving shape (M =
// 16 x 55 x 128 = 112,640 pixels) an iteration's convolutions are 197 GFLOP
// (z|r 94.2, q 47.1, the flow head 25.4, the motion encoder 30.6), against
// about 0.2 GB of activations: 1.19 ms at the fp32-accurate three-pass TF32
// rate (495 / 3 TFLOP/s), 2.94 ms at the fp32 CUDA-core rate (67 TFLOP/s).
//
// Design.
//   - GEMM view: rows are pixels, columns the N output channels, K runs over
//     taps x input channels. A block owns 128 consecutive pixels (in (b, y,
//     x) order: a run along a row) by the full width N, padded to a tile
//     width BN of {8, 16, 32, 64, 80, 96, 128, 192}; 8 warps split the tile
//     WM x WN ways.
//   - K is a sequence of groups of 8 channels, one mma k-step each: for each
//     tap, each segment's channels in groups of 8, its last group masked (X
//     = 146 and Cin = 242 are no multiples of 16; the flow's 2 channels take
//     one group). The weights come laid out in that order, [groups x 8,
//     ldb_of(BN)], zero where a group is masked or a column lies past N
//     (small_update.py::ConvWeights).
//   - A stage is 4 groups (K = 32): a 128 x 32 tile of the input and a 32 x
//     BN tile of the weights, in a ring of 4 stages, three in flight while
//     one is multiplied. The weights of a stage lie contiguous in memory,
//     already padded to the shared tile's row stride, so one thread copies
//     them with one bulk copy (TMA), completion on an mbarrier per slot.
//     Each input load is a cp.async of 4 channels of one pixel at the tap's
//     offset (16 bytes, or 4 scalar copies for an NCHW segment or one whose
//     channels are no multiple of 4); the frame's edge and the masked
//     channels are zero-filled by the copy itself (src-size 0), so no halo
//     is staged and no branch guards the products.
//   - Load instructions. The kernel is bound by each block's own latency
//     (one block an SM at the wide tiles), so what a thread issues a stage
//     counts: each group's segment, tap offset and element offset are worked
//     out once per block into a table in shared memory (no division a stage),
//     each thread's pixel once per segment, and the weights take one
//     instruction a stage instead of one cp.async per 16 bytes.
//   - Products: fp32-accurate on the tensor cores, mma.sync m16n8k8 in TF32
//     as three passes on hi/lo parts (a_lo * b_hi + a_hi * b_lo + a_hi *
//     b_hi), the scheme of K4's and K5's fp32 routes (csrc/corr_ondemand.cu).
//     Operands are split when their fragments are read from shared memory;
//     the shared tiles are padded so that those reads are free of bank
//     conflicts.
//   - Sums. The tensor cores add into their accumulator with truncation, so
//     a chain of mma over the whole K (837 at z|r) drifts toward zero: 1.5e-5
//     of the largest output off a float64 convolution, 23x cuDNN's fp32 (at
//     the serving shape, NVIDIA H100 80GB HBM3). So each k-step's three
//     passes start from zero, and their 8-term sum is added to an fp32
//     register accumulator with an IEEE (round-to-nearest) add.
//   - Epilogue from the accumulators in registers: bias, then ReLU or the
//     gate arithmetic, the GRU state h read at the pixel's own channels.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// One input segment (or the GRU state): element (b, y, x, c) at
// ptr + b sb + y sh + x sw + c sc. vec: 16-byte copies of 4 channels (sc = 1,
// c, sb, sh, sw multiples of 4, ptr 16-byte aligned).
struct K9Seg {
  const float* ptr;
  int64_t sb, sh, sw, sc;
  int32_t c, vec;
};

struct K9Args {
  K9Seg seg[4];
  K9Seg h;             // the GRU state (gru_zr, gru_q)
  const float* w;      // [steps x 32, ldb_of(bn)]: the K groups in order, zero padded
  const float* bias;   // [n]
  float* out;          // [M, n] (gru_zr: z [M, n / 2])
  float* out2;         // gru_zr: r * h [M, n / 2]
  const float* z;      // gru_q: z [M, n]
  int32_t nseg, B, H, W, N, ksize, epilogue, bn;
  int32_t gpt;         // K groups a tap
  int32_t gstart[5];   // first group of each segment within a tap
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBM = 128;          // output pixels a block: a thread pair loads each
constexpr int kGroup = 8;         // channels of a K group: one mma k-step
constexpr int kGroupsPerStage = 4;
constexpr int kBK = kGroupsPerStage * kGroup;  // K a stage: small_update.py::STAGE_ROWS
constexpr int kStages = 4;        // ring of stages in shared memory
constexpr int kLdA = kBK + 4;     // input tile row: fragment reads conflict-free
constexpr int kMaxSegs = 4;
constexpr int kMaxGroups = 512;   // K groups of a launch: small_update.py::MAX_GROUPS

enum Epilogue : int { kBias = 0, kBiasRelu = 1, kGruZR = 2, kGruQ = 3 };

// weight tile row: row stride = 8 or 24 (mod 32) floats, so that a warp's
// fragment reads (rows t, t + 4, columns g) hit 32 distinct banks
__host__ __device__ constexpr int ldb_of(int bn) {
  return (bn % 32 == 8 || bn % 32 == 24) ? bn : bn + (40 - bn % 32) % 32;
}

__host__ __device__ constexpr size_t smem_bytes(int bn) {
  return (size_t)kStages * (kBM * kLdA + kBK * ldb_of(bn)) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, of which the first `bytes` (0 or 16) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// 4 bytes, read (bytes = 4) or zero-filled (bytes = 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups landed
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// d += A (16 x 8, TF32, row-major) x B (8 x 8, TF32, col-major), fp32. A
// fragment: a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4); B: b0 (k t, n g), b1 (t + 4, g); D: d[0] (g, 2t), d[1] (g, 2t + 1),
// d[2] (g + 8, 2t), d[3] (g + 8, 2t + 1); lane = 4 g + t.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as two TF32 parts (bit patterns): hi = v rounded to TF32's 11
// significant bits (to nearest, ties away), lo = v - hi (exact in fp32),
// whose low 13 bits the mma ignores; v - hi - lo as the mma reads them is
// below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

template <int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 1) small_update_conv_kernel(const K9Args a) {
  constexpr int MT = kBM / (16 * WM);  // 16-row mma tiles a warp
  constexpr int NT = BN / (8 * WN);    // 8-column mma tiles a warp
  constexpr int LDB = ldb_of(BN);
  static_assert(WM * WN == kThreads / 32 && kThreads == 2 * kBM, "8 warps, 2 threads a pixel");
  static_assert(MT * 16 * WM == kBM && NT * 8 * WN == BN, "the warps tile the block");
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                         // [kStages][kBM][kLdA]
  float* const Bs = smem + kStages * kBM * kLdA;  // [kStages][kBK][LDB]
  __shared__ K9Seg segs[kMaxSegs];
  __shared__ int gstart[kMaxSegs + 1];

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMaxSegs; ++i) {
      segs[i] = a.seg[i];
      gstart[i] = a.gstart[i];
    }
    gstart[kMaxSegs] = a.gstart[kMaxSegs];
  }
  const int H = a.H, W = a.W, HW = H * W;
  const int64_t M = (int64_t)a.B * HW;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  // the input loads: thread pairs own a pixel each, a thread 4 of the 8
  // channels of each group of the stage
  const int lm = tid >> 1, lq = tid & 1;
  const int64_t lp = m0 + lm;
  const bool lvalid = lp < M;
  int lb = 0, ly = 0, lx = 0;
  if (lvalid) {
    lb = (int)(lp / HW);
    const int r = (int)(lp - (int64_t)lb * HW);
    ly = r / W;
    lx = r - ly * W;
  }
  const int ks = a.ksize, pad = ks >> 1;
  const int ngroups = ks * ks * a.gpt;
  const int nsteps = (ngroups + kGroupsPerStage - 1) / kGroupsPerStage;
  float* const a_dst = As + lm * kLdA + 4 * lq;
  __shared__ int64_t gtab_off[kMaxGroups];
  __shared__ int gtab_meta[kMaxGroups];
  __shared__ __align__(8) uint64_t wbar[kStages];
  const uint32_t wbar0 = smem_u32(wbar);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(wbar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // segs, gstart, the barriers
  // Each K group's place, once per block: its segment, its tap's offset
  // (dy, dx), the segment's channels from the group's first on, and the
  // element offset of all that from a pixel's first channel (the same for
  // every pixel). The padding groups of the last stage have no channels.
  for (int grp = tid; grp < nsteps * kGroupsPerStage; grp += kThreads) {
    int64_t off = 0;
    int meta = 3 << 2 | 3 << 5;  // segment 0, dy = dx = 0, no channels
    if (grp < ngroups) {
      const int tap = grp / a.gpt, r = grp - tap * a.gpt;
      int si = 0;
      for (int q = 1; q < a.nseg; ++q) si += r >= gstart[q];
      const int c0 = kGroup * (r - gstart[si]);
      const int ky = tap / ks, dy = ky - pad, dx = tap - ky * ks - pad;
      const K9Seg& sg = segs[si];
      off = dy * sg.sh + dx * sg.sw + c0 * sg.sc;
      meta = si | (dy + 3) << 2 | (dx + 3) << 5 | (sg.c - c0) << 8;
    }
    gtab_off[grp] = off;
    gtab_meta[grp] = meta;
  }
  // this thread's pixel and 4 channels in each segment; which segments take
  // 16-byte copies
  const float* pix[kMaxSegs];
  int vecmask = 0;
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) {
    const K9Seg& sg = segs[q];
    pix[q] = sg.ptr + lb * sg.sb + ly * sg.sh + lx * sg.sw + 4 * lq * sg.sc;
    vecmask |= sg.vec << q;
  }
  __syncthreads();  // the group table

  auto load_stage = [&](int s) {
    const int slot = s % kStages;
#pragma unroll
    for (int j = 0; j < kGroupsPerStage; ++j) {
      const int grp = kGroupsPerStage * s + j;
      const uint32_t dst = smem_u32(a_dst + slot * (kBM * kLdA) + kGroup * j);
      const int meta = gtab_meta[grp];
      const int si = meta & 3;
      const int yy = ly + ((meta >> 2) & 7) - 3, xx = lx + ((meta >> 5) & 7) - 3;
      const bool inb = lvalid && (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
      const int cleft = inb ? (meta >> 8) - 4 * lq : 0;  // channels from this thread's first
      const float* base = pix[0];
#pragma unroll
      for (int q = 1; q < kMaxSegs; ++q)
        if (si == q) base = pix[q];
      const float* const src = cleft > 0 ? base + gtab_off[grp] : segs[0].ptr;
      if ((vecmask >> si) & 1) {
        cp_async16(dst, src, cleft > 0 ? 16 : 0);
      } else {
        const int64_t sc = segs[si].sc;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, e < cleft ? src + e * sc : segs[0].ptr, e < cleft ? 4 : 0);
      }
    }
    // the stage's weights: kBK rows of LDB floats, contiguous in memory
    const float* const wsrc = a.w + (size_t)s * kBK * LDB;
    float* const bdst = Bs + slot * (kBK * LDB);
    if (tid == 0) {
      const uint32_t bar = wbar0 + 8 * slot;
      mbar_expect_tx(bar, kBK * LDB * 4);
      bulk_load(smem_u32(bdst), wsrc, kBK * LDB * 4, bar);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();  // stage s's inputs landed (this thread's copies)
    mbar_wait(wbar0 + 8 * (s % kStages), (s / kStages) & 1);  // its weights
    __syncthreads();               // ... and everyone's; slot (s - 1) % kStages is free
    if (s + kStages - 1 < nsteps) load_stage(s + kStages - 1);
    cp_async_commit();
    const int slot = s % kStages;
    const float* const as = As + slot * (kBM * kLdA) + (wm * MT * 16 + g) * kLdA + t;
    const float* const bs = Bs + slot * (kBK * LDB) + t * LDB + wn * NT * 8 + g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        split_tf32(bs[kk * LDB + ni * 8], bh[ni][0], bl[ni][0]);
        split_tf32(bs[(kk + 4) * LDB + ni * 8], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* const ap = as + mi * 16 * kLdA + kk;
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * kLdA], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * kLdA + 4], ah[3], al[3]);
        // the k-step's 8-term sums from zero on the tensor cores, each pass
        // over the NT tiles in a row (independent products back to back),
        // then one IEEE add each into the fp32 accumulators (see the note
        // at the top)
        float d[NT][4];
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[ni][e] = 0.0f;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(d[ni], al, bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(d[ni], ah, bl[ni][0], bl[ni][1]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(d[ni], ah, bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[ni][e];
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: row g (+ 8) of each 16-row tile, columns 2t, 2t + 1 of each
  // 8-column tile
  const int N = a.N, epi = a.epilogue;
  const int D = epi == kGruZR ? N / 2 : N;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int64_t p = m0 + wm * MT * 16 + mi * 16 + g + 8 * hf;
      if (p >= M) continue;
      const float* hp = nullptr;  // the GRU state at pixel p
      if (epi >= kGruZR) {
        const int b = (int)(p / HW);
        const int r = (int)(p - (int64_t)b * HW);
        const int y = r / W;
        hp = a.h.ptr + b * a.h.sb + y * a.h.sh + (r - y * W) * a.h.sw;
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn * NT * 8 + ni * 8 + 2 * t + e;
          if (n >= N) continue;
          const float v = acc[mi][ni][2 * hf + e] + a.bias[n];
          if (epi == kBias) {
            a.out[p * N + n] = v;
          } else if (epi == kBiasRelu) {
            a.out[p * N + n] = v < 0.0f ? 0.0f : v;  // NaN stays NaN, as torch's relu
          } else if (epi == kGruZR) {
            const float s = sigmoid(v);
            if (n < D) a.out[p * D + n] = s;
            else a.out2[p * D + (n - D)] = __fmul_rn(s, hp[(n - D) * a.h.sc]);
          } else {
            const float q = tanhf(v);
            const float zv = a.z[p * N + n];
            const float hv = hp[n * a.h.sc];
            a.out[p * N + n] = __fadd_rn(__fmul_rn(1.0f - zv, hv), __fmul_rn(zv, q));
          }
        }
      }
    }
  }
}

template <int BN, int WM, int WN>
cudaError_t launch(const K9Args& a, cudaStream_t stream) {
  const auto kernel = small_update_conv_kernel<BN, WM, WN>;
  const size_t smem = smem_bytes(BN);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t M = (int64_t)a.B * a.H * a.W;
  kernel<<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One K9 launch; the wrapper (kernels/small_update.py) has checked the
// arguments. Returns a cudaError_t.
extern "C" int raft_small_update_conv(const K9Args* args, void* stream) {
  const K9Args& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = a.ksize * a.ksize * a.gpt;
  if (a.nseg < 1 || a.nseg > kMaxSegs || a.epilogue < kBias || a.epilogue > kGruQ ||
      a.N < 1 || a.N > a.bn ||
      (groups + kGroupsPerStage - 1) / kGroupsPerStage * kGroupsPerStage > kMaxGroups)
    return cudaErrorInvalidValue;
  switch (a.bn) {  // the tile widths of small_update.py::TILE_WIDTHS
    case 8: return launch<8, 8, 1>(a, st);
    case 16: return launch<16, 8, 1>(a, st);
    case 32: return launch<32, 4, 2>(a, st);
    case 64: return launch<64, 4, 2>(a, st);
    case 80: return launch<80, 4, 2>(a, st);
    case 96: return launch<96, 4, 2>(a, st);
    case 128: return launch<128, 2, 4>(a, st);
    case 192: return launch<192, 2, 4>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

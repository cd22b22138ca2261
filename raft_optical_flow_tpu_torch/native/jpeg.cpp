// JPEG decoder for the port's frame reader (data/frame_utils.py::
// decode_jpeg). Its output is what `np.array(PIL.Image.open(path))` gives,
// bit for bit: PIL decodes through libjpeg(-turbo) at libjpeg's default
// decompress parameters, and each stage here follows that library's code
// for those parameters:
//
//   entropy decoding  Huffman (jdhuff.c, jdphuff.c) and arithmetic coding
//                     (jdarith.c: the QM decoder and jaricom.c's Qe table,
//                     the DC and AC statistics bins, DAC conditioning and
//                     its defaults L = 0, U = 1, K = 5), sequential (SOF0,
//                     SOF1, SOF9) and progressive (SOF2, SOF10: spectral
//                     selection and successive approximation, DC and AC,
//                     first and refinement scans, EOB runs), restart
//                     intervals (DRI, RST0-7: the DC predictors, the EOB
//                     run and the arithmetic statistics reset). Every
//                     coefficient is kept until the last scan, as libjpeg's
//                     buffered coefficient controller keeps them.
//   lossless          SOF3, 8-bit (jdlhuff.c, jddiffct.c, jdlossls.c):
//                     Huffman-coded differences, predictors 1-7, the
//                     initial predictor 2^(P - Pt - 1) at the first row and
//                     after each restart (restarts fall on MCU rows), the
//                     point transform at the output.
//   block smoothing   jdcoefct.c::decompress_smooth_data (libjpeg-turbo 2.1
//                     and later): a progressive file whose scans leave one
//                     of the first ten coefficients of a component short of
//                     full precision (smoothing_ok) gets estimates of its
//                     zero low coefficients from the 5x5 DC neighbourhood
//                     of each block (and of the DC itself when no AC
//                     coefficient was coded), before the IDCT.
//   dequantize, IDCT  JDCT_ISLOW (jidctint.c::jpeg_idct_islow): its
//                     constants, its DESCALE, and its output range-limit
//                     table indexed with `& RANGE_MASK`
//                     (jdmaster.c::prepare_range_limit_table), so values far
//                     out of range wrap as the table wraps them. Each
//                     component's quantization table is latched when the
//                     component's first scan starts, as jdinput.c latches it.
//   upsampling        "fancy" upsampling (jdsample.c): h2v1_fancy_upsample
//                     and h2v2_fancy_upsample (3/4-1/4 triangles with the
//                     +1/+2 and +8/+7 biases) when the downsampled width is
//                     over 2, else box replication; h1v2_fancy_upsample for
//                     4:4:0; int_upsample (box replication) for other integer
//                     factors such as 4:1:1, and for lossless frames (fancy
//                     upsampling needs DCT blocks). Rows above the first and
//                     below the last are the edge rows (jdmainct.c's context
//                     pointers), columns likewise. The merged upsampler
//                     (jdmerge.c) is not used when fancy upsampling is on.
//   colour            jdcolor.c::ycc_rgb_convert (its FIX() tables and
//                     ONE_HALF rounding) for YCbCr; RGB, grey and CMYK pass
//                     through; ycck_cmyk_convert for YCCK. The colour space
//                     follows jdapimin.c::default_decompress_parms: JFIF
//                     (APP0) means YCbCr, else the Adobe (APP14) transform
//                     flag, else the component IDs ('R','G','B' means RGB);
//                     four components are CMYK unless the Adobe flag is 2
//                     (YCCK). CMYK and YCCK come out inverted, as PIL reads
//                     them ("CMYK;I", Adobe polarity).
//
// Raised as Unsupported (NotImplementedError in Python), naming the marker
// or the feature; PIL does not decode any of them: lossless arithmetic
// coding (SOF11), hierarchical files (SOF5-SOF7, SOF13-SOF15), precisions
// other than 8 bits (PIL opens 8-bit frames only), frames of other than 1,
// 3 or 4 components, non-integer sampling ratios. Raised as Corrupt
// (ValueError): a truncated stream (Huffman-coded data that runs past its
// segment, or no EOI), a bad marker segment, a Huffman code that no table
// holds, a missing table.
//
// Exposed C ABI (see raft_optical_flow_tpu_torch/data/native.py):
//   jpeg_decode(data, size, out, capacity, dims, err, errlen)
//       out == NULL: parse the markers up to the first SOS and write
//       dims = {height, width, channels}; else decode into out (height x
//       width x channels uint8, capacity bytes). Returns 0, 1 (unsupported),
//       2 (corrupt or truncated) or 3 (out too small); err gets a message.
//   jpeg_idct_blocks(coef, qtable, nblocks, out) - dequantize and IDCT
//       nblocks 8x8 int16 blocks (natural order) into 8x8 uint8 blocks.
//   jpeg_upsample(in, ds_h, ds_w, hexp, vexp, out) - one plane upsampled by
//       (hexp, vexp) as the decoder does it; out is (ds_h*vexp, ds_w*hexp).
//   jpeg_ycc_rgb(y, cb, cr, n, out) - n pixels YCbCr -> RGB (n x 3).
//   jpeg_ycck_cmyk(y, cb, cr, k, n, out) - n pixels YCCK -> CMYK (n x 4),
//       before PIL's inversion.
//   jpeg_smooth_blocks(coef, dc, qtable, bits, nblocks, out) - the block
//       smoothing estimate of nblocks blocks (64 int16 each, natural order)
//       from each one's 5x5 DC window (25 int32, row by row) and the
//       component's coef_bits[0..9].
//   jpeg_undifference_row(diff, prev, width, psv, initial, out) - one
//       lossless row's samples (uint16) from its differences; prev NULL
//       for a first row (1-D from `initial`).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index; 16 extra entries absorb runs
// that pass the last coefficient in a corrupt block (as libjpeg's table does)
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Unsupported {
  std::string what;
};
struct Corrupt {
  std::string what;
};

[[noreturn]] void corrupt(const std::string& what) { throw Corrupt{what}; }
[[noreturn]] void unsupported(const std::string& what) { throw Unsupported{what}; }

// -- IDCT: jidctint.c::jpeg_idct_islow ----------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;
constexpr int kRangeMask = 1023;  // MAXJSAMPLE * 4 + 3

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range-limit table (prepare_range_limit_table from
// sample_range_limit + CENTERJSAMPLE): index x & 1023 of a centred sample x.
struct IdctRange {
  uint8_t t[1024];
  IdctRange() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const IdctRange kIdctRange;

// One 8x8 block: coefficients in natural order, dequantized by q.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      const int dc = static_cast<int>(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  const uint8_t* lim = kIdctRange.t;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      const uint8_t v = lim[descale(wp[0], kPass1Bits + 3) & kRangeMask];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = lim[descale(tmp10 + tmp3, s) & kRangeMask];
    op[7] = lim[descale(tmp10 - tmp3, s) & kRangeMask];
    op[1] = lim[descale(tmp11 + tmp2, s) & kRangeMask];
    op[6] = lim[descale(tmp11 - tmp2, s) & kRangeMask];
    op[2] = lim[descale(tmp12 + tmp1, s) & kRangeMask];
    op[5] = lim[descale(tmp12 - tmp1, s) & kRangeMask];
    op[3] = lim[descale(tmp13 + tmp0, s) & kRangeMask];
    op[4] = lim[descale(tmp13 - tmp0, s) & kRangeMask];
  }
}

// -- upsampling: jdsample.c ---------------------------------------------------

// One plane of ds_h x ds_w samples (row stride in_stride) upsampled by
// (hexp, vexp) into out, (ds_h * vexp) x (ds_w * hexp), row stride out_stride.
void upsample(const uint8_t* in, int64_t in_stride, int ds_h, int ds_w, int hexp, int vexp,
              bool fancy, uint8_t* out, int64_t out_stride) {
  auto row = [&](int r) { return in + int64_t(std::min(std::max(r, 0), ds_h - 1)) * in_stride; };
  if (fancy && hexp == 2 && vexp == 1 && ds_w > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < ds_h; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = out + y * out_stride;
      op[0] = ip[0];
      op[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < ds_w - 1; ++x) {
        const int v = ip[x] * 3;
        op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
      }
      const int l = ds_w - 1;
      op[2 * l] = static_cast<uint8_t>((ip[l] * 3 + ip[l - 1] + 1) >> 2);
      op[2 * l + 1] = ip[l];
    }
  } else if (fancy && hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < ds_h; ++y) {
      for (int v = 0; v < 2; ++v) {
        const uint8_t* near = row(y);
        const uint8_t* far = row(v == 0 ? y - 1 : y + 1);
        const int bias = v == 0 ? 1 : 2;
        uint8_t* op = out + (2 * y + v) * out_stride;
        for (int x = 0; x < ds_w; ++x)
          op[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
    }
  } else if (fancy && hexp == 2 && vexp == 2 && ds_w > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < ds_h; ++y) {
      for (int v = 0; v < 2; ++v) {
        const uint8_t* near = row(y);
        const uint8_t* far = row(v == 0 ? y - 1 : y + 1);
        uint8_t* op = out + (2 * y + v) * out_stride;
        int this_sum = near[0] * 3 + far[0];
        int next_sum = near[1] * 3 + far[1];
        op[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        op[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < ds_w - 1; ++x) {
          next_sum = near[x + 1] * 3 + far[x + 1];
          op[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          op[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        const int l = ds_w - 1;
        op[2 * l] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        op[2 * l + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      }
    }
  } else {  // fullsize, h2v1_upsample, h2v2_upsample, int_upsample: replication
    for (int y = 0; y < ds_h; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = out + int64_t(y) * vexp * out_stride;
      for (int x = 0; x < ds_w; ++x)
        for (int k = 0; k < hexp; ++k) op[x * hexp + k] = ip[x];
      for (int v = 1; v < vexp; ++v) std::memcpy(op + v * out_stride, op, size_t(ds_w) * hexp);
    }
  }
}

// -- colour: jdcolor.c::build_ycc_rgb_table, ycc_rgb_convert ---------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (int64_t(1) << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline void ycc_pixel(int y, int cb, int cr, uint8_t* op) {
  op[0] = clamp255(y + kYcc.cr_r[cr]);
  op[1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
  op[2] = clamp255(y + kYcc.cb_b[cb]);
}

// -- Huffman tables and the bit reader ------------------------------------------

struct Huffman {
  bool defined = false;
  int max_val = 0;     // the largest symbol (DC tables: checked at the scan)
  uint16_t look[512];  // 9-bit prefix -> (length << 8) | symbol, 0 if the code is longer
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// JPEG Annex C (jdhuff.c::jpeg_make_d_derived_tbl)
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(t.look, 0, sizeof(t.look));
  std::memcpy(t.vals, vals, size_t(nvals));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      // a code must fit in len bits and not be all ones (jdhuff.c), which
      // also keeps the lookup index below 512
      if (code >= (int32_t(1) << len) - 1) corrupt("bad Huffman table (code lengths overflow)");
      if (len <= 9) {
        const int shift = 9 - len;
        for (int p = 0; p < (1 << shift); ++p)
          t.look[(code << shift) | p] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.max_val = 0;
  for (int i = 0; i < nvals; ++i) t.max_val = std::max<int>(t.max_val, vals[i]);
  t.defined = true;
}

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;   // bits held in buf (left-aligned)
  int zeros = 0;  // of those, the zero bits appended at a marker or the end
  bool stop = false;

  void start(size_t p) {
    pos = p;
    buf = 0;
    bits = zeros = 0;
    stop = false;
  }
  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!stop) {
        if (pos >= n) {
          stop = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else if (pos + 1 < n && d[pos + 1] == 0) {  // stuffed 0xFF
          b = 0xFF;
          pos += 2;
        } else {
          stop = true;  // a marker: the segment ends here
        }
      }
      if (stop) zeros += 8;
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  void skip(int k) {
    buf <<= k;
    bits -= k;
    if (bits < zeros) corrupt("entropy-coded data ends early (truncated or corrupt)");
  }
  uint32_t get(int k) {  // 0 <= k <= 16
    if (k == 0) return 0;
    if (bits < k) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - k));
    skip(k);
    return v;
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    const int v = static_cast<int>(get(s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int decode(const Huffman& t) {
    if (bits < 16) fill();
    const uint16_t e = t.look[buf >> 55];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(buf >> (64 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[(code + t.valoffset[len]) & 0xFF];
      }
    }
    corrupt("Huffman code not in its table");
  }
};

// -- the arithmetic decoder: jdarith.c, jaricom.c --------------------------------

// ITU-T T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is libjpeg's fixed
// probability state (sign and refinement bits).
#define QE(qe, lps, mps, sw) ((int32_t(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
constexpr int32_t kAritab[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

constexpr int kDcStatBins = 64, kAcStatBins = 256;

// The QM decoder of one entropy-coded segment (jdarith.c::arith_decode):
// bytes past a marker, or past the end, read as zeros, as libjpeg supplies
// them (hitting a marker is legal in arithmetic coding).
struct ArithReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;          // -16: two initial bytes to read; -1: a bad code, stop
  bool at_marker = false;

  void start(size_t p) {
    pos = p;
    c = a = 0;
    ct = -16;
    at_marker = false;
  }
  int byte() {
    if (at_marker || pos >= n) {
      at_marker = true;
      return 0;
    }
    if (d[pos] != 0xFF) return d[pos++];
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) ++q;  // fill bytes
    if (q < n && d[q] == 0) {           // stuffed zero
      pos = q + 1;
      return 0xFF;
    }
    at_marker = true;  // pos stays on the marker for the next marker search
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and data input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes: a becomes 0x10000 below
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;  // decode and estimation, D.2.4 and D.2.5
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// -- the decoder ------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;  // downsampled size (jdinput.c::initial_setup)
  int bw = 0, bh = 0;      // blocks holding samples: ceil(ds / 8) (lossless: ds)
  int abw = 0;             // blocks allocated per row (whole MCUs)
  std::vector<int16_t> coef;   // DCT: (mcuy * v) x abw blocks of 64
  std::vector<uint16_t> samp;  // lossless: the un-differenced samples, ds_h x ds_w
  int pt = 0;                  // lossless: the point transform of its scan
  bool first_row = true;       // lossless: the next row takes the 1-D predictor
  uint16_t q[64];
  bool q_latched = false;
  int dc_pred = 0;
  int coef_bits[10];  // progressive: the Al of the last scan that coded each (-1 never)
};

struct ScanComp {
  Component* c;
  int td, ta;
  int dc_context;  // arithmetic coding: the DC conditioning category
};

// The statistics of an arithmetic-coded scan (jdarith.c::start_pass).
struct ArithStats {
  uint8_t dc[16][kDcStatBins];
  uint8_t ac[16][kAcStatBins];
  uint8_t fixed_bin = 113;  // the fixed-probability state: signs, refinement bits
};

enum class Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

// jdcoefct.c::decompress_smooth_data (libjpeg-turbo 2.1 and later) for one
// block: ws holds its coefficients (natural order), dc the 5x5 DC values
// around it (row by row, dc[12] its own), q its quantization table, bits
// coef_bits[0..9]. A coefficient still zero and not known to full precision
// (bits != 0) gets an estimate from the DC values; when no AC coefficient
// was coded at all (bits[1..9] all -1) the window is a Gaussian-like one
// over all 25 and the DC is re-estimated too, else the 5x5 cross.
void smooth_block(int16_t* ws, const int* dc, const uint16_t* q, const int* bits) {
  // natural position, and weights on DC01..DC25 with and without DC interpolation
  struct Estimate {
    int pos;
    int8_t w_interp[25];
    int8_t w[25];
  };
  static const Estimate kEst[9] = {
      {1,  // AC01
       {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
       {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
      {8,  // AC10
       {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
       {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0}},
      {16,  // AC20
       {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
       {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0}},
      {9,  // AC11
       {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
       {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0}},
      {2,  // AC02
       {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
       {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
      {3,  // AC03 (with DC interpolation only)
       {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
       {}},
      {10,  // AC12
       {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
       {}},
      {17,  // AC21
       {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
       {}},
      {24,  // AC30
       {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0},
       {}}};
  static const int16_t kDcInterp[25] = {-2, -6, -8,  -6, -2, -6, 6,  42, 6,  -6, -8, 42, 152,
                                        42, -8, -6, 6, 42, 6,  -6, -2, -6, -8, -6, -2};
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t q00 = q[0];
  for (int e = 0; e < (change_dc ? 9 : 5); ++e) {
    const Estimate& est = kEst[e];
    const int al = bits[e + 1];
    if (al == 0 || ws[est.pos] != 0) continue;
    int64_t sum = 0;
    for (int i = 0; i < 25; ++i) sum += int64_t(change_dc ? est.w_interp[i] : est.w[i]) * dc[i];
    const int64_t num = q00 * sum, qk = q[est.pos];
    int64_t pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
    if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
    ws[est.pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
  }
  if (change_dc) {
    int64_t sum = 0;
    for (int i = 0; i < 25; ++i) sum += int64_t(kDcInterp[i]) * dc[i];
    const int64_t num = q00 * sum;
    const int64_t pred = ((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8);
    ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
  }
}

// jdcolor.c::ycck_cmyk_convert: YCbCr -> RGB, inverted to CMY; K passes.
inline void ycck_pixel(int y, int cb, int cr, int k, uint8_t* op) {
  ycc_pixel(y, cb, cr, op);
  op[0] = static_cast<uint8_t>(255 - op[0]);
  op[1] = static_cast<uint8_t>(255 - op[1]);
  op[2] = static_cast<uint8_t>(255 - op[2]);
  op[3] = static_cast<uint8_t>(k);
}

// jdlossls.c's un-differencing of one row of width samples: diff plus the
// prediction, modulo 2^16. prev == nullptr: the first row of the scan or of
// a restart interval (1-D: the initial predictor, then the left sample);
// else predictor psv (1-7) with the sample above for the first column.
void undifference_row(const int32_t* diff, const uint16_t* prev, int width, int psv,
                      int initial, uint16_t* out) {
  if (prev == nullptr) {
    int ra = (diff[0] + initial) & 0xFFFF;
    out[0] = static_cast<uint16_t>(ra);
    for (int x = 1; x < width; ++x) {
      ra = (diff[x] + ra) & 0xFFFF;
      out[x] = static_cast<uint16_t>(ra);
    }
    return;
  }
  int64_t rb = prev[0];
  int64_t ra = (diff[0] + rb) & 0xFFFF;
  out[0] = static_cast<uint16_t>(ra);
  for (int x = 1; x < width; ++x) {
    const int64_t rc = rb;
    rb = prev[x];
    int64_t pred;
    switch (psv) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;
    }
    ra = (diff[x] + pred) & 0xFFFF;
    out[x] = static_cast<uint16_t>(ra);
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {
    // jdmarker.c::get_soi: the arithmetic conditioning defaults
    std::fill(dac_l_, dac_l_ + 16, 0);
    std::fill(dac_u_, dac_u_ + 16, 1);
    std::fill(dac_k_, dac_k_ + 16, 5);
  }

  // Parses markers up to the first SOS (header_only) or to EOI.
  void run(bool header_only) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) {  // EOI
        if (!have_frame_ || scans_ == 0) corrupt("EOI before any scan");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn outside a scan
      if (m == 0x01) continue;               // TEM
      if (m == 0xD8) corrupt("SOI inside the image");
      const int len = u16(pos_);
      if (len < 2 || pos_ + len > n_) corrupt("marker segment runs past the end");
      const size_t body = pos_ + 2, end = pos_ + len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          sof(m, body, end);
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
          unsupported(marker_name(m) + " (hierarchical JPEG)");
        case 0xCB:
          unsupported("SOF11 (lossless arithmetic coding)");
        case 0xCD:
        case 0xCE:
        case 0xCF:
          unsupported(marker_name(m) + " (hierarchical arithmetic coding)");
        case 0xC4:
          dht(body, end);
          break;
        case 0xCC:
          dac(body, end);
          break;
        case 0xDB:
          dqt(body, end);
          break;
        case 0xDD:
          if (len != 4) corrupt("bad DRI length");
          restart_interval_ = u16(body);
          break;
        case 0xE0:
          if (end - body >= 14 && std::memcmp(d_ + body, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xEE:
          if (end - body >= 12 && std::memcmp(d_ + body, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = d_[body + 11];
          }
          break;
        case 0xDA:
          if (!have_frame_) corrupt("SOS before SOF");
          if (scans_ == 0) decide_space();
          if (header_only) return;
          if (comps_[0].coef.empty() && comps_[0].samp.empty()) allocate();
          sos(body, end);
          continue;  // pos_ is past the scan's entropy-coded data
        default:  // other APPn, COM, DNL, JPGn: skipped
          break;
      }
      pos_ = end;
    }
  }

  void finish(uint8_t* out) const;

  int height() const { return height_; }
  int width() const { return width_; }
  int channels() const { return static_cast<int>(comps_.size()); }

 private:
  int u16(size_t p) const {
    if (p + 2 > n_) corrupt("marker segment runs past the end");
    return (d_[p] << 8) | d_[p + 1];
  }

  static std::string marker_name(int m) {
    char buf[16];
    std::snprintf(buf, sizeof(buf), "SOF%d", m - 0xC0);
    return buf;
  }

  // libjpeg's next_marker: skip anything that is not 0xFF, then fill bytes.
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) corrupt("file ends before EOI (truncated)");
      const int m = d_[pos_++];
      if (m != 0) return m;  // FF 00 outside a scan is junk
    }
  }

  void sof(int m, size_t p, size_t end) {
    if (have_frame_) corrupt("two SOF markers");
    if (end - p < 6) corrupt("SOF segment too short");
    lossless_ = m == 0xC3;
    arith_ = m == 0xC9 || m == 0xCA;
    progressive_ = m == 0xC2 || m == 0xCA;
    const int precision = d_[p];
    // PIL opens 8-bit frames only; libjpeg also takes 12 and 16 bits, and
    // 2 to 16 in lossless mode
    if (precision != 8 && (precision == 12 || precision == 16 ||
                           (lossless_ && precision >= 2 && precision <= 16)))
      unsupported(std::to_string(precision) + "-bit precision (" + marker_name(m) + ")");
    if (precision != 8) corrupt("bad sample precision " + std::to_string(precision));
    height_ = u16(p + 1);
    width_ = u16(p + 3);
    const int nc = d_[p + 5];
    if (height_ == 0 || width_ == 0) corrupt("empty image (or a DNL height, not supported)");
    if (nc != 1 && nc != 3 && nc != 4)
      unsupported(std::to_string(nc) + "-component JPEG (1, 3 or 4 are decoded)");
    if (end - p != size_t(6 + 3 * nc)) corrupt("bad SOF length");
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = d_[p + 6 + 3 * i];
      c.h = d_[p + 7 + 3 * i] >> 4;
      c.v = d_[p + 7 + 3 * i] & 15;
      c.tq = d_[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad SOF component");
      for (int j = 0; j < i; ++j)
        if (comps_[j].id == c.id) corrupt("duplicate component id");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    const int bs = lossless_ ? 1 : 8;  // a lossless "block" is one sample
    mcux_ = (width_ + bs * hmax_ - 1) / (bs * hmax_);
    mcuy_ = (height_ + bs * vmax_ - 1) / (bs * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        unsupported("non-integer sampling ratio " + std::to_string(hmax_) + "/" +
                    std::to_string(c.h) + " x " + std::to_string(vmax_) + "/" +
                    std::to_string(c.v));
      c.ds_w = static_cast<int>((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.ds_h = static_cast<int>((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.ds_w + bs - 1) / bs;
      c.bh = (c.ds_h + bs - 1) / bs;
      c.abw = mcux_ * c.h;
      std::fill(c.coef_bits, c.coef_bits + 10, -1);
    }
    have_frame_ = true;
  }

  void allocate() {
    for (Component& c : comps_) {
      if (lossless_) c.samp.assign(size_t(c.ds_h) * c.ds_w, 0);
      else c.coef.assign(size_t(mcuy_) * c.v * c.abw * 64, 0);
    }
  }

  void dht(size_t p, size_t end) {
    while (p < end) {
      if (end - p < 17) corrupt("DHT segment too short");
      const int tc = d_[p] >> 4, th = d_[p] & 15;
      const uint8_t* counts = d_ + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (tc > 1 || th > 3 || total > 256 || p + 17 + total > end) corrupt("bad DHT segment");
      build_huffman(tc ? ac_[th] : dc_[th], counts, d_ + p + 17, total);
      p += 17 + total;
    }
  }

  // jdmarker.c::get_dac: arithmetic conditioning, DC (L, U) or AC (K)
  void dac(size_t p, size_t end) {
    if ((end - p) % 2) corrupt("bad DAC length");
    for (; p < end; p += 2) {
      const int index = d_[p], val = d_[p + 1];
      if (index >= 32) corrupt("bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        dac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_l_[index] = static_cast<uint8_t>(val & 15);
        dac_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dac_l_[index] > dac_u_[index]) corrupt("bad DAC value " + std::to_string(val));
      }
    }
  }

  void dqt(size_t p, size_t end) {
    while (p < end) {
      const int pq = d_[p] >> 4, tq = d_[p] & 15;
      const size_t need = 1 + 64 * (pq ? 2 : 1);
      if (pq > 1 || tq > 3 || p + need > end) corrupt("bad DQT segment");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] = static_cast<uint16_t>(
            pq ? (d_[p + 1 + 2 * k] << 8) | d_[p + 2 + 2 * k] : d_[p + 1 + k]);
      qt_defined_[tq] = true;
      p += need;
    }
  }

  void decide_space() {
    const int nc = channels();
    if (nc == 1) {
      space_ = Space::kGrey;
    } else if (nc == 3) {
      if (saw_jfif_) space_ = Space::kYCbCr;
      else if (saw_adobe_) space_ = adobe_transform_ == 0 ? Space::kRGB : Space::kYCbCr;
      else if (comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B') space_ = Space::kRGB;
      else space_ = Space::kYCbCr;
    } else {
      space_ = saw_adobe_ && adobe_transform_ == 2 ? Space::kYCCK : Space::kCMYK;
    }
  }

  // Calls block(scan component, block) for every block of the scan in
  // coding order, and restart(n) before the MCU that follows RSTn.
  template <class Restart, class Block>
  void each_block(ScanComp* sc, int ns, Restart&& restart, Block&& block) {
    int restarts_left = restart_interval_, next_rst = 0;
    const bool single = ns == 1;
    const int mx_n = single ? sc[0].c->bw : mcux_, my_n = single ? sc[0].c->bh : mcuy_;
    for (int my = 0; my < my_n; ++my) {
      for (int mx = 0; mx < mx_n; ++mx) {
        if (restart_interval_) {
          if (restarts_left == 0) {
            restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            restarts_left = restart_interval_;
          }
          --restarts_left;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i].c;
          const int nv = single ? 1 : c.v, nh = single ? 1 : c.h;
          for (int by = 0; by < nv; ++by)
            for (int bx = 0; bx < nh; ++bx)
              block(sc[i], c.coef.data() +
                               (size_t(my * nv + by) * c.abw + size_t(mx * nh + bx)) * 64);
        }
      }
    }
  }

  void sos(size_t p, size_t end) {
    const int ns = d_[p];
    if (ns < 1 || ns > 4 || end - p != size_t(4 + 2 * ns)) corrupt("bad SOS segment");
    ScanComp sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = d_[p + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& cc : comps_)
        if (cc.id == id) c = &cc;
      if (c == nullptr) corrupt("SOS names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j].c == c) corrupt("SOS names a component twice");
      sc[i] = {c, d_[p + 2 + 2 * i] >> 4, d_[p + 2 + 2 * i] & 15, 0};
      if (sc[i].td > (arith_ ? 15 : 3) || sc[i].ta > (arith_ ? 15 : 3))
        corrupt("bad SOS table index");
    }
    const int ss = d_[p + 1 + 2 * ns], se = d_[p + 2 + 2 * ns];
    const int ah = d_[p + 3 + 2 * ns] >> 4, al = d_[p + 3 + 2 * ns] & 15;
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) blocks_in_mcu += sc[i].c->h * sc[i].c->v;
    if (ns > 1 && blocks_in_mcu > 10) corrupt("too many blocks in an MCU");
    pos_ = end;
    for (Component& c : comps_) c.dc_pred = 0;
    if (lossless_) {
      scan_lossless(sc, ns, ss, se, ah, al);
      ++scans_;
      return;
    }
    for (int i = 0; i < ns; ++i) {  // jdinput.c::latch_quant_tables
      Component& c = *sc[i].c;
      if (!c.q_latched) {
        if (!qt_defined_[c.tq]) corrupt("no quantization table " + std::to_string(c.tq));
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.q_latched = true;
      }
    }
    Kind kind;
    if (!progressive_) {
      kind = kSeq;
    } else {  // jdphuff.c::start_pass_phuff_decoder, jdarith.c::start_pass
      bool bad = false;
      if (ss == 0) bad = se != 0;
      else bad = ss > se || se > 63 || ns != 1;
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("bad progressive scan parameters");
      kind = ss == 0 ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= std::min(se, 9); ++k) sc[i].c->coef_bits[k] = al;
    }
    if (arith_) scan_arith(sc, ns, kind, ss, se, ah, al);
    else scan_huffman(sc, ns, kind, ss, se, al);
    ++scans_;
  }

  enum Kind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

  void scan_huffman(ScanComp* sc, int ns, Kind kind, int ss, int se, int al) {
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = kind == kSeq || kind == kDcFirst;
      const bool need_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
      if ((need_dc && !dc_[sc[i].td].defined) || (need_ac && !ac_[sc[i].ta].defined))
        corrupt("scan uses an undefined Huffman table");
      if (need_dc && dc_[sc[i].td].max_val > 15) corrupt("bad DC Huffman table (symbol over 15)");
    }
    BitReader br;
    br.d = d_;
    br.n = n_;
    br.start(pos_);
    int eobrun = 0;
    auto restart = [&](int expect) {
      restart_marker(br.pos, expect);
      br.start(pos_);
      for (Component& c : comps_) c.dc_pred = 0;
      eobrun = 0;
    };
    each_block(sc, ns, restart, [&](ScanComp& s, int16_t* blk) {
      Component& c = *s.c;
      switch (kind) {
        case kSeq:
          block_seq(br, c, blk, dc_[s.td], ac_[s.ta]);
          break;
        case kDcFirst:
          c.dc_pred += br.receive_extend(br.decode(dc_[s.td]));
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
          break;
        case kDcRefine:
          if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
          break;
        case kAcFirst:
          block_ac_first(br, blk, ac_[s.ta], ss, se, al, eobrun);
          break;
        case kAcRefine:
          block_ac_refine(br, blk, ac_[s.ta], ss, se, al, eobrun);
          break;
      }
    });
    pos_ = br.pos;  // the next marker search skips what is left of the segment
  }

  // jdhuff.c/jdarith.c::process_restart: read RSTn where the segment ends.
  void restart_marker(size_t at, int expect) {
    pos_ = at;
    const int m = next_marker();
    if (m != 0xD0 + expect) corrupt("expected RST" + std::to_string(expect) + " marker");
  }

  // jdarith.c: decode_mcu (sequential), decode_mcu_DC_first, _AC_first,
  // _DC_refine and _AC_refine. A bad code (magnitude or spectral overflow)
  // stops the decoding until the next restart marker, as libjpeg's ct = -1
  // does; the blocks keep what they hold.
  void scan_arith(ScanComp* sc, int ns, Kind kind, int ss, int se, int ah, int al) {
    ArithStats st;
    ArithReader ar;
    ar.d = d_;
    ar.n = n_;
    auto reset = [&]() {  // start_pass and process_restart
      for (int i = 0; i < ns; ++i) {
        if (!progressive_ || (ss == 0 && ah == 0)) {
          std::memset(st.dc[sc[i].td], 0, kDcStatBins);
          sc[i].c->dc_pred = 0;
          sc[i].dc_context = 0;
        }
        if (!progressive_ || ss) std::memset(st.ac[sc[i].ta], 0, kAcStatBins);
      }
      ar.start(pos_);
    };
    reset();
    auto restart = [&](int expect) {
      restart_marker(ar.pos, expect);
      reset();
    };
    each_block(sc, ns, restart, [&](ScanComp& s, int16_t* blk) {
      if (ar.ct == -1) return;
      Component& c = *s.c;
      switch (kind) {
        case kSeq:
        case kDcFirst: {
          const int v = arith_dc_diff(ar, st, s);
          if (ar.ct == -1) return;
          c.dc_pred = (c.dc_pred + v) & 0xFFFF;
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
          if (kind == kSeq) arith_ac_first(ar, st, s.ta, blk, 1, 63, 0);
          break;
        }
        case kDcRefine:
          if (ar.decode(&st.fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
          break;
        case kAcFirst:
          arith_ac_first(ar, st, s.ta, blk, ss, se, al);
          break;
        case kAcRefine:
          arith_ac_refine(ar, st, s.ta, blk, ss, se, al);
          break;
      }
    });
    pos_ = ar.pos;
  }

  // F.1.4.4.1: one DC difference and the conditioning it leaves.
  int arith_dc_diff(ArithReader& ar, ArithStats& st, ScanComp& s) const {
    const int tbl = s.td;
    uint8_t* bin = st.dc[tbl] + s.dc_context;
    if (ar.decode(bin) == 0) {
      s.dc_context = 0;
      return 0;
    }
    const int sign = ar.decode(bin + 1);
    bin += 2 + sign;
    int m = ar.decode(bin);
    if (m != 0) {
      bin = st.dc[tbl] + 20;  // X1
      while (ar.decode(bin)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow
          return 0;
        }
        ++bin;
      }
    }
    if (m < int((1L << dac_l_[tbl]) >> 1)) s.dc_context = 0;
    else if (m > int((1L << dac_u_[tbl]) >> 1)) s.dc_context = 12 + sign * 4;
    else s.dc_context = 4 + sign * 4;
    int v = m;
    bin += 14;
    while (m >>= 1)
      if (ar.decode(bin)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // F.1.4.4.2: the AC coefficients ss..se of one block, scaled by 2^al.
  void arith_ac_first(ArithReader& ar, ArithStats& st, int tbl, int16_t* blk, int ss, int se,
                      int al) const {
    for (int k = ss; k <= se; ++k) {
      uint8_t* bin = st.ac[tbl] + 3 * (k - 1);
      if (ar.decode(bin)) break;  // EOB
      while (ar.decode(bin + 1) == 0) {
        bin += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      const int sign = ar.decode(&st.fixed_bin);
      bin += 2;
      int m = ar.decode(bin);
      if (m != 0 && ar.decode(bin)) {
        m <<= 1;
        bin = st.ac[tbl] + (k <= dac_k_[tbl] ? 189 : 217);
        while (ar.decode(bin)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return;
          }
          ++bin;
        }
      }
      int v = m;
      bin += 14;
      while (m >>= 1)
        if (ar.decode(bin)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, ArithStats& st, int tbl, int16_t* blk, int ss, int se,
                       int al) const {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* bin = st.ac[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(bin)) break;  // EOB
      for (;;) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {  // previously nonzero: a correction bit
          if (ar.decode(bin + 2)) coef = static_cast<int16_t>(coef < 0 ? coef + m1 : coef + p1);
          break;
        }
        if (ar.decode(bin + 1)) {  // newly nonzero
          coef = static_cast<int16_t>(ar.decode(&st.fixed_bin) ? m1 : p1);
          break;
        }
        bin += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // Lossless (SOF3): jdlhuff.c decodes each sample's difference, jddiffct.c
  // gathers an iMCU row of them and un-differences it row by row
  // (jdlossls.c), restarts falling on MCU-row boundaries reset the
  // predictors; the samples keep 16 bits, scaled by 2^Pt at the output.
  void scan_lossless(ScanComp* sc, int ns, int psv, int se, int ah, int pt) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt >= 8)
      corrupt("bad lossless scan parameters");
    for (int i = 0; i < ns; ++i) {
      const Huffman& t = dc_[sc[i].td];
      if (!t.defined) corrupt("scan uses an undefined Huffman table");
      if (t.max_val > 16) corrupt("bad lossless Huffman table (symbol over 16)");
    }
    const bool single = ns == 1;
    const int mcus_per_row = single ? sc[0].c->bw : mcux_;
    if (restart_interval_ % mcus_per_row)
      corrupt("lossless restart interval not a whole number of MCU rows");
    const int rows_per_interval = restart_interval_ / mcus_per_row;
    BitReader br;
    br.d = d_;
    br.n = n_;
    br.start(pos_);
    int rows_left = rows_per_interval, next_rst = 0;
    std::vector<std::vector<int32_t>> diff(ns);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i].c;
      c.first_row = true;
      c.pt = pt;
      diff[i].assign(size_t(c.v) * c.abw, 0);
    }
    const int initial = 1 << (8 - pt - 1);
    for (int imcu = 0; imcu < mcuy_; ++imcu) {
      const bool last = imcu == mcuy_ - 1;
      auto height = [&](const Component& c) {  // last_row_height in the last iMCU row
        return last && c.ds_h % c.v ? c.ds_h % c.v : c.v;
      };
      const int mcu_rows = single ? height(*sc[0].c) : 1;
      for (int yoff = 0; yoff < mcu_rows; ++yoff) {
        if (restart_interval_) {
          if (rows_left == 0) {
            restart_marker(br.pos, next_rst);
            br.start(pos_);
            next_rst = (next_rst + 1) & 7;
            for (Component& c : comps_) c.first_row = true;
            rows_left = rows_per_interval;
          }
        }
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[i].c;
            const int nv = single ? 1 : c.v, nh = single ? 1 : c.h;
            for (int by = 0; by < nv; ++by) {
              for (int bx = 0; bx < nh; ++bx) {
                const int s = br.decode(dc_[sc[i].td]);
                const int d = s == 16 ? 32768 : br.receive_extend(s);
                diff[i][size_t(single ? yoff : by) * c.abw + size_t(mx * nh + bx)] = d;
              }
            }
          }
        }
        if (restart_interval_) --rows_left;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i].c;
        for (int r = 0; r < height(c); ++r) {
          const int y = imcu * c.v + r;
          uint16_t* row = c.samp.data() + size_t(y) * c.ds_w;
          const uint16_t* prev = c.first_row ? nullptr : row - c.ds_w;
          undifference_row(diff[i].data() + size_t(r) * c.abw, prev, c.ds_w, psv, initial, row);
          c.first_row = false;
        }
      }
    }
    pos_ = br.pos;
  }

  static void block_seq(BitReader& br, Component& c, int16_t* blk, const Huffman& dc,
                        const Huffman& ac) {
    c.dc_pred += br.receive_extend(br.decode(dc));
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c::decode_mcu_AC_first
  static void block_ac_first(BitReader& br, int16_t* blk, const Huffman& ac, int ss, int se,
                             int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(ac), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<unsigned>(br.receive_extend(s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.get(r));
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c::decode_mcu_AC_refine
  static void block_ac_refine(BitReader& br, int16_t* blk, const Huffman& ac, int ss, int se,
                              int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // the size of a newly nonzero coefficient is always 1
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          break;  // the rest of the block is the EOB run's
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) correct(coef);
          else if (--r < 0) break;  // the target zero coefficient
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // jdcoefct.c::smoothing_ok, for the state after the last scan: libjpeg
  // smooths a progressive file whose scans leave one of the first ten
  // coefficients of a component short of full precision.
  bool smoothing_applies() const {
    if (!progressive_) return false;
    constexpr int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q00 Q01 Q10 Q20 ... Q30
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.q_latched) return false;
      for (int k : kPos)
        if (c.q[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // decompress_smooth_data's walk over one component: the DC values of the
  // rows two above to two below each block, gathered as libjpeg gathers
  // them (its row counting within the last iMCU row included: there a
  // partial iMCU row counts image_block_rows as block_rows * total rows),
  // then each block estimated and transformed.
  void smooth_idct(const Component& c, uint8_t* plane, int64_t pw) const {
    const int last_imcu = mcuy_ - 1;
    auto block = [&](int row, int col) { return c.coef.data() + (size_t(row) * c.abw + col) * 64; };
    const int last_col = c.bw - 1;
    for (int r = 0; r < c.bh; ++r) {
      const int imcu = r / c.v, block_row = r % c.v;
      int block_rows = c.v;
      if (imcu == last_imcu && c.bh % c.v) block_rows = c.bh % c.v;
      const int ibr = imcu * block_rows + block_row, ibrs = block_rows * mcuy_;
      const int prev = ibr > 0 ? r - 1 : r;
      const int pprev = ibr > 1 ? r - 2 : prev;
      const int next = ibr < ibrs - 1 ? r + 1 : r;
      const int nnext = ibr < ibrs - 2 ? r + 2 : next;
      const int rows[5] = {pprev, prev, r, next, nnext};
      int dc[25];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) dc[5 * i + j] = block(rows[i], 0)[0];
      for (int b = 0; b <= last_col; ++b) {
        int16_t ws[64];
        std::memcpy(ws, block(r, b), sizeof(ws));
        if (b == 0 && b < last_col)
          for (int i = 0; i < 5; ++i) dc[5 * i + 3] = dc[5 * i + 4] = block(rows[i], 1)[0];
        if (b + 1 < last_col)
          for (int i = 0; i < 5; ++i) dc[5 * i + 4] = block(rows[i], b + 2)[0];
        smooth_block(ws, dc, c.q, c.coef_bits);
        idct_islow(ws, c.q, plane + r * 8 * pw + b * 8, pw);
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 4; ++j) dc[5 * i + j] = dc[5 * i + j + 1];
      }
    }
  }

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool have_frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];
  int restart_interval_ = 0;
  int scans_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  Space space_ = Space::kGrey;
};

void Decoder::finish(uint8_t* out) const {
  const bool smooth = smoothing_applies();
  const int nc = channels();
  const int W = width_, H = height_;
  // each component at full size: (rows, row stride) into its own buffer
  std::vector<std::vector<uint8_t>> planes(nc), full(nc);
  std::vector<const uint8_t*> src(nc);
  std::vector<int64_t> stride(nc);
  for (int i = 0; i < nc; ++i) {
    const Component& c = comps_[i];
    int64_t pw;
    if (lossless_) {  // jdlossls.c's scaler: the low 8 bits of sample << Pt
      pw = c.ds_w;
      planes[i].resize(c.samp.size());
      for (size_t k = 0; k < c.samp.size(); ++k)
        planes[i][k] = static_cast<uint8_t>(c.samp[k] << c.pt);
    } else {
      pw = int64_t(c.bw) * 8;
      planes[i].resize(size_t(pw) * c.bh * 8);
      const uint16_t* q = c.q_latched ? c.q : qt_[c.tq];
      if (smooth) {
        smooth_idct(c, planes[i].data(), pw);
      } else {
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.coef.data() + (size_t(by) * c.abw + bx) * 64, q,
                       planes[i].data() + by * 8 * pw + bx * 8, pw);
      }
    }
    const int hexp = hmax_ / c.h, vexp = vmax_ / c.v;
    if (hexp == 1 && vexp == 1) {
      src[i] = planes[i].data();
      stride[i] = pw;
    } else {
      // libjpeg upsamples lossless frames by replication: its fancy
      // upsampling needs DCT blocks larger than one sample
      const int64_t fw = int64_t(c.ds_w) * hexp;
      full[i].resize(size_t(fw) * c.ds_h * vexp);
      upsample(planes[i].data(), pw, c.ds_h, c.ds_w, hexp, vexp, !lossless_, full[i].data(), fw);
      src[i] = full[i].data();
      stride[i] = fw;
    }
  }
  for (int y = 0; y < H; ++y) {
    uint8_t* op = out + int64_t(y) * W * nc;
    const uint8_t* r0 = src[0] + y * stride[0];
    if (space_ == Space::kGrey) {
      std::memcpy(op, r0, size_t(W));
    } else if (space_ == Space::kYCbCr) {
      const uint8_t* r1 = src[1] + y * stride[1];
      const uint8_t* r2 = src[2] + y * stride[2];
      for (int x = 0; x < W; ++x) ycc_pixel(r0[x], r1[x], r2[x], op + 3 * x);
    } else if (space_ == Space::kYCCK) {  // then inverted, as for CMYK
      const uint8_t* r1 = src[1] + y * stride[1];
      const uint8_t* r2 = src[2] + y * stride[2];
      const uint8_t* r3 = src[3] + y * stride[3];
      for (int x = 0; x < W; ++x) {
        uint8_t* px = op + 4 * x;
        ycck_pixel(r0[x], r1[x], r2[x], r3[x], px);
        for (int k = 0; k < 4; ++k) px[k] = static_cast<uint8_t>(px[k] ^ 255);
      }
    } else {
      for (int i = 0; i < nc; ++i) {
        const uint8_t* ri = src[i] + y * stride[i];
        const uint8_t flip = space_ == Space::kCMYK ? 255 : 0;
        for (int x = 0; x < W; ++x) op[nc * x + i] = static_cast<uint8_t>(ri[x] ^ flip);
      }
    }
  }
}

void set_error(char* err, int32_t errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t capacity, int32_t* dims,
                char* err, int32_t errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.run(out == nullptr);
    dims[0] = dec.height();
    dims[1] = dec.width();
    dims[2] = dec.channels();
    if (out == nullptr) return 0;
    if (int64_t(dec.height()) * dec.width() * dec.channels() > capacity) {
      set_error(err, errlen, "output buffer too small");
      return 3;
    }
    dec.finish(out);
    return 0;
  } catch (const Unsupported& e) {
    set_error(err, errlen, e.what);
    return 1;
  } catch (const Corrupt& e) {
    set_error(err, errlen, e.what);
    return 2;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory (image dimensions too large?)");
    return 2;
  }
}

int jpeg_idct_blocks(const int16_t* coef, const uint16_t* qtable, int64_t nblocks, uint8_t* out) {
  for (int64_t b = 0; b < nblocks; ++b) idct_islow(coef + 64 * b, qtable, out + 64 * b, 8);
  return 0;
}

int jpeg_upsample(const uint8_t* in, int32_t ds_h, int32_t ds_w, int32_t hexp, int32_t vexp,
                  uint8_t* out) {
  if (ds_h < 1 || ds_w < 1 || hexp < 1 || vexp < 1) return -1;
  upsample(in, ds_w, ds_h, ds_w, hexp, vexp, true, out, int64_t(ds_w) * hexp);
  return 0;
}

int jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                 uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) ycc_pixel(y[i], cb[i], cr[i], out + 3 * i);
  return 0;
}

int jpeg_ycck_cmyk(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, const uint8_t* k,
                   int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) ycck_pixel(y[i], cb[i], cr[i], k[i], out + 4 * i);
  return 0;
}

int jpeg_smooth_blocks(const int16_t* coef, const int32_t* dc, const uint16_t* qtable,
                       const int32_t* bits, int64_t nblocks, int16_t* out) {
  int b10[10];
  for (int k = 0; k < 10; ++k) b10[k] = bits[k];
  for (int64_t b = 0; b < nblocks; ++b) {
    int d25[25];
    for (int i = 0; i < 25; ++i) d25[i] = dc[25 * b + i];
    std::memcpy(out + 64 * b, coef + 64 * b, 64 * sizeof(int16_t));
    smooth_block(out + 64 * b, d25, qtable, b10);
  }
  return 0;
}

int jpeg_undifference_row(const int32_t* diff, const uint16_t* prev, int32_t width, int32_t psv,
                          int32_t initial, uint16_t* out) {
  if (width < 1 || psv < 1 || psv > 7) return -1;
  undifference_row(diff, prev, width, psv, initial, out);
  return 0;
}

}  // extern "C"

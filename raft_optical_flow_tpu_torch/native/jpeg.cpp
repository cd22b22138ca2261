// Baseline and progressive JPEG decoder for the port's frame reader
// (data/frame_utils.py::decode_jpeg). Its output is what
// `np.array(PIL.Image.open(path))` gives, bit for bit: PIL decodes through
// libjpeg(-turbo) at libjpeg's default decompress parameters, and each
// pixel stage here follows that library's code for those parameters:
//
//   entropy decoding  Huffman, sequential (SOF0, SOF1) and progressive
//                     (SOF2: spectral selection and successive
//                     approximation, DC and AC, first and refinement scans,
//                     EOB runs), restart intervals (DRI, RST0-7: the DC
//                     predictors and the EOB run reset). Every coefficient
//                     is kept until the last scan, as libjpeg's buffered
//                     coefficient controller keeps them.
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
//                     factors such as 4:1:1. Rows above the first and below
//                     the last are the edge rows (jdmainct.c's context
//                     pointers), columns likewise. The merged upsampler
//                     (jdmerge.c) is not used when fancy upsampling is on.
//   colour            jdcolor.c::ycc_rgb_convert (its FIX() tables and
//                     ONE_HALF rounding) for YCbCr; RGB, grey and CMYK pass
//                     through. The colour space follows
//                     jdapimin.c::default_decompress_parms: JFIF (APP0) means
//                     YCbCr, else the Adobe (APP14) transform flag, else the
//                     component IDs ('R','G','B' means RGB); four components
//                     are CMYK unless the Adobe flag says YCCK. CMYK comes out
//                     inverted, as PIL reads it ("CMYK;I", Adobe polarity).
//
// Block smoothing (jdcoefct.c::decompress_smooth_data) is not applied:
// libjpeg applies it only to a progressive file whose scans leave one of the
// first ten coefficients of a component unrefined, and such a file raises
// (Unsupported) here instead of decoding differently. Files that Pillow and
// cv2 write refine every coefficient.
//
// Raised as Unsupported (NotImplementedError in Python), naming the marker
// or the feature: arithmetic coding (SOF9-SOF11, SOF13-SOF15), lossless
// (SOF3), hierarchical (SOF5-SOF7), 12- and 16-bit precision, YCCK, frames
// of other than 1, 3 or 4 components, non-integer sampling ratios. Raised as
// Corrupt (ValueError): a truncated stream (entropy data that runs past its
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
              uint8_t* out, int64_t out_stride) {
  auto row = [&](int r) { return in + int64_t(std::min(std::max(r, 0), ds_h - 1)) * in_stride; };
  if (hexp == 2 && vexp == 1 && ds_w > 2) {  // h2v1_fancy_upsample
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
  } else if (hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
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
  } else if (hexp == 2 && vexp == 2 && ds_w > 2) {  // h2v2_fancy_upsample
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
  uint16_t look[512];  // 9-bit prefix -> (length << 8) | symbol, 0 if the code is longer
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// JPEG Annex C (jdhuff.c::jpeg_make_d_derived_tbl)
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  std::memset(t.look, 0, sizeof(t.look));
  std::memcpy(t.vals, vals, size_t(nvals));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        const int shift = 9 - len;
        for (int p = 0; p < (1 << shift); ++p)
          t.look[(code << shift) | p] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (int32_t(1) << len)) corrupt("bad Huffman table (code lengths overflow)");
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) corrupt("bad DC Huffman table (symbol over 15)");
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

// -- the decoder ------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;  // downsampled size (jdinput.c::initial_setup)
  int bw = 0, bh = 0;      // blocks holding samples: ceil(ds / 8)
  int abw = 0;             // blocks allocated per row (whole MCUs)
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool q_latched = false;
  int dc_pred = 0;
  int coef_bits[10];  // progressive: -1 never coded, else the last scan's Al
};

struct ScanComp {
  Component* c;
  int td, ta;
};

enum class Space { kGrey, kYCbCr, kRGB, kCMYK };

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

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
          sof(m, body, end);
          break;
        case 0xC3:
          unsupported("SOF3 (lossless JPEG)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          unsupported(marker_name(m) + " (hierarchical JPEG)");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          unsupported(marker_name(m) + " (arithmetic coding)");
        case 0xC4:
          dht(body, end);
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
          if (comps_[0].coef.empty()) allocate();
          sos(body, end);
          continue;  // pos_ is past the scan's entropy-coded data
        default:  // other APPn, COM, DNL, DAC, JPGn: skipped
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
    const int precision = d_[p];
    if (precision == 12 || precision == 16)
      unsupported(std::to_string(precision) + "-bit precision (" + marker_name(m) + ")");
    if (precision != 8) corrupt("bad sample precision " + std::to_string(precision));
    height_ = u16(p + 1);
    width_ = u16(p + 3);
    const int nc = d_[p + 5];
    if (height_ == 0 || width_ == 0) corrupt("empty image (or a DNL height, not supported)");
    if (nc != 1 && nc != 3 && nc != 4)
      unsupported(std::to_string(nc) + "-component JPEG (1, 3 or 4 are decoded)");
    if (end - p != size_t(6 + 3 * nc)) corrupt("bad SOF length");
    progressive_ = m == 0xC2;
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
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        unsupported("non-integer sampling ratio " + std::to_string(hmax_) + "/" +
                    std::to_string(c.h) + " x " + std::to_string(vmax_) + "/" +
                    std::to_string(c.v));
      c.ds_w = static_cast<int>((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.ds_h = static_cast<int>((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.ds_w + 7) / 8;
      c.bh = (c.ds_h + 7) / 8;
      c.abw = mcux_ * c.h;
      std::fill(c.coef_bits, c.coef_bits + 10, -1);
    }
    have_frame_ = true;
  }

  void allocate() {
    for (Component& c : comps_) c.coef.assign(size_t(mcuy_) * c.v * c.abw * 64, 0);
  }

  void dht(size_t p, size_t end) {
    while (p < end) {
      if (end - p < 17) corrupt("DHT segment too short");
      const int tc = d_[p] >> 4, th = d_[p] & 15;
      const uint8_t* counts = d_ + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (tc > 1 || th > 3 || total > 256 || p + 17 + total > end) corrupt("bad DHT segment");
      build_huffman(tc ? ac_[th] : dc_[th], counts, d_ + p + 17, total, tc == 0);
      p += 17 + total;
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
      if (saw_adobe_ && adobe_transform_ != 0)
        unsupported("YCCK (Adobe APP14 transform " + std::to_string(adobe_transform_) + ")");
      space_ = Space::kCMYK;
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
      sc[i] = {c, d_[p + 2 + 2 * i] >> 4, d_[p + 2 + 2 * i] & 15};
      if (sc[i].td > 3 || sc[i].ta > 3) corrupt("bad SOS table index");
    }
    const int ss = d_[p + 1 + 2 * ns], se = d_[p + 2 + 2 * ns];
    const int ah = d_[p + 3 + 2 * ns] >> 4, al = d_[p + 3 + 2 * ns] & 15;
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) blocks_in_mcu += sc[i].c->h * sc[i].c->v;
    if (ns > 1 && blocks_in_mcu > 10) corrupt("too many blocks in an MCU");
    for (int i = 0; i < ns; ++i) {  // jdinput.c::latch_quant_tables
      Component& c = *sc[i].c;
      if (!c.q_latched) {
        if (!qt_defined_[c.tq]) corrupt("no quantization table " + std::to_string(c.tq));
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.q_latched = true;
      }
    }
    enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
    if (!progressive_) {
      kind = kSeq;
    } else {  // jdphuff.c::start_pass_phuff_decoder
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
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = kind == kSeq || kind == kDcFirst;
      const bool need_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
      if ((need_dc && !dc_[sc[i].td].defined) || (need_ac && !ac_[sc[i].ta].defined))
        corrupt("scan uses an undefined Huffman table");
    }
    pos_ = end;
    BitReader br;
    br.d = d_;
    br.n = n_;
    br.start(pos_);
    for (Component& c : comps_) c.dc_pred = 0;
    int eobrun = 0, restarts_left = restart_interval_, next_rst = 0;
    const bool single = ns == 1;
    const int mx_n = single ? sc[0].c->bw : mcux_, my_n = single ? sc[0].c->bh : mcuy_;
    for (int my = 0; my < my_n; ++my) {
      for (int mx = 0; mx < mx_n; ++mx) {
        if (restart_interval_) {
          if (restarts_left == 0) {
            restart(br, next_rst);
            next_rst = (next_rst + 1) & 7;
            for (Component& c : comps_) c.dc_pred = 0;
            eobrun = 0;
            restarts_left = restart_interval_;
          }
          --restarts_left;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i].c;
          const int nv = single ? 1 : c.v, nh = single ? 1 : c.h;
          for (int by = 0; by < nv; ++by) {
            for (int bx = 0; bx < nh; ++bx) {
              const int row = my * nv + by, col = mx * nh + bx;
              int16_t* blk = c.coef.data() + (size_t(row) * c.abw + col) * 64;
              switch (kind) {
                case kSeq:
                  block_seq(br, c, blk, dc_[sc[i].td], ac_[sc[i].ta]);
                  break;
                case kDcFirst:
                  c.dc_pred += br.receive_extend(br.decode(dc_[sc[i].td]));
                  blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
                  break;
                case kDcRefine:
                  if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                  break;
                case kAcFirst:
                  block_ac_first(br, blk, ac_[sc[i].ta], ss, se, al, eobrun);
                  break;
                case kAcRefine:
                  block_ac_refine(br, blk, ac_[sc[i].ta], ss, se, al, eobrun);
                  break;
              }
            }
          }
        }
      }
    }
    pos_ = br.pos;  // the next marker search skips what is left of the segment
    ++scans_;
  }

  // jdhuff.c::process_restart: drop the bit buffer, read RSTn.
  void restart(BitReader& br, int expect) {
    pos_ = br.pos;
    const int m = next_marker();
    if (m != 0xD0 + expect) corrupt("expected RST" + std::to_string(expect) + " marker");
    br.start(pos_);
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

  // libjpeg's jdcoefct.c::smoothing_ok, for the state after the last scan
  bool smoothing_would_apply() const {
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

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool have_frame_ = false, progressive_ = false;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  int scans_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  Space space_ = Space::kGrey;
};

void Decoder::finish(uint8_t* out) const {
  if (smoothing_would_apply())
    unsupported("progressive scans that leave coefficients unrefined (libjpeg block smoothing)");
  const int nc = channels();
  const int W = width_, H = height_;
  // each component at full size: (rows, row stride) into its own buffer
  std::vector<std::vector<uint8_t>> planes(nc), full(nc);
  std::vector<const uint8_t*> src(nc);
  std::vector<int64_t> stride(nc);
  for (int i = 0; i < nc; ++i) {
    const Component& c = comps_[i];
    const int64_t pw = int64_t(c.bw) * 8;
    planes[i].resize(size_t(pw) * c.bh * 8);
    const uint16_t* q = c.q_latched ? c.q : qt_[c.tq];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (size_t(by) * c.abw + bx) * 64, q,
                   planes[i].data() + by * 8 * pw + bx * 8, pw);
    const int hexp = hmax_ / c.h, vexp = vmax_ / c.v;
    if (hexp == 1 && vexp == 1) {
      src[i] = planes[i].data();
      stride[i] = pw;
    } else {
      const int64_t fw = int64_t(c.ds_w) * hexp;
      full[i].resize(size_t(fw) * c.ds_h * vexp);
      upsample(planes[i].data(), pw, c.ds_h, c.ds_w, hexp, vexp, full[i].data(), fw);
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
  upsample(in, ds_w, ds_h, ds_w, hexp, vexp, out, int64_t(ds_w) * hexp);
  return 0;
}

int jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                 uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) ycc_pixel(y[i], cb[i], cr[i], out + 3 * i);
  return 0;
}

}  // extern "C"

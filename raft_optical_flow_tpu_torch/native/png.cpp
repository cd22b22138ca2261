// PNG row un-filter for the port's PNG decoder (data/frame_utils.py).
//
// A non-interlaced PNG image, once zlib has inflated it, is `height` rows of
// one filter-type byte followed by `row_bytes` filtered bytes. Each filter
// predicts a byte from its left neighbour a (the byte `bpp` earlier in the
// same row, 0 before the row starts), the byte above it b (0 on the first
// row) and the byte above-left c:
//
//   0 None     x
//   1 Sub      x + a
//   2 Up       x + b
//   3 Average  x + floor((a + b) / 2)
//   4 Paeth    x + whichever of a, b, c is nearest to a + b - c
//              (ties: a, then b)
//
// all modulo 256. Sub, Average and Paeth read the byte just reconstructed to
// the left, so a row is a sequential scan; this is the loop that numpy cannot
// vectorize. `bpp` is the bytes per complete pixel, rounded up to 1 for bit
// depths below 8 (1 to 8 here).
//
// Exposed C ABI (see raft_optical_flow_tpu_torch/data/native.py):
//   png_unfilter(rows, height, row_bytes, bpp) - in place; the filter bytes
//   are left as they are. Returns 0, or -1 for an unknown filter type, -2 for
//   a bpp outside 1..8.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

int png_unfilter(uint8_t* rows, int64_t height, int64_t row_bytes, int32_t bpp) {
  if (bpp < 1 || bpp > 8) return -2;
  const int64_t stride = row_bytes + 1;
  const uint8_t* prev = nullptr;  // the reconstructed row above, or none
  for (int64_t y = 0; y < height; ++y) {
    uint8_t* row = rows + y * stride;
    const int type = row[0];
    uint8_t* x = row + 1;
    switch (type) {
      case 0:
        break;
      case 1:
        for (int64_t i = bpp; i < row_bytes; ++i) x[i] = static_cast<uint8_t>(x[i] + x[i - bpp]);
        break;
      case 2:
        if (prev)
          for (int64_t i = 0; i < row_bytes; ++i) x[i] = static_cast<uint8_t>(x[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          x[i] = static_cast<uint8_t>(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(x[i] + paeth(a, b, c));
        }
        break;
      default:
        return -1;
    }
    prev = x;
  }
  return 0;
}

}  // extern "C"

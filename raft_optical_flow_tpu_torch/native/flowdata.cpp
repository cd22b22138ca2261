// Native data-plane for the flow datasets: file decoders + batch prefetch.
//
// The port's own copy of `raft_optical_flow_tpu/native/flowdata.cpp` (the
// decoders unchanged). It decodes the dataset formats that dominate
// training-input CPU time -- Middlebury .flo (FlyingChairs/Sintel flow), PPM
// P6 (FlyingChairs images), PFM (FlyingThings3D flow) -- with zero-copy
// writes into caller-provided numpy buffers, and a std::thread batch API that
// runs fully outside the GIL (ctypes releases it for the duration of the call).
// `png.cpp` beside it holds the PNG row un-filter.
//
// Exposed C ABI (see raft_optical_flow_tpu_torch/data/native.py):
//   flo_dims / flo_read      - Middlebury .flo
//   ppm_dims / ppm_read      - binary PPM P6
//   pfm_dims / pfm_read      - PFM, top-down output
//   flo_read_batch           - N files decoded by a thread pool
//
// All functions return 0 on success, negative error codes otherwise.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

struct File {
  FILE* f;
  explicit File(const char* path, const char* mode) : f(fopen(path, mode)) {}
  ~File() {
    if (f) fclose(f);
  }
};

int flo_dims_impl(const char* path, int32_t* width, int32_t* height) {
  File file(path, "rb");
  if (!file.f) return -1;
  float magic = 0;
  if (fread(&magic, 4, 1, file.f) != 1 || magic != kFloMagic) return -2;
  int32_t wh[2];
  if (fread(wh, 4, 2, file.f) != 2) return -3;
  *width = wh[0];
  *height = wh[1];
  return 0;
}

int flo_read_impl(const char* path, float* out, int64_t capacity) {
  File file(path, "rb");
  if (!file.f) return -1;
  float magic = 0;
  if (fread(&magic, 4, 1, file.f) != 1 || magic != kFloMagic) return -2;
  int32_t wh[2];
  if (fread(wh, 4, 2, file.f) != 2) return -3;
  const int64_t n = 2LL * wh[0] * wh[1];
  if (n > capacity) return -4;
  if ((int64_t)fread(out, 4, n, file.f) != n) return -5;
  return 0;
}

// Skips PPM whitespace/comments and parses one ASCII integer.
bool ppm_int(FILE* f, int* value) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '#');
  if (c == EOF) return false;
  int v = 0;
  while (c >= '0' && c <= '9') {
    v = v * 10 + (c - '0');
    c = fgetc(f);
  }
  *value = v;
  return true;
}

int ppm_header(FILE* f, int* w, int* h, int* maxval) {
  char m0 = fgetc(f), m1 = fgetc(f);
  if (m0 != 'P' || m1 != '6') return -2;
  if (!ppm_int(f, w) || !ppm_int(f, h) || !ppm_int(f, maxval)) return -3;
  if (*maxval != 255) return -6;
  return 0;
}

int pfm_header(FILE* f, int* w, int* h, float* scale, int* channels) {
  char header[3] = {0};
  if (fscanf(f, "%2s", header) != 1) return -2;
  if (strcmp(header, "PF") == 0)
    *channels = 3;
  else if (strcmp(header, "Pf") == 0)
    *channels = 1;
  else
    return -2;
  if (fscanf(f, "%d %d %f", w, h, scale) != 3) return -3;
  fgetc(f);  // single whitespace before the raster
  return 0;
}

void byteswap_f32(float* data, int64_t n) {
  auto* p = reinterpret_cast<uint32_t*>(data);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = p[i];
    p[i] = (v >> 24) | ((v >> 8) & 0xff00) | ((v << 8) & 0xff0000) | (v << 24);
  }
}

}  // namespace

extern "C" {

int flo_dims(const char* path, int32_t* width, int32_t* height) {
  return flo_dims_impl(path, width, height);
}

int flo_read(const char* path, float* out, int64_t capacity) {
  return flo_read_impl(path, out, capacity);
}

// Decode n .flo files (same dimensions) in parallel into out[n, h, w, 2].
int flo_read_batch(const char** paths, int32_t n, float* out, int64_t per_file,
                   int32_t num_threads) {
  std::vector<int> status(n, 0);
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> threads;
  std::atomic_int next{0};
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      status[i] = flo_read_impl(paths[i], out + (int64_t)i * per_file, per_file);
    }
  };
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  for (int i = 0; i < n; ++i)
    if (status[i] != 0) return status[i];
  return 0;
}

int ppm_dims(const char* path, int32_t* width, int32_t* height) {
  File file(path, "rb");
  if (!file.f) return -1;
  int w, h, maxval;
  int rc = ppm_header(file.f, &w, &h, &maxval);
  if (rc) return rc;
  *width = w;
  *height = h;
  return 0;
}

int ppm_read(const char* path, uint8_t* out, int64_t capacity) {
  File file(path, "rb");
  if (!file.f) return -1;
  int w, h, maxval;
  int rc = ppm_header(file.f, &w, &h, &maxval);
  if (rc) return rc;
  const int64_t n = 3LL * w * h;
  if (n > capacity) return -4;
  if ((int64_t)fread(out, 1, n, file.f) != n) return -5;
  return 0;
}

int pfm_dims(const char* path, int32_t* width, int32_t* height,
             int32_t* channels) {
  File file(path, "rb");
  if (!file.f) return -1;
  int w, h, ch;
  float scale;
  int rc = pfm_header(file.f, &w, &h, &scale, &ch);
  if (rc) return rc;
  *width = w;
  *height = h;
  *channels = ch;
  return 0;
}

// Reads a PFM and flips it to top-down row order (read_pfm parity).
int pfm_read(const char* path, float* out, int64_t capacity) {
  File file(path, "rb");
  if (!file.f) return -1;
  int w, h, ch;
  float scale;
  int rc = pfm_header(file.f, &w, &h, &scale, &ch);
  if (rc) return rc;
  const int64_t row = (int64_t)w * ch;
  const int64_t n = row * h;
  if (n > capacity) return -4;
  // PFM stores bottom-up; write rows reversed for top-down output.
  for (int y = h - 1; y >= 0; --y) {
    if ((int64_t)fread(out + (int64_t)y * row, 4, row, file.f) != row) return -5;
  }
  if (scale > 0) byteswap_f32(out, n);  // positive scale = big-endian file
  return 0;
}

}  // extern "C"

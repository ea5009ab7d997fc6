// Row-filter reversal of 8-bit grayscale PNG images, for the EuRoC
// prefetcher of okvis2_torch/pipeline/native_loader.py.
//
// The prefetcher's worker threads inflate each image's IDAT stream with
// Python's zlib (which releases the interpreter lock) and hand the rows
// here through ctypes (which releases it too): each row is one filter
// byte and `width` filtered bytes, and this undoes the filter (None, Sub,
// Up, Average or Paeth, as pipeline/png.py does) and writes the pixels as
// float32 in [0, 1], each the uint8 value divided by 255 in float32, as
// the port's load_image computes it. No image library is needed.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline uint8_t Paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: height * (width + 1) bytes; out: height * width floats.
// Returns 0, or -1 at a row whose filter byte is not 0-4.
int png_unfilter_gray8(const uint8_t* raw, int height, int width, float* out) {
  std::vector<uint8_t> prev(width, 0), cur(width, 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = raw + static_cast<size_t>(y) * (width + 1);
    const uint8_t* f = row + 1;
    switch (row[0]) {
      case 0:
        for (int x = 0; x < width; ++x) cur[x] = f[x];
        break;
      case 1:
        for (int x = 0; x < width; ++x) cur[x] = f[x] + (x ? cur[x - 1] : 0);
        break;
      case 2:
        for (int x = 0; x < width; ++x) cur[x] = f[x] + prev[x];
        break;
      case 3:
        for (int x = 0; x < width; ++x)
          cur[x] = f[x] + (((x ? cur[x - 1] : 0) + prev[x]) >> 1);
        break;
      case 4:
        for (int x = 0; x < width; ++x)
          cur[x] = f[x] + Paeth(x ? cur[x - 1] : 0, prev[x], x ? prev[x - 1] : 0);
        break;
      default:
        return -1;
    }
    float* o = out + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) o[x] = static_cast<float>(cur[x]) / 255.0f;
    prev.swap(cur);
  }
  return 0;
}

}  // extern "C"

// PNG scanline unfiltering (PNG spec, section 9), for data/png.py: the
// reader that needs no libpng. Each row starts with its filter type byte:
// 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth. Average and Paeth depend on the
// byte just reconstructed, so they run here and not in numpy.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

extern "C" int d3f_png_unfilter(const uint8_t* raw, int height,
                                size_t rowbytes, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above, reconstructed
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + size_t(y) * (rowbytes + 1);
    const int filter = in[0];
    ++in;
    uint8_t* cur = out + size_t(y) * rowbytes;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = prev && i >= size_t(bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      cur[i] = uint8_t(in[i] + pred);
    }
    prev = cur;
  }
  return 0;
}

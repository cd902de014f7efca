// The native loader's centre crop and bilinear resize, as
// native/dataloader.cpp:173-218 computes them (float taps, rounded by
// + 0.5 and truncation), apart from the decoders so that a machine
// without libjpeg and libpng builds it too.

#include "crop_resize.h"

#include <cmath>
#include <cstring>

extern "C" void d3f_crop_resize(const uint8_t* src, int width, int height,
                                int target, uint8_t* out) {
  int side = width < height ? width : height;
  int x0 = (width - side) / 2;
  int y0 = (height - side) / 2;

  if (side == target) {  // a crop and copy
    for (int y = 0; y < target; ++y)
      memcpy(out + size_t(y) * target * 3,
             src + (size_t(y0 + y) * width + x0) * 3, size_t(target) * 3);
    return;
  }

  const float scale = float(side) / float(target);
  for (int y = 0; y < target; ++y) {
    float sy = (y + 0.5f) * scale - 0.5f + y0;
    int iy = int(floorf(sy));
    float fy = sy - iy;
    int y1 = iy < y0 ? y0 : (iy >= y0 + side ? y0 + side - 1 : iy);
    int y2 = y1 + 1 >= y0 + side ? y0 + side - 1 : y1 + 1;
    for (int x = 0; x < target; ++x) {
      float sx = (x + 0.5f) * scale - 0.5f + x0;
      int ix = int(floorf(sx));
      float fx = sx - ix;
      int x1 = ix < x0 ? x0 : (ix >= x0 + side ? x0 + side - 1 : ix);
      int x2 = x1 + 1 >= x0 + side ? x0 + side - 1 : x1 + 1;
      const uint8_t* p11 = src + (size_t(y1) * width + x1) * 3;
      const uint8_t* p12 = src + (size_t(y1) * width + x2) * 3;
      const uint8_t* p21 = src + (size_t(y2) * width + x1) * 3;
      const uint8_t* p22 = src + (size_t(y2) * width + x2) * 3;
      uint8_t* dst = out + (size_t(y) * target + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - fy) * ((1 - fx) * p11[c] + fx * p12[c]) +
                  fy * ((1 - fx) * p21[c] + fx * p22[c]);
        dst[c] = uint8_t(v + 0.5f);
      }
    }
  }
}

// Centre crop to a square and bilinear resize, RGB HWC uint8: the native
// loader's resize (its own translation unit: it needs no codec library).
#pragma once

#include <cstdint>

extern "C" void d3f_crop_resize(const uint8_t* src, int width, int height,
                                int target, uint8_t* out);

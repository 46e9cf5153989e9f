// RGB -> YCbCr 4:2:0 host conversion of decoded boards, byte for byte the
// numpy one of chess_vision_tpu_torch/ops/preprocess.py. Its own library:
// it needs no libjpeg, so it builds where the decoder cannot.
#include <cstddef>
#include <cstdint>

extern "C" {

// count uint8 (size, size, 3) RGB images -> their (Y, Cb, Cr) 4:2:0 planes,
// (count, size, size) and 2 x (count, size/2, size/2), byte for byte the
// numpy host conversion (rgb_to_ycbcr420): the same f32
// products and sums in the same order, each rounded (the library is built
// with -ffp-contract=off: no fused multiply-add), the 2x2 chroma mean as
// ((a + b) + (c + d)) / 4, then + 0.5, clipped to [0, 255] and truncated.
void rgb_to_ycbcr420(const uint8_t* rgb, int count, int size, uint8_t* y,
                     uint8_t* cb, uint8_t* cr) {
  const int half = size / 2;
  auto to_u8 = [](float v) {
    v = v + 0.5f;
    v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
    return static_cast<uint8_t>(v);
  };
  auto cb_of = [](const uint8_t* p) {
    const float r = p[0], g = p[1], b = p[2];
    return ((128.0f - 0.168736f * r) - 0.331264f * g) + 0.5f * b;
  };
  auto cr_of = [](const uint8_t* p) {
    const float r = p[0], g = p[1], b = p[2];
    return ((128.0f + 0.5f * r) - 0.418688f * g) - 0.081312f * b;
  };
  for (int n = 0; n < count; ++n) {
    const uint8_t* img = rgb + static_cast<size_t>(n) * size * size * 3;
    uint8_t* yn = y + static_cast<size_t>(n) * size * size;
    for (int i = 0; i < size * size; ++i) {
      const float r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      yn[i] = to_u8((0.299f * r + 0.587f * g) + 0.114f * b);
    }
    const size_t plane = static_cast<size_t>(n) * half * half;
    for (int py = 0; py < half; ++py) {
      const uint8_t* top = img + static_cast<size_t>(2 * py) * size * 3;
      const uint8_t* bottom = top + static_cast<size_t>(size) * 3;
      for (int px = 0; px < half; ++px) {
        const uint8_t *a = top + 6 * px, *b = a + 3, *c = bottom + 6 * px,
                      *d = c + 3;
        cb[plane + py * half + px] =
            to_u8(((cb_of(a) + cb_of(b)) + (cb_of(c) + cb_of(d))) / 4.0f);
        cr[plane + py * half + px] =
            to_u8(((cr_of(a) + cr_of(b)) + (cr_of(c) + cr_of(d))) / 4.0f);
      }
    }
  }
}

}  // extern "C"

// Fast JPEG decode + antialiased bilinear resize for the serving hot path.
//
// The reference's input pipeline decodes with PIL on dataloader worker
// processes (reference dataset.py:251-252, train.py:273-288). Here decode is
// a native routine called from Python threads via ctypes — the call releases
// the GIL, so a thread pool gets true parallelism without process fan-out.
//
// decode_resize(): libjpeg decompress -> RGB -> separable triangle-filter
// resize (PIL-style antialiasing on downscale) -> uint8 out_size x out_size.
//
// Build: native/__init__.py runs g++ -O3 -shared ... -ljpeg at first use, into
// the package's build directory.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs FILE/size_t declared first

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Separable triangle-filter resample, matching PIL's BILINEAR semantics:
// support widens by the scale factor on downscale (antialiasing), plain
// bilinear on upscale.
void resample_axis(const uint8_t* src, int src_w, int src_h, int channels,
                   int out_w, std::vector<uint8_t>* dst) {
  // resizes along the horizontal axis: (src_h, src_w, C) -> (src_h, out_w, C)
  dst->assign(static_cast<size_t>(src_h) * out_w * channels, 0);
  const double scale = static_cast<double>(src_w) / out_w;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;

  std::vector<int> bounds(out_w * 2);
  std::vector<double> weights;
  std::vector<int> woffsets(out_w + 1, 0);

  for (int xx = 0; xx < out_w; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(center - support + 0.5, 0.0));
    int xmax = static_cast<int>(
        std::min(center + support + 0.5, static_cast<double>(src_w)));
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
    double total = 0.0;
    size_t start = weights.size();
    for (int x = xmin; x < xmax; ++x) {
      double w = 1.0 - std::abs((x - center + 0.5) / filterscale);
      if (w < 0.0) w = 0.0;
      weights.push_back(w);
      total += w;
    }
    if (total > 0.0) {
      for (size_t i = start; i < weights.size(); ++i) weights[i] /= total;
    }
    woffsets[xx + 1] = static_cast<int>(weights.size());
  }

  for (int y = 0; y < src_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * src_w * channels;
    uint8_t* orow = dst->data() + static_cast<size_t>(y) * out_w * channels;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = bounds[xx * 2];
      const int xmax = bounds[xx * 2 + 1];
      const double* w = weights.data() + woffsets[xx];
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        for (int x = xmin; x < xmax; ++x) {
          acc += row[x * channels + c] * w[x - xmin];
        }
        int v = static_cast<int>(std::lround(acc));
        orow[xx * channels + c] =
            static_cast<uint8_t>(std::clamp(v, 0, 255));
      }
    }
  }
}

void transpose_hwc(const uint8_t* src, int h, int w, int channels,
                   std::vector<uint8_t>* dst) {
  dst->assign(static_cast<size_t>(h) * w * channels, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < channels; ++c) {
        (*dst)[(static_cast<size_t>(x) * h + y) * channels + c] =
            src[(static_cast<size_t>(y) * w + x) * channels + c];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on decode error.
// out must hold out_size*out_size*3 bytes.
int decode_resize(const uint8_t* data, long len, int out_size, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain pre-scaling: decode cheaply, but keep >=2x the target size so
  // the antialiased triangle resample still defines the final pixels.
  while (cinfo.scale_denom < 8 &&
         (cinfo.image_width / (cinfo.scale_denom * 2) >=
          static_cast<unsigned>(out_size) * 2)) {
    cinfo.scale_denom *= 2;
  }
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;
  std::vector<uint8_t> pixels(static_cast<size_t>(w) * h * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = pixels.data() +
                      static_cast<size_t>(cinfo.output_scanline) * w * ch;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (ch != 3) {  // grayscale -> RGB
    std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
    for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
      rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = pixels[i * ch];
    }
    pixels.swap(rgb);
  }

  if (w == out_size && h == out_size) {
    std::memcpy(out, pixels.data(), static_cast<size_t>(out_size) * out_size * 3);
    return 0;
  }

  // separable resize: horizontal, transpose, horizontal, transpose
  std::vector<uint8_t> tmp1, tmp2;
  resample_axis(pixels.data(), w, h, 3, out_size, &tmp1);       // (h, out, 3)
  transpose_hwc(tmp1.data(), h, out_size, 3, &tmp2);            // (out, h, 3)
  resample_axis(tmp2.data(), h, out_size, 3, out_size, &tmp1);  // (out, out, 3)
  transpose_hwc(tmp1.data(), out_size, out_size, 3, &tmp2);     // (out, out, 3)
  std::memcpy(out, tmp2.data(), static_cast<size_t>(out_size) * out_size * 3);
  return 0;
}

// Decode a 4:2:0 JPEG to raw subsampled planes WITHOUT chroma upsampling:
// out_y is size x size, out_cb/out_cr are (size/2) x (size/2). Only valid
// when the JPEG is exactly `size` square with 2x2 chroma subsampling —
// returns nonzero otherwise (caller falls back to decode_resize). Skipping
// the upsample both cuts decode work and halves the bytes shipped to the
// accelerator, which reconstructs RGB on-device.
int decode_ycbcr420(const uint8_t* data, long len, int size, uint8_t* out_y,
                    uint8_t* out_cb, uint8_t* out_cr) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);

  if (cinfo.image_width != static_cast<unsigned>(size) ||
      cinfo.image_height != static_cast<unsigned>(size) ||
      cinfo.num_components != 3 || cinfo.jpeg_color_space != JCS_YCbCr ||
      cinfo.comp_info[0].h_samp_factor != 2 ||
      cinfo.comp_info[0].v_samp_factor != 2 ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      size % 16 != 0) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  cinfo.raw_data_out = TRUE;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);

  const int half = size / 2;
  // raw_data_out delivers in MCU rows: 16 luma rows + 8 chroma rows at a time
  JSAMPROW y_rows[16], cb_rows[8], cr_rows[8];
  JSAMPARRAY planes[3] = {y_rows, cb_rows, cr_rows};
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y0 = cinfo.output_scanline;
    for (int i = 0; i < 16; ++i) {
      int row = std::min(y0 + i, size - 1);
      y_rows[i] = out_y + static_cast<size_t>(row) * size;
    }
    for (int i = 0; i < 8; ++i) {
      int row = std::min(y0 / 2 + i, half - 1);
      cb_rows[i] = out_cb + static_cast<size_t>(row) * half;
      cr_rows[i] = out_cr + static_cast<size_t>(row) * half;
    }
    jpeg_read_raw_data(&cinfo, planes, 16);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"

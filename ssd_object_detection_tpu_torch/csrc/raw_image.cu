// BMP, PxM, PAM, Sun raster, PFM, HDR and TIFF pixels, and GIF palette indices, on Hopper
// (sm_90a): kernel K8, launched once a decode call by ops/cuda_image.py::raw_expand over
// every such image of the call, after the host has read the files' headers and undone
// any RLE, PackBits or Deflate (data/codec.py::parse_bmp, parse_pxm, parse_pam,
// parse_sunras, parse_pfm, parse_hdr, parse_tiff; the batch: data/codec.py::raw_batch),
// K9 (gif_lzw.cu) has decoded the GIF frames' indices and the TIFFs' LZW chunks, the JPEG
// kernels the TIFFs' JPEG chunks, and K10 (tiff_assemble.cu) has undone the TIFF
// predictor and byte swap in place.
//
// Replaces no Pallas kernel: the JAX package reads these formats with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70-87, eval/serve.py:374-381). Its plain
// version, which it is held to bit for bit, is ops/plain_image.py::raw_expand: what
// cv2's readers (grfmt_bmp.cpp, grfmt_pxm.cpp, grfmt_pam.cpp, grfmt_sunras.cpp,
// grfmt_pfm.cpp, grfmt_hdr.cpp, grfmt_gif.cpp, grfmt_tiff.cpp through libtiff 4.7's RGBA
// put routines, tif_getimage.c and tif_color.c) give with IMREAD_COLOR, as RGB.
//
// Formats: outside the rows' window (a GIF frame smaller than its screen) palette entry
// 256; else the row's first byte from the row offset and signed stride (bottom-up files
// step backwards), then the pixel by format: palette indices of 1, 4 or 8 bits, 16-bit
// BGR 555/565 shifted up, BGR/BGRX/RGB/gray bytes, big-endian 16-bit RGB, BGR or gray
// samples' high byte, text samples clamped to maxval and scaled by 255 / maxval (>> 8
// past 255), float32 samples times the scale, RGBE quadruples as rgbe.cpp's rgbe2float
// (the mantissa times 2^(e - 136), 0 where e is 0) times 255; floats rounded half to even
// and saturated (cv2's saturate_cast: NaN, infinities and values past int32 give 0).
// A TIFF's samples are read straight from its chunks (no placed copy of the image): the
// chunk under the pixel from the chunk table (a strip's rows, a tile's row and column,
// each plane's own), its row `pitch` bytes apart (libtiff's skew in a tile cut at the
// right edge), zero past what the chunk holds (an unreadable later plane, a JPEG frame
// smaller than its chunk); then a 256-entry table (gray through BWmap: MinIsWhite
// inverted, 1-bit scaled, 16-bit by its high byte; palette through PALmap), RGB (16-bit
// samples as (v + 128) / 257; gray planes as R = G = B; unassociated alpha
// premultiplied as (v * a + 127) / 255), CMYK (R = (255 - K) * (255 - C) / 255), YCbCr
// (TIFFYCbCrtoRGB's integer lookups in TIFFYCbCrToRGBInit's tables and its clamp, the
// samples in data units of hs x vs Y, then Cb and Cr) or CIELab (TIFFCIELab16ToXYZ, then
// TIFFXYZToRGB through TIFFCIELabToRGBInit's tables for libtiff's sRGB display, in
// float32 in the C's order; -fmad=false keeps each product a product) or SGILog (K12's
// LogL and LogLuv words, SGILog24's raw pixels, by tif_luv.c's 8-bit conversions in
// double, exp from the host's tables). Every format then
// takes the orientation (csrc/orientation.cuh), each tile's columns mirrored where libtiff
// mirrors them.
//
// Bound: the bytes moved (rows in, RGB out), a few hundred kilobytes an image. So the
// design is about launches and stores: one launch for every image of a call (a CTA a tile
// of kTileRows x kTileCols output pixels of one image, found by a binary search over the
// images' first CTAs), the call's descriptors and bytes in one upload that the kernel
// reads as they are, the image's fields in registers, the image found by one warp's
// ballot over 32 images' first CTAs a load (a binary search of one thread made a chain
// of dependent loads every CTA waited on); a warp an output row of the tile, a lane every
// 32nd pixel of it, kPerLane pixels a lane whose loads are all issued before any of their
// stores (a first design computed eight pixels a lane one after another, each waiting on
// its loads: twice the old kernel's time on one image), so a warp's loads walk the source
// row together in orientations 1-4 (orientations 5-8 read a source column, strided); the
// row's RGB staged in shared memory and stored 16 bytes a lane from a 16-byte boundary
// (each image's RGB starts on one). A TIFF pixel finds its chunk once a plane.

#include <cuda_runtime.h>

#include <cstdint>

#include "orientation.cuh"

namespace {

constexpr int kTileRows = 8, kTileCols = 128;  // data/codec.py RAW_TILE: a warp a row
constexpr int kPerLane = kTileCols / 32;         // pixels a lane, their loads issued together
constexpr int kThreads = 32 * kTileRows;
constexpr int kRawInts = 32;    // data/codec.py RAW_INTS
constexpr int kChunkInts = 12;  // data/codec.py TIFF_CHUNK_INTS
constexpr int kLabRange = 1500, kLabHeader = 24;  // data/codec.py LAB_RANGE, LAB_HEADER
// data/codec.py RAW_*, TIFF_*_FORMAT
enum { kPal1, kPal4, kPal8, kBgr555, kBgr565, kBgr, kBgrx, kRgb, kGray, kRgb16, kGray16, kText, kFloat, kRgbe,
       kBgr16, kTiffLut, kTiffRgb, kTiffCmyk, kTiffYcbcr, kTiffLab, kTiffLogL, kTiffLogLuv, kTiffLogLuv24 };
// data/codec.py sgilog_tables: LogL16toY's doubles, LogL10toY's, then uv_row's pairs
constexpr int kY16 = 32768, kY10 = 1024, kUvRows = 163, kUvDivs = 16289;
// data/codec.py R_*: one image's fields
enum { kOut, kHeight, kWidth, kFmt, kOffset, kStride, kChannels, kMaxval, kBigEndian, kTop, kLeft, kWinH, kWinW,
       kOrientation, kColour, kAlpha, kPlanar, kMirror, kPalette, kScale, kAcross, kChunkW, kPerPlane, kTable, kHs, kVs,
       kTile, kTilesX, kOutH, kOutW };
// data/codec.py C_*: one TIFF chunk's fields (K8 reads the first five)
enum { kSrc, kJpeg, kPitch, kRowsHeld, kBytesHeld };

struct Source {
  const int* desc;      // the call's descriptor ints (the image table first)
  const uint8_t* data;  // the call's byte buffer (the same allocation)
  const uint8_t* jpeg;  // the JPEG kernels' output (a TIFF's JPEG chunks), or null
  int chunk_at;
};

// One TIFF pixel's row in its chunk of `plane`: where its bytes start, and how many it holds.
struct ChunkRow {
  const uint8_t* p;
  int held, r, col;
};

__device__ __forceinline__ ChunkRow chunk_row(const Source& s, const int* im, int plane, int y, int x,
                                              int rows_a_pitch) {
  const int rows = im[kStride], cw = im[kChunkW];
  const int cy = y / rows, cx = x / cw;
  const int* c = s.desc + s.chunk_at +
                 static_cast<long long>(im[kOffset] + plane * im[kPerPlane] + cy * im[kAcross] + cx) * kChunkInts;
  ChunkRow out;
  out.r = y - cy * rows;
  out.col = x - cx * cw;
  const uint8_t* base = c[kJpeg] ? s.jpeg : s.data;
  out.held = (base != nullptr && out.r < c[kRowsHeld]) ? c[kBytesHeld] : 0;  // 0: every byte reads as zero
  out.p = base == nullptr ? nullptr : base + c[kSrc] + static_cast<long long>(out.r / rows_a_pitch) * c[kPitch];
  return out;
}

__device__ __forceinline__ int held_byte(const ChunkRow& cr, int b) { return b < cr.held ? cr.p[b] : 0; }

// Sample c of a TIFF pixel of `bits` bits from its row in its chunk
// (ops/plain_image.py::tiff_samples): mode 0 the high byte of a 16-bit sample, 1 rounded to
// 8 bits ((v + 128) / 257), 2 whole.
__device__ __forceinline__ int tiff_sample(const ChunkRow& cr, const int* im, int bits, int c, int mode) {
  const bool planar = im[kPlanar] != 0;
  const int i = cr.col * im[kChannels] + (planar ? 0 : c);
  if (bits == 1) return (held_byte(cr, i >> 3) >> (7 - (i & 7))) & 1;
  if (bits == 4) return i & 1 ? held_byte(cr, i >> 1) & 15 : held_byte(cr, i >> 1) >> 4;
  if (bits == 8) return held_byte(cr, i);
  const int v = held_byte(cr, 2 * i) | (held_byte(cr, 2 * i + 1) << 8);
  return mode == 2 ? v : mode == 1 ? (v + 128) / 257 : v >> 8;
}

__device__ uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

__device__ __forceinline__ uint32_t pack(int r, int g, int b) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) | (static_cast<uint32_t>(b) << 16);
}

// TIFFYCbCrtoRGB: the tables Cr_r, Cb_b, Cr_g, Cb_g, Y (data/codec.py::ycbcr_tables)
__device__ uint32_t ycbcr_rgb(const int* t, int yy, int cb, int cr) {
  const int y = t[4 * 256 + yy];
  return pack(clamp255(y + t[cr]), clamp255(y + ((t[3 * 256 + cb] + t[2 * 256 + cr]) >> 16)),
              clamp255(y + t[256 + cb]));
}

// TIFFCIELab16ToXYZ from L (0-100), a* / 500 and b* / 200, then TIFFXYZToRGB, in float32 as
// the C evaluates each expression (data/codec.py::lab_tables holds the display and tables)
__device__ __noinline__ uint32_t lab_rgb(const float* t, float lum, float a, float b) {
  const float x0 = t[0], y0 = t[1], z0 = t[2];
  float yy, cby;
  if (lum < 8.856f) {
    yy = __fdiv_rn(__fmul_rn(lum, y0), 903.292f);
    cby = __fadd_rn(__fmul_rn(7.787f, __fdiv_rn(yy, y0)), 16.0f / 116.0f);
  } else {
    cby = __fdiv_rn(__fadd_rn(lum, 16.0f), 116.0f);
    yy = __fmul_rn(__fmul_rn(__fmul_rn(y0, cby), cby), cby);
  }
  float xz[2];
  const float tmp[2] = {__fadd_rn(a, cby), __fsub_rn(cby, b)};
  const float w[2] = {x0, z0};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    xz[k] = tmp[k] < 0.2069f ? __fdiv_rn(__fmul_rn(w[k], __fsub_rn(tmp[k], 0.13793f)), 7.787f)
                             : __fmul_rn(__fmul_rn(__fmul_rn(w[k], tmp[k]), tmp[k]), tmp[k]);
  uint32_t rgb = 0;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float* h = t + 3 + 7 * g;  // matrix row, black, white, step, Vrw
    float v = __fadd_rn(__fadd_rn(__fmul_rn(h[0], xz[0]), __fmul_rn(h[1], yy)), __fmul_rn(h[2], xz[1]));
    v = fminf(fmaxf(v, h[3]), h[4]);
    const int i = min(kLabRange, static_cast<int>(__fdiv_rn(__fsub_rn(v, h[3]), h[5])));
    const double level = t[kLabHeader + g * (kLabRange + 1) + i];
    const unsigned int r = static_cast<unsigned int>(level > 0 ? level + 0.5 : level - 0.5);
    rgb |= min(r, static_cast<unsigned int>(h[6])) << (8 * g);
  }
  return rgb;
}

// SGILog as libtiff's 8-bit output (tif_luv.c, ops/plain_image.py::logl_gray,
// logluv_rgb): doubles in the C's order (-fmad=false), X, Y and Z rounded to float, exp
// from the host's tables, sqrt exact
__device__ __forceinline__ int gamma_byte(double v) {
  return v <= 0.0 ? 0 : v >= 1.0 ? 255 : static_cast<int>(__dmul_rn(256.0, __dsqrt_rn(v)));
}

__device__ __forceinline__ double logl_y(const double* y16, int p16) {
  const double y = y16[p16 & 0x7fff];
  return p16 & 0x8000 ? -y : y;
}

__device__ uint32_t xyz_rgb24(double lum, double u, double v) {  // LogLuv*toXYZ from L, u', v', then XYZtoRGB24
  if (lum <= 0.0) return 0;
  const double s = __ddiv_rn(1.0, __dadd_rn(__dsub_rn(__dmul_rn(6.0, u), __dmul_rn(16.0, v)), 12.0));
  const double x = __dmul_rn(__dmul_rn(9.0, u), s), y = __dmul_rn(__dmul_rn(4.0, v), s);
  const double X = __double2float_rn(__dmul_rn(__ddiv_rn(x, y), lum));
  const double Y = __double2float_rn(lum);
  const double Z = __double2float_rn(__dmul_rn(__ddiv_rn(__dsub_rn(__dsub_rn(1.0, x), y), y), lum));
  const double r = __dadd_rn(__dadd_rn(__dmul_rn(2.690, X), __dmul_rn(-1.276, Y)), __dmul_rn(-0.414, Z));
  const double g = __dadd_rn(__dadd_rn(__dmul_rn(-1.022, X), __dmul_rn(1.978, Y)), __dmul_rn(0.044, Z));
  const double b = __dadd_rn(__dadd_rn(__dmul_rn(0.061, X), __dmul_rn(-0.224, Y)), __dmul_rn(1.163, Z));
  return pack(gamma_byte(r), gamma_byte(g), gamma_byte(b));
}

__device__ __noinline__ uint32_t logluv_rgb(const int* t, uint32_t p, bool packed24) {
  const double* y16 = reinterpret_cast<const double*>(t);
  if (!packed24) {
    const double inv = 1.0 / 410.0;  // 1. / UVSCALE
    return xyz_rgb24(logl_y(y16, static_cast<int>(p >> 16)), __dmul_rn(inv, static_cast<double>((p >> 8) & 0xff) + 0.5),
                     __dmul_rn(inv, static_cast<double>(p & 0xff) + 0.5));
  }
  const double lum = reinterpret_cast<const double*>(t + 2 * kY16)[(p >> 14) & 0x3ff];
  const int ce = static_cast<int>(p & 0x3fff);
  double u = 0.210526316, v = 0.473684211;  // U_NEU, V_NEU: uv_decode fails
  if (ce < kUvDivs) {  // uv_decode: the last row whose squares before it are at most ce
    const int* uv = t + 2 * (kY16 + kY10);
    int lower = 0, upper = kUvRows;
    while (upper - lower > 1) {
      const int mid = (lower + upper) >> 1;
      if (uv[2 * mid + 1] <= ce) lower = mid; else upper = mid;
    }
    const double sq = static_cast<double>(0.0035f);  // UV_SQSIZ
    u = __dadd_rn(static_cast<double>(__int_as_float(uv[2 * lower])),
                  __dmul_rn(static_cast<double>(ce - uv[2 * lower + 1]) + 0.5, sq));
    v = __dadd_rn(static_cast<double>(0.016940f), __dmul_rn(static_cast<double>(lower) + 0.5, sq));
  }
  return xyz_rgb24(lum, u, v);
}

__device__ uint8_t saturate(float v) {
  if (!(fabsf(v) < 2147483648.0f)) return 0;
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

__device__ uint8_t from_float(const uint8_t* p, bool big_endian, float scale) {
  const unsigned int w = big_endian ? (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
                                    : (p[3] << 24) | (p[2] << 16) | (p[1] << 8) | p[0];
  return saturate(__fmul_rn(__uint_as_float(w), scale));
}

// (float)ldexp(1.0, k) for k in [-135, 119]: exact, subnormal below -126
__device__ float pow2(int k) {
  return k >= -126 ? __int_as_float((k + 127) << 23) : __int_as_float(1 << (k + 149));
}

__device__ uint8_t from_text(const uint8_t* p, int maxval) {
  const int v = min(static_cast<int>(p[0] | (p[1] << 8)), maxval);
  return static_cast<uint8_t>(maxval < 256 ? v * 255 / maxval : v >> 8);
}

// The orientation (csrc/orientation.cuh) as the affine map it is: source (y, x) = (m[0] +
// m[1] oy + m[2] ox, m[3] + m[4] oy + m[5] ox), from three points of it.
__device__ __forceinline__ void orientation_map(int orientation, int h, int w, int* m) {
  int y[3], x[3];
  orientation_source(orientation, h, w, 0, 0, &y[0], &x[0]);
  orientation_source(orientation, h, w, 1, 0, &y[1], &x[1]);
  orientation_source(orientation, h, w, 0, 1, &y[2], &x[2]);
  m[0] = y[0], m[1] = y[1] - y[0], m[2] = y[2] - y[0];
  m[3] = x[0], m[4] = x[1] - x[0], m[5] = x[2] - x[0];
}

// The RGB of output pixel (oy, ox) of image `im` (the image's fields, in registers), packed
// R | G << 8 | B << 16: format F and bits B where the caller knows them (-1: the image's),
// so that the code is straight-line and a lane's pixels' loads issue together; `outside`
// is palette entry 256, for pixels outside the rows' window.
template <int F, int B>
__device__ __forceinline__ uint32_t pixel(const Source& s, const int* im, const int* m, uint32_t outside, int oy,
                                          int ox) {
  const int width = im[kWidth];
  int y = m[0] + m[1] * oy + m[2] * ox, x = m[3] + m[4] * oy + m[5] * ox;
  const int mirror = im[kMirror];
  if (mirror) {  // each tile's shown columns in reverse order
    const int x0 = x - x % mirror;
    x = x0 + min(mirror, width - x0) - 1 - (x - x0);
  }
  const uint8_t* palette = s.data + im[kPalette];
  const bool inside = y >= im[kTop] && y < im[kTop] + im[kWinH] && x >= im[kLeft] && x < im[kLeft] + im[kWinW];
  y = min(max(y - im[kTop], 0), im[kWinH] - 1);  // read inside the window whatever the pixel shows
  x = min(max(x - im[kLeft], 0), im[kWinW] - 1);
  const int fmt = F >= 0 ? F : im[kFmt], channels = im[kChannels], maxval = B >= 0 ? B : im[kMaxval];
  const uint8_t* row = s.data + im[kOffset] + static_cast<long long>(y) * im[kStride];
  // a TIFF's samples: each plane's chunk row once (contiguous samples share the first)
  const bool planar = im[kPlanar] != 0;
  const ChunkRow first = fmt >= kTiffLut ? chunk_row(s, im, 0, y, x, fmt == kTiffYcbcr && !planar ? im[kVs] : 1)
                                         : ChunkRow{nullptr, 0, 0, 0};
  auto tiff = [&](int c, int mode) {
    return tiff_sample(planar && c ? chunk_row(s, im, c, y, x, 1) : first, im, maxval, c, mode);
  };
  int rgb[3];
  int index = -1;
  switch (fmt) {
    case kPal1: index = (row[x >> 3] >> (7 - (x & 7))) & 1; break;
    case kPal4: index = x & 1 ? row[x >> 1] & 15 : row[x >> 1] >> 4; break;
    case kPal8: index = row[x]; break;
    case kBgr555:
    case kBgr565: {
      const int t = row[2 * x] | (row[2 * x + 1] << 8);
      rgb[2] = (t << 3) & 255;
      rgb[1] = fmt == kBgr555 ? (t >> 2) & 0xF8 : (t >> 3) & 0xFC;
      rgb[0] = fmt == kBgr555 ? (t >> 7) & 0xF8 : (t >> 8) & 0xF8;
      break;
    }
    case kBgr:
    case kBgrx: {
      const uint8_t* p = row + (fmt == kBgr ? 3 : 4) * x;
      rgb[0] = p[2];
      rgb[1] = p[1];
      rgb[2] = p[0];
      break;
    }
    case kRgb:
      for (int c = 0; c < 3; ++c) rgb[c] = row[3 * x + c];
      break;
    case kGray: rgb[0] = rgb[1] = rgb[2] = row[x]; break;
    case kRgb16:
      for (int c = 0; c < 3; ++c) rgb[c] = row[6 * x + 2 * c];
      break;
    case kBgr16:
      for (int c = 0; c < 3; ++c) rgb[c] = row[6 * x + 4 - 2 * c];
      break;
    case kGray16: rgb[0] = rgb[1] = rgb[2] = row[2 * x]; break;
    case kText:
      for (int c = 0; c < 3; ++c) rgb[c] = from_text(row + 2 * (channels * x + (channels == 3 ? c : 0)), maxval);
      break;
    case kFloat:
      for (int c = 0; c < 3; ++c)
        rgb[c] = from_float(row + 4 * (channels * x + (channels == 3 ? c : 0)), im[kBigEndian] != 0,
                            __int_as_float(im[kScale]));
      break;
    case kRgbe: {
      const uint8_t* p = row + 4 * x;
      const float f = pow2(p[3] - 136);
      for (int c = 0; c < 3; ++c) rgb[c] = p[3] ? saturate(__fmul_rn(__fmul_rn(static_cast<float>(p[c]), f), 255.0f)) : 0;
      break;
    }
    case kTiffLut: index = tiff(0, 0); break;
    case kTiffRgb: {
      const int alpha = im[kAlpha];
      const int a = alpha >= 0 ? tiff(alpha, 1) : 0;
      for (int c = 0; c < 3; ++c) {
        const int v = tiff(im[kColour] == 3 ? c : 0, 1);
        rgb[c] = alpha >= 0 ? (v * a + 127) / 255 : v;
      }
      break;
    }
    case kTiffCmyk: {
      const int k = 255 - tiff(3, 1);
      for (int c = 0; c < 3; ++c) rgb[c] = k * (255 - tiff(c, 1)) / 255;
      break;
    }
    case kTiffYcbcr: {
      const int* t = s.desc + im[kTable];
      if (planar) return inside ? ycbcr_rgb(t, tiff(0, 0), tiff(1, 0), tiff(2, 0)) : outside;
      const int hs = im[kHs], vs = im[kVs];  // a data unit: hs x vs Y samples, then Cb and Cr
      const uint8_t* u = first.p + (first.col / hs) * (hs * vs + 2);
      return inside ? ycbcr_rgb(t, u[(first.r % vs) * hs + first.col % hs], u[hs * vs], u[hs * vs + 1]) : outside;
    }
    case kTiffLogL:
    case kTiffLogLuv:
    case kTiffLogLuv24: {  // a pixel's word in its chunk row (K12's little-endian words, LogLuv24's raw bytes)
      const int* t = s.desc + im[kTable];
      const int word = fmt == kTiffLogL ? 2 : fmt == kTiffLogLuv ? 4 : 3;
      uint32_t p = 0;
      for (int i = 0; i < word; ++i) {
        const uint32_t b = static_cast<uint32_t>(held_byte(first, first.col * word + i));
        p |= fmt == kTiffLogLuv24 ? b << (8 * (2 - i)) : b << (8 * i);
      }
      if (!inside) return outside;
      if (fmt == kTiffLogL) {
        const int g = gamma_byte(logl_y(reinterpret_cast<const double*>(t), static_cast<int>(p)));
        return pack(g, g, g);
      }
      return logluv_rgb(t, p, fmt == kTiffLogLuv24);
    }
    default: {  // kTiffLab: putcontig8bitCIELab8 (values scaled to 16 bits) or putcontig8bitCIELab16
      const float* t = reinterpret_cast<const float*>(s.desc + im[kTable]);
      int l = tiff(0, 2), a = tiff(1, 2), b = tiff(2, 2);
      if (maxval == 16) {
        a = static_cast<int16_t>(a);
        b = static_cast<int16_t>(b);
      } else {
        l *= 257;
        a = static_cast<int8_t>(a) * 256;
        b = static_cast<int8_t>(b) * 256;
      }
      return inside ? lab_rgb(t, __fdiv_rn(__fmul_rn(static_cast<float>(l), 100.0f), 65535.0f),
                              __fdiv_rn(__fdiv_rn(static_cast<float>(a), 256.0f), 500.0f),
                              __fdiv_rn(__fdiv_rn(static_cast<float>(b), 256.0f), 200.0f))
                    : outside;
    }
  }
  if (!inside) return outside;
  if (index >= 0) return pack(palette[3 * index], palette[3 * index + 1], palette[3 * index + 2]);
  return pack(rgb[0], rgb[1], rgb[2]);
}

// A lane's kPerLane pixels of output row oy from column ox0 (a lane every 32nd; past the
// row's n pixels, its last again, not stored).
template <int F, int B>
__device__ __forceinline__ void row_pixels(const Source& s, const int* im, const int* m, uint32_t outside, int oy,
                                           int ox0, int lane, int n, uint32_t* rgb) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) rgb[k] = pixel<F, B>(s, im, m, outside, oy, ox0 + min(lane + 32 * k, n - 1));
}

__global__ void __launch_bounds__(kThreads)
    raw_kernel(const uint8_t* __restrict__ buffer, const uint8_t* __restrict__ jpeg, int nimages, int chunk_at,
               uint8_t* __restrict__ out) {
  __shared__ int im_shared[kRawInts];
  __shared__ __align__(16) uint8_t stage[kTileRows][3 * kTileCols];
  const int* desc = reinterpret_cast<const int*>(buffer);
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // the last image whose first CTA is at or before this one, 32 images a load
    int found = 0;
    for (int i0 = 0; nimages > 1 && i0 < nimages; i0 += 32) {
      const unsigned int before =
          __ballot_sync(0xffffffffu, i0 + lane < nimages && desc[(i0 + lane) * kRawInts + kTile] <= tile);
      if (before) found = i0 + 31 - __clz(before);
      if (before != 0xffffffffu) break;  // the images are in the order of their CTAs
    }
    im_shared[lane] = desc[found * kRawInts + lane];  // kRawInts == 32: a field a lane
  }
  __syncthreads();
  int im[kRawInts];  // in registers: every use below indexes it by a constant
#pragma unroll
  for (int i = 0; i < kRawInts; ++i) im[i] = im_shared[i];
  const int t = tile - im[kTile], tiles_x = im[kTilesX];
  const int oy = (t / tiles_x) * kTileRows + warp, ox0 = (t % tiles_x) * kTileCols;
  const int oh = im[kOutH], ow = im[kOutW];
  if (oy >= oh) return;
  const int n = min(kTileCols, ow - ox0);
  const Source s{desc, buffer, jpeg, chunk_at};
  uint8_t* st = stage[warp];
  int m[6];
  orientation_map(im[kOrientation], im[kHeight], im[kWidth], m);
  const uint8_t* palette = buffer + im[kPalette];
  const uint32_t outside = pack(palette[3 * 256], palette[3 * 256 + 1], palette[3 * 256 + 2]);
  uint32_t rgb[kPerLane];  // every pixel's loads before any store; the common formats' code straight-line
  const int fmt = im[kFmt], bits = im[kMaxval];
  if (fmt == kBgr) row_pixels<kBgr, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kBgrx) row_pixels<kBgrx, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kRgb) row_pixels<kRgb, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kGray) row_pixels<kGray, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kPal8) row_pixels<kPal8, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kTiffRgb && bits == 8) row_pixels<kTiffRgb, 8>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else if (fmt == kTiffLut && bits == 8) row_pixels<kTiffLut, 8>(s, im, m, outside, oy, ox0, lane, n, rgb);
  else row_pixels<-1, -1>(s, im, m, outside, oy, ox0, lane, n, rgb);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int q = lane + 32 * k;
    if (q < n) {
      st[3 * q] = static_cast<uint8_t>(rgb[k]);
      st[3 * q + 1] = static_cast<uint8_t>(rgb[k] >> 8);
      st[3 * q + 2] = static_cast<uint8_t>(rgb[k] >> 16);
    }
  }
  __syncwarp();
  // the staged row out: 16-byte stores where aligned, bytes at the ends
  uint8_t* dst = out + im[kOut] + 3 * (static_cast<long long>(oy) * ow + ox0);
  const int row_bytes = 3 * n;
  const int head = min(row_bytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  const int body = (row_bytes - head) & ~15;
  for (int k = lane; k < head; k += 32) dst[k] = st[k];
  for (int k = head + 16 * lane; k < head + body; k += 16 * 32) {
    uint4 v;
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = st[k + j];
    *reinterpret_cast<uint4*>(dst + k) = v;
  }
  for (int k = head + body + lane; k < row_bytes; k += 32) dst[k] = st[k];
}

}  // namespace

extern "C" {

// K8: every image of a decode call (data/codec.py::RawBatch): `buffer` its device buffer
// (the descriptor ints, then the bytes, then K9's output), `jpeg` the JPEG kernels' output
// holding the TIFFs' JPEG chunks (null: they read as zero), `tiles` the CTAs (RAW_TILE
// output pixels each), `out` the call's RGB, each image at its byte offset.
int ssd_raw_expand(const uint8_t* buffer, const uint8_t* jpeg, int nimages, int chunk_at, int tiles, uint8_t* out,
                   void* stream) {
  if (nimages < 1 || tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  raw_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(buffer, jpeg, nimages, chunk_at, out);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// SGILog TIFF chunks on Hopper (sm_90a), K12: each chunk's run-length byte planes -> its
// pixels' words (LogL's 16 bits, LogLuv's 32, little-endian), launched by
// ops/cuda_image.py::sgilog_decode after the host has walked the TIFF and cut it into
// chunks (data/codec.py::parse_tiff, _sgilog_tiff, raw_batch). K8 (raw_image.cu) then
// turns each word into bytes through the chunk table, as libtiff's 8-bit SGILog output.
//
// Replaces no Pallas kernel: the JAX package reads TIFFs with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70, eval/serve.py:379), whose libtiff 4.7
// decodes SGILog. Its plain version, which it is held to bit for bit, is
// ops/plain_image.py::sgilog_decode (sgilog_rows), tif_luv.c's LogL16Decode and
// LogLuvDecode32 step by step: a row at a time from where the last one stopped, its byte
// planes highest first, each a run of control bytes (128 + n - 2: the next byte n times;
// below 128: that many bytes as they are, `while (--cc && rc-- && i < npixels)`; 0 a
// no-op); a row whose data runs out before a plane is whole stays zero, and so does the
// rest of its chunk (libtiff skips its conversion and decodes no more of the chunk).
//
// Design: a warp a chunk, all of a call's chunks in one launch. The rows are serial in the
// byte stream, and so are a row's planes, so lane 0 walks the control bytes, kSegs runs
// at a time, into a list in shared memory (a run's first pixel, its pixels, its byte or
// where its bytes start), and the warp then writes their pixels' bytes, a lane every 32nd
// pixel of a run. What bounds it: lane 0's walk of the control bytes, one dependent load a
// run; the bytes moved are a few kilobytes a chunk.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// data/codec.py SGI_INTS, G_* (one stream, a chunk)
enum Stream { kSrc, kBytes, kWord, kRows, kWidth, kOut, kSgiInts };
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kSegs = 128;  // runs lane 0 lists before the warp writes them
enum Walk { kMore, kWhole, kShort };  // a plane's walk: runs left, the plane whole, its data ran out

__global__ void __launch_bounds__(kThreads)
    sgilog_kernel(uint8_t* __restrict__ buffer, int sgi_at, int sgis) {
  __shared__ int seg_at[kWarps][kSegs], seg_n[kWarps][kSegs], seg_src[kWarps][kSegs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= sgis) return;
  const int* s = reinterpret_cast<const int*>(buffer) + sgi_at + k * kSgiInts;
  const uint8_t* raw = buffer + s[kSrc];
  const int word = s[kWord], rows = s[kRows], width = s[kWidth];
  uint8_t* out = buffer + s[kOut];
  int* at = seg_at[warp];
  int* cnt = seg_n[warp];
  int* src = seg_src[warp];
  int bp = 0, cc = s[kBytes];  // lane 0's: the next byte, the bytes left (libtiff's rawcp, rawcc)
  for (int row = 0; row < rows; ++row) {
    uint8_t* w = out + static_cast<long long>(row) * width * word;
    int walk = kWhole;
    for (int plane = word - 1; plane >= 0 && walk != kShort; --plane) {  // the highest byte first
      int i = 0;  // lane 0's: the plane's next pixel
      walk = kMore;
      while (walk == kMore) {
        int segs = 0;
        if (lane == 0) {
          while (segs < kSegs) {
            if (i >= width || cc <= 0) {
              walk = i == width ? kWhole : kShort;
              break;
            }
            const int c = raw[bp];
            int m;
            if (c >= 128) {  // a run of one byte
              if (cc < 2) {
                walk = kShort;
                break;
              }
              m = min(c + 2 - 128, width - i);
              src[segs] = -1 - raw[bp + 1];
              bp += 2;
              cc -= 2;
            } else {  // c bytes as they are: while (--cc && rc-- && i < npixels)
              m = max(0, min(min(c, width - i), cc - 1));
              src[segs] = bp + 1;
              bp += 1 + m;
              cc -= m + 1;
            }
            if (m > 0) {
              at[segs] = i;
              cnt[segs] = m;
              ++segs;
            }
            i += m;
          }
        }
        segs = __shfl_sync(0xffffffffu, segs, 0);
        walk = __shfl_sync(0xffffffffu, walk, 0);
        __syncwarp();
        for (int g = 0; g < segs; ++g) {
          const int first = at[g], n = cnt[g], from = src[g];
          for (int p = lane; p < n; p += 32) {
            w[static_cast<long long>(first + p) * word + plane] =
                from < 0 ? static_cast<uint8_t>(-1 - from) : raw[from + p];
          }
        }
        __syncwarp();
      }
    }
    if (walk == kShort) {  // the row failed: it stays zero, and so does the rest of the chunk
      for (int b = lane; b < width * word; b += 32) w[b] = 0;
      return;
    }
  }
}

}  // namespace

extern "C" {

// K12: the K12 streams (SGI_INTS ints each, at int sgi_at of `buffer`'s descriptors)
// decode into `buffer` (their outputs zero before).
int ssd_sgilog_decode(uint8_t* buffer, int sgi_at, int sgis, void* stream) {
  if (sgis < 1) return static_cast<int>(cudaErrorInvalidValue);
  sgilog_kernel<<<(sgis + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(buffer, sgi_at,
                                                                                                  sgis);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

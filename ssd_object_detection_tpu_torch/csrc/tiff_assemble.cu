// TIFF chunks' predictor and byte order on Hopper (sm_90a), K10: in place, in a decode
// call's device buffer (data/codec.py::RawBatch), every TIFF chunk of the call that has a
// horizontal predictor or 16-bit samples of a big-endian file, decoded by the host or,
// LZW, by K9 in csrc/gif_lzw.cu; launched by ops/cuda_image.py::tiff_assemble, and not at
// all where no chunk of the call needs it. K8 (raw_image.cu) then reads each TIFF's samples
// straight from its chunks (no image buffer, no placed copy, no zero fill).
//
// Replaces no Pallas kernel: the JAX package reads TIFFs with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70-87, eval/serve.py:374-381). Its plain
// version, which it is held to bit for bit, is ops/plain_image.py::tiff_assemble: what
// libtiff 4.7 does to a decoded chunk before cv2's RGBA read puts it: the 16-bit samples
// of a big-endian file swapped to the host's order, the horizontal predictor undone
// (tif_predict.c horAcc8 / horAcc16: each sample plus the one a pixel before it, mod 2^8
// or 2^16), neither where the chunk's decoding failed (K9's status for an LZW chunk).
//
// One warp a row, over every row of the call's listed chunks (a warp finds its chunk and
// row in one load of the rows' table; a binary search over the list, a chain of dependent
// loads, took a third of the kernel's time on one TIFF). The predictor is a prefix sum along
// the row; a serial walk of 32-pixel shuffle scans (a first design) took longer than the
// placing kernel it replaced, 20 dependent steps a 640-pixel row. So a warp takes a window
// of kStageBytes of its row into shared memory (loads coalesced, a byte a lane, kCopy of
// them in flight a lane: a load then its store in turn made the copy a chain), each lane
// sums its share of consecutive pixels' samples, one shuffle scan of the lanes' sums gives
// each lane its start (the window's carry added), each lane writes its pixels' running
// sums back, and the window goes out coalesced: one window for a row of up to 1,344 8-bit
// RGB pixels, split over all 32 lanes (a lane's share is the serial part: on cv2's 640x480
// TIFF, 42 pixels a lane with 16 lanes idle took 0.0183 ms, 20 a lane 0.0117), 32 KB of
// stage a CTA so that seven CTAs share an SM. The bytes moved bound it (each row read and
// written once).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 4096;             // a warp's window of its row in shared memory
constexpr int kCopy = 32;                     // bytes a lane moves at once
constexpr int kChunkInts = 12;  // data/codec.py TIFF_CHUNK_INTS
constexpr int kWorkInts = 2;    // data/codec.py K10_WORK_INTS: the chunk, rows before it
constexpr int kRowInts = 2;     // data/codec.py K10_ROW_INTS: a row's chunk, its row there
// data/codec.py C_*: the fields K10 reads
enum { kSrc = 0, kRows = 5, kRowBytes = 6, kWidth = 7, kSamples = 8, kPredictor = 9, kSwab = 10, kStream = 11 };
constexpr int kOk = 0;  // data/codec.py GIF_OK

// A window's `bytes` bytes from `from` to `to`, a byte a lane, kCopy loads issued before
// their stores (a loop of a load then its store waits on every load in turn).
__device__ __forceinline__ void copy_window(const uint8_t* from, uint8_t* to, int bytes, int lane) {
  for (int i0 = 0; i0 < bytes; i0 += 32 * kCopy) {
    uint8_t v[kCopy];
#pragma unroll
    for (int j = 0; j < kCopy; ++j) {
      const int i = i0 + 32 * j + lane;
      v[j] = i < bytes ? from[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kCopy; ++j) {
      const int i = i0 + 32 * j + lane;
      if (i < bytes) to[i] = v[j];
    }
  }
}

// Sample s of pixel q of a staged window: 16 bits (in the file's byte order where `swab`)
// or 8.
__device__ __forceinline__ unsigned int staged(const uint8_t* st, int q, int s, int samples, bool wide, bool swab) {
  const int i = q * samples + s;
  if (!wide) return st[i];
  return swab ? (st[2 * i] << 8) | st[2 * i + 1] : st[2 * i] | (st[2 * i + 1] << 8);
}

__global__ void __launch_bounds__(kThreads)
    predictor_kernel(uint8_t* __restrict__ buffer, int chunk_at, int work_at, int works, int rows,
                     const int* __restrict__ status) {
  __shared__ __align__(16) uint8_t stage[kWarps][kStageBytes];
  const int* desc = reinterpret_cast<const int*>(buffer);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= rows) return;  // the same for the whole warp
  const int* entry = desc + work_at + works * kWorkInts + static_cast<long long>(g) * kRowInts;  // after the list
  const int* c = desc + chunk_at + static_cast<long long>(entry[0]) * kChunkInts;
  if (c[kStream] >= 0 && status[c[kStream]] != kOk) return;  // as it decoded, as libtiff leaves it
  const int r = entry[1];
  uint8_t* row = buffer + c[kSrc] + static_cast<long long>(r) * c[kRowBytes];
  const int width = c[kWidth], samples = c[kSamples], predictor = c[kPredictor];
  const bool swab = c[kSwab] != 0, wide = predictor == 16 || (predictor == 0 && swab);
  const unsigned int mask = wide ? 0xffffu : 0xffu;
  const int pixel_bytes = samples * (wide ? 2 : 1);
  // a lane's pixels: as few as the row needs (every lane busy), at most what the stage holds
  const int per_lane = min(kStageBytes / (32 * pixel_bytes), (width + 31) / 32), window = 32 * per_lane;
  uint8_t* st = stage[warp];
  unsigned int carry[4] = {0u, 0u, 0u, 0u};
  for (int p0 = 0; p0 < width; p0 += window) {
    const int n = min(window, width - p0), bytes = n * pixel_bytes;
    uint8_t* g_row = row + static_cast<long long>(p0) * pixel_bytes;
    copy_window(g_row, st, bytes, lane);
    __syncwarp();
    const int q0 = lane * per_lane, q1 = min(q0 + per_lane, n);
    unsigned int start[4] = {0u, 0u, 0u, 0u};
    if (predictor) {
      unsigned int sum[4] = {0u, 0u, 0u, 0u};
      for (int q = q0; q < q1; ++q) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (s < samples) sum[s] += staged(st, q, s, samples, wide, swab);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // the lanes before this one, and the windows before this one
        unsigned int incl = sum[s];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        start[s] = carry[s] + incl - sum[s];
        carry[s] = (carry[s] + __shfl_sync(0xffffffffu, incl, 31)) & mask;
      }
    }
    __syncwarp();  // every lane has read its window before any writes
    for (int q = q0; q < q1; ++q) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < samples) {
          const unsigned int v = staged(st, q, s, samples, wide, swab);
          start[s] += predictor ? v : 0u;
          const unsigned int out = (predictor ? start[s] : v) & mask;
          const int i = q * samples + s;
          if (wide) {
            st[2 * i] = static_cast<uint8_t>(out);
            st[2 * i + 1] = static_cast<uint8_t>(out >> 8);
          } else {
            st[i] = static_cast<uint8_t>(out);
          }
        }
      }
    }
    __syncwarp();
    copy_window(st, g_row, bytes, lane);
    __syncwarp();  // before the next window's loads reuse the stage
  }
}

}  // namespace

extern "C" {

// K10: the `works` listed chunks (data/codec.py::RawBatch: the chunk table at int
// `chunk_at`, the list at int `work_at` of `buffer`, each row's chunk and row there after the
// list), `rows` rows in all, a warp each;
// status: K9's, a stream (null where the call has no LZW chunk).
int ssd_tiff_assemble(uint8_t* buffer, int chunk_at, int work_at, int works, int rows, const int* status,
                      void* stream) {
  if (works < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  predictor_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buffer, chunk_at, work_at, works, rows, status);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// TIFF chunk assembly on Hopper (sm_90a), K10: every TIFF chunk of a batch (a strip or a
// tile of one plane, decoded by the host or, LZW, by K9 in csrc/gif_lzw.cu, or, JPEG, by
// the JPEG kernels into their RGB output) -> its image's buffer, launched by
// ops/cuda_image.py::tiff_assemble. K8 (raw_image.cu) then turns each image buffer into RGB.
//
// Replaces no Pallas kernel: the JAX package reads TIFFs with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70-87, eval/serve.py:374-381). Its plain
// version, which it is held to bit for bit, is ops/plain_image.py::tiff_assemble: what
// libtiff 4.7 does to a decoded chunk before cv2's RGBA read places it: the horizontal
// predictor undone (tif_predict.c horAcc8 / horAcc16: each sample plus the one a pixel
// before it, mod 2^8 or 2^16), the 16-bit samples of a big-endian file swapped to the
// host's order, neither where the chunk's decoding failed (K9's status for an LZW chunk),
// then the rows placed in the chunk's rectangle, cut at the image's edge, read `pitch`
// bytes apart (libtiff's put routines skew a tile cut at the right edge). A JPEG chunk's
// rows are read from the JPEG kernels' RGB output, its frame's rows `pitch` bytes apart and
// every `jpeg_step`-th byte of them (3: a gray chunk's one sample), as many as the frame
// holds: what it lacks of the chunk stays zero, as libtiff leaves it.
//
// One CTA a chunk, a warp a row: the predictor is a prefix sum along the row, a pixel a
// lane (up to four samples), a shuffle scan over 32 pixels at a time with the last lane's
// sums carried, in place in the decoded rows; after a barrier, the warps copy the placed
// rows out, consecutive lanes on consecutive bytes. The bytes moved bound it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkInts = 13;  // data/codec.py TIFF_CHUNK_INTS
enum { kSrc, kRows, kRowBytes, kDst, kStride, kPlaced, kPredictor, kSamples, kSwab, kStream, kWidth, kPitch,
       kJpegStep };
constexpr int kOk = 0;  // data/codec.py GIF_OK

// One decoded row: 16-bit samples swapped where `swab`, then (predictor 8 or 16) each
// sample summed with the ones a pixel before it, in place.
__device__ void undo_row(uint8_t* row, int width, int samples, int predictor, bool swab, int lane) {
  const bool wide = predictor == 16 || (predictor == 0 && swab);
  const unsigned int mask = wide ? 0xffffu : 0xffu;
  unsigned int carry[4] = {0u, 0u, 0u, 0u};
  for (int p0 = 0; p0 < width; p0 += 32) {
    const int p = p0 + lane;
    unsigned int v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < samples && p < width) {
        const int i = p * samples + s;
        v[s] = wide ? (swab ? (row[2 * i] << 8) | row[2 * i + 1] : row[2 * i] | (row[2 * i + 1] << 8)) : row[i];
      }
    }
    if (predictor) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const unsigned int t = __shfl_up_sync(0xffffffffu, v[s], o);
          if (lane >= o) v[s] += t;
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        v[s] = (v[s] + carry[s]) & mask;
        carry[s] = __shfl_sync(0xffffffffu, v[s], 31);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < samples && p < width) {
        const int i = p * samples + s;
        if (wide) {
          row[2 * i] = static_cast<uint8_t>(v[s]);
          row[2 * i + 1] = static_cast<uint8_t>(v[s] >> 8);
        } else {
          row[i] = static_cast<uint8_t>(v[s]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    assemble_kernel(uint8_t* __restrict__ decoded, const uint8_t* __restrict__ jpeg, const int* __restrict__ chunks,
                    const int* __restrict__ status, uint8_t* __restrict__ out) {
  const int* c = chunks + kChunkInts * blockIdx.x;
  const int rows = c[kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int placed = c[kPlaced], pitch = c[kPitch], stride = c[kStride];
  uint8_t* dst = out + c[kDst];
  const int step = c[kJpegStep];
  if (step) {  // a JPEG chunk: no predictor, no swap
    if (jpeg == nullptr) return;
    const uint8_t* src = jpeg + c[kSrc];
    for (int r = warp; r < rows; r += kWarps) {
      const uint8_t* from = src + static_cast<long long>(r) * pitch;
      uint8_t* to = dst + static_cast<long long>(r) * stride;
      for (int i = lane; i < placed; i += 32) to[i] = from[i * step];
    }
    return;
  }
  const bool failed = c[kStream] >= 0 && status[c[kStream]] != kOk;
  const int predictor = failed ? 0 : c[kPredictor];
  const bool swab = !failed && c[kSwab] != 0;
  uint8_t* src = decoded + c[kSrc];
  if (predictor || swab) {  // the same for every thread of the CTA
    for (int r = warp; r < rows; r += kWarps)
      undo_row(src + static_cast<long long>(r) * c[kRowBytes], c[kWidth], c[kSamples], predictor, swab, lane);
    __syncthreads();
  }
  for (int r = warp; r < rows; r += kWarps) {
    const uint8_t* from = src + static_cast<long long>(r) * pitch;
    uint8_t* to = dst + static_cast<long long>(r) * stride;
    for (int i = lane; i < placed; i += 32) to[i] = from[i];
  }
}

}  // namespace

extern "C" {

// K10: chunks as data/codec.py::tiff_batch (TIFF_CHUNK_INTS rows) over `decoded`, which the
// predictor is undone in (in place), and `jpeg`, the JPEG chunks' RGB (null: none, and the
// JPEG chunks stay zero); status: K9's, a stream; `out` the batch's image buffer.
int ssd_tiff_assemble(uint8_t* decoded, const uint8_t* jpeg, const int* chunks, int nchunks, const int* status,
                      uint8_t* out, void* stream) {
  if (nchunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  assemble_kernel<<<nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(decoded, jpeg, chunks, status, out);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// cv2.resize on Hopper (sm_90a), K4: a batch of images of one dtype and channel count in
// one launch, each image at its own source and output shape.
//
//   linear_u8   INTER_LINEAR on uint8: cv2's fixed-point scheme (11-bit coefficients; the
//               vertical pass rounds as its SIMD code does,
//               ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2).
//   linear_f32  INTER_LINEAR on float32: the Intel IPP path cv2 takes, fma(b - a, t, a)
//               across then down; `ipp` 0 gives cv2's own float path (a * (1 - t) + b * t),
//               which it takes for a source one pixel wide or high.
//   area_u8     INTER_AREA on uint8: for whole-number factors the mean of the cell
//               ((s + 2) >> 2 at 2x, else float s * (1 / n) rounded to even); for others
//               cv2's float area tables, accumulated in its order.
//
// Replaces no Pallas kernel: the JAX package resizes with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:123-125, eval/serve.py:248-260). The
// coefficient tables are built on the host exactly as cv2 builds them
// (ops/plain_image.py), which also holds the plain versions these are held to bit for
// bit. Built with -fmad=false: no multiply-add is fused unless written as __fmaf_rn.
//
// What bounds it on an H100: bytes (each source byte read once, each output byte written
// once), which for one 640x480 -> 300x300 image take 0.36 us, far under a launch. So the
// design cuts what surrounds the bytes: one launch for the whole batch, the per-image
// arguments (source, output, the shape pair's plan: shapes and table pointers, cached on
// the card per shape pair) passed by value; a CTA a tile of 128 x 8 output pixels of one
// image, its x table in shared memory; a warp an output row (the y pair and coefficients
// warp-uniform), a lane every 32nd pixel of it (so that a warp's loads of a source row
// fall on neighbouring bytes), the row staged in shared memory and stored 4 bytes (uint8)
// or 16 bytes (float32) a lane where the row's address allows; 32-bit offsets within a row
// and 64-bit row bases (one multiply a warp), the channel count a template parameter (1, 3
// or 4), no division but one a CTA.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;               // output pixels a lane: x0 + lane + 32 k
constexpr int kTileW = 32 * kPix;     // output pixels a tile's row
constexpr int kTileH = kWarps;        // output rows a tile: a warp a row
constexpr int kMaxItems = 128;        // images a launch

// A shape pair's plan on the card (int64 each; ops/cuda_image.py::_device_plan).
enum Plan { kH, kW, kh, kw, kKx, kKy, kNx, kNy, kIpp, kTilesX, kXi, kXc, kXf, kYi, kYc, kYf, kPlanInts };

struct Item {
  const void* src;
  void* dst;
  const long long* plan;
};

struct Items {  // 3 KB, by value: kernel parameters may take 4 KB
  Item item[kMaxItems];
};

template <typename T>
__device__ __forceinline__ const T* table(const long long* plan, int which) {
  return reinterpret_cast<const T*>(plan[which]);
}

// The tile's place: (first output column, first output row), or false where the CTA lies
// past its image (the grid is sized for the batch's largest image).
__device__ __forceinline__ bool tile_of(const long long* plan, int& x0, int& y0) {
  const int tiles_x = static_cast<int>(plan[kTilesX]);
  const int t = static_cast<int>(blockIdx.x);
  y0 = (t / tiles_x) * kTileH;
  x0 = (t - (t / tiles_x) * tiles_x) * kTileW;
  return y0 < static_cast<int>(plan[kh]);
}

// A warp's staged output row (`bytes` bytes from a 4-byte-aligned shared buffer) to
// device memory: 4-byte stores, a lane every 32nd word, where the destination allows,
// else a byte a lane at a time. Coalesced either way.
__device__ __forceinline__ void copy_row(const uint32_t* staged, uint8_t* out, int bytes, int lane) {
  if ((reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    const int words = bytes >> 2;
    for (int i = lane; i < words; i += 32) reinterpret_cast<uint32_t*>(out)[i] = staged[i];
    const uint8_t* tail = reinterpret_cast<const uint8_t*>(staged);
    for (int i = (words << 2) + lane; i < bytes; i += 32) out[i] = tail[i];
  } else {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(staged);
    for (int i = lane; i < bytes; i += 32) out[i] = src[i];
  }
}

__device__ __forceinline__ void copy_row(const float* staged, float* out, int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int quads = count >> 2;
    for (int i = lane; i < quads; i += 32) reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(staged)[i];
    for (int i = (quads << 2) + lane; i < count; i += 32) out[i] = staged[i];
  } else {
    for (int i = lane; i < count; i += 32) out[i] = staged[i];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) linear_u8_kernel(const Items items) {
  const Item it = items.item[blockIdx.y];
  const long long* plan = it.plan;
  int x0, y0;
  if (!tile_of(plan, x0, y0)) return;
  const int H = static_cast<int>(plan[kH]), W = static_cast<int>(plan[kW]);
  const int h = static_cast<int>(plan[kh]), w = static_cast<int>(plan[kw]);
  __shared__ int s_a[kTileW], s_b[kTileW], s_coef[kTileW];  // source byte of x and x + 1, coefficients
  __shared__ uint32_t s_out[kWarps][kTileW * C / 4];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int dy = y0 + warp;
  int sy = 0, b0 = 0, b1 = 0;  // the warp's row, read while the x table loads
  if (dy < h) {
    sy = table<int>(plan, kYi)[dy];
    b0 = table<int>(plan, kYc)[2 * dy];
    b1 = table<int>(plan, kYc)[2 * dy + 1];
  }
  if (threadIdx.x < kTileW && x0 + static_cast<int>(threadIdx.x) < w) {
    const int dx = x0 + static_cast<int>(threadIdx.x);
    const int sx = table<int>(plan, kXi)[dx];
    const int* xc = table<int>(plan, kXc);
    s_a[threadIdx.x] = sx * C;
    s_b[threadIdx.x] = min(sx + 1, W - 1) * C;
    s_coef[threadIdx.x] = xc[2 * dx] | (xc[2 * dx + 1] << 16);
  }
  __syncthreads();
  if (dy >= h) return;
  const int n = min(kTileW, w - x0);
  const uint8_t* src = static_cast<const uint8_t*>(it.src);
  const long long pitch = static_cast<long long>(W) * C;
  const uint8_t* row0 = src + min(max(sy, 0), H - 1) * pitch;
  const uint8_t* row1 = src + min(max(sy + 1, 0), H - 1) * pitch;
  uint8_t* staged = reinterpret_cast<uint8_t*>(s_out[warp]);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int t = lane + 32 * k;
    if (t < n) {
      const int a = s_a[t], b = s_b[t], coef = s_coef[t];
      const int c0 = coef & 0xffff, c1 = coef >> 16;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int s0 = (__ldg(row0 + a + c) * c0 + __ldg(row0 + b + c) * c1) >> 4;
        const int s1 = (__ldg(row1 + a + c) * c0 + __ldg(row1 + b + c) * c1) >> 4;
        staged[t * C + c] = static_cast<uint8_t>((((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2);
      }
    }
  }
  __syncwarp();
  copy_row(s_out[warp], static_cast<uint8_t*>(it.dst) + (static_cast<long long>(dy) * w + x0) * C, n * C, lane);
}

template <int C>
__global__ void __launch_bounds__(kThreads) linear_f32_kernel(const Items items) {
  const Item it = items.item[blockIdx.y];
  const long long* plan = it.plan;
  int x0, y0;
  if (!tile_of(plan, x0, y0)) return;
  const int H = static_cast<int>(plan[kH]), W = static_cast<int>(plan[kW]);
  const int h = static_cast<int>(plan[kh]), w = static_cast<int>(plan[kw]);
  const bool ipp = plan[kIpp] != 0;
  __shared__ int s_a[kTileW], s_b[kTileW];
  __shared__ float s_t[kTileW];
  __shared__ __align__(16) float s_out[kWarps][kTileW * C];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int dy = y0 + warp;
  int sy = 0;  // the warp's row, read while the x table loads
  float ty = 0.0f;
  if (dy < h) {
    sy = table<int>(plan, kYi)[dy];
    ty = table<float>(plan, kYf)[dy];
  }
  if (threadIdx.x < kTileW && x0 + static_cast<int>(threadIdx.x) < w) {
    const int dx = x0 + static_cast<int>(threadIdx.x);
    const int sx = table<int>(plan, kXi)[dx];
    s_a[threadIdx.x] = sx * C;
    s_b[threadIdx.x] = min(sx + 1, W - 1) * C;
    s_t[threadIdx.x] = table<float>(plan, kXf)[dx];
  }
  __syncthreads();
  if (dy >= h) return;
  const int n = min(kTileW, w - x0);
  const float* src = static_cast<const float*>(it.src);
  const long long pitch = static_cast<long long>(W) * C;
  const float* row0 = src + min(max(sy, 0), H - 1) * pitch;
  const float* row1 = src + min(max(sy + 1, 0), H - 1) * pitch;
  float* staged = s_out[warp];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int t = lane + 32 * k;
    if (t < n) {
      const int a = s_a[t], b = s_b[t];
      const float tx = s_t[t];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a0 = __ldg(row0 + a + c), b0 = __ldg(row0 + b + c);
        const float a1 = __ldg(row1 + a + c), b1 = __ldg(row1 + b + c);
        const float h0 = ipp ? __fmaf_rn(b0 - a0, tx, a0) : a0 * (1.0f - tx) + b0 * tx;
        const float h1 = ipp ? __fmaf_rn(b1 - a1, tx, a1) : a1 * (1.0f - tx) + b1 * tx;
        staged[t * C + c] = ipp ? __fmaf_rn(h1 - h0, ty, h0) : h0 * (1.0f - ty) + h1 * ty;
      }
    }
  }
  __syncwarp();
  copy_row(staged, static_cast<float*>(it.dst) + (static_cast<long long>(dy) * w + x0) * C, n * C, lane);
}

template <int C>
__global__ void __launch_bounds__(kThreads) area_u8_kernel(const Items items) {
  const Item it = items.item[blockIdx.y];
  const long long* plan = it.plan;
  int x0, y0;
  if (!tile_of(plan, x0, y0)) return;
  const int W = static_cast<int>(plan[kW]);
  const int h = static_cast<int>(plan[kh]), w = static_cast<int>(plan[kw]);
  const int kx = static_cast<int>(plan[kKx]), ky = static_cast<int>(plan[kKy]);
  const int nx = static_cast<int>(plan[kNx]), ny = static_cast<int>(plan[kNy]);
  __shared__ uint32_t s_out[kWarps][kTileW * C / 4];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int dy = y0 + warp;
  if (dy >= h) return;
  const int n = min(kTileW, w - x0);
  const uint8_t* src = static_cast<const uint8_t*>(it.src);
  const long long pitch = static_cast<long long>(W) * C;
  const int* xi = table<int>(plan, kXi);
  const float* xw = table<float>(plan, kXf);
  const int* yi = table<int>(plan, kYi);
  const float* yw = table<float>(plan, kYf);
  const float inv = kx > 0 ? 1.0f / static_cast<float>(kx * ky) : 0.0f;
  uint8_t* staged = reinterpret_cast<uint8_t*>(s_out[warp]);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int t = lane + 32 * k;
    if (t >= n) continue;
    const int dx = x0 + t;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int out;
      if (kx > 0) {  // whole-number factors: every cell is whole
        int sum = 0;
        for (int yy = 0; yy < ky; ++yy) {
          const uint8_t* row = src + (dy * ky + yy) * pitch + dx * kx * C + c;
          for (int xx = 0; xx < kx; ++xx) sum += __ldg(row + xx * C);
        }
        out = (kx == 2 && ky == 2) ? (sum + 2) >> 2 : __float2int_rn(static_cast<float>(sum) * inv);
      } else {
        float total = 0.0f;
        for (int j = 0; j < ny; ++j) {
          const uint8_t* row = src + yi[dy * ny + j] * pitch + c;
          float buf = 0.0f;
          for (int q = 0; q < nx; ++q) {
            buf = buf + static_cast<float>(__ldg(row + xi[dx * nx + q] * C)) * xw[dx * nx + q];
          }
          const float part = yw[dy * ny + j] * buf;
          total = j == 0 ? part : total + part;
        }
        out = __float2int_rn(total);
      }
      staged[t * C + c] = static_cast<uint8_t>(out < 0 ? 0 : (out > 255 ? 255 : out));
    }
  }
  __syncwarp();
  copy_row(s_out[warp], static_cast<uint8_t*>(it.dst) + (static_cast<long long>(dy) * w + x0) * C, n * C, lane);
}

template <int C>
void launch(int mode, const Items& items, dim3 grid, cudaStream_t stream) {
  if (mode == 0) {
    linear_u8_kernel<C><<<grid, kThreads, 0, stream>>>(items);
  } else if (mode == 1) {
    linear_f32_kernel<C><<<grid, kThreads, 0, stream>>>(items);
  } else {
    area_u8_kernel<C><<<grid, kThreads, 0, stream>>>(items);
  }
}

}  // namespace

extern "C" {

// mode 0 linear u8, 1 linear f32, 2 area u8; `items` (host memory): n rows of (source
// pointer, output pointer, plan pointer), n <= 128; `tiles`: the most tiles of 128 x 8
// output pixels of one image of the batch. Rows (source and output) of fewer than 2^31
// elements, as ops/cuda_image.py::resize_batch checks.
int ssd_resize_batch(int mode, int channels, const long long* items, int n, int tiles, void* stream) {
  if (mode < 0 || mode > 2 || n < 1 || n > kMaxItems || tiles < 1 ||
      (channels != 1 && channels != 3 && channels != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Items pack{};
  for (int i = 0; i < n; ++i) {
    pack.item[i].src = reinterpret_cast<const void*>(items[3 * i]);
    pack.item[i].dst = reinterpret_cast<void*>(items[3 * i + 1]);
    pack.item[i].plan = reinterpret_cast<const long long*>(items[3 * i + 2]);
  }
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(n));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 1) {
    launch<1>(mode, pack, grid, s);
  } else if (channels == 3) {
    launch<3>(mode, pack, grid, s);
  } else {
    launch<4>(mode, pack, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

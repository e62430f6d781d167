// Fused 3x3 SAME convolution + bias (+ ReLU) (+ 2x2/s2 max-pool) for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_object_detection_tpu/ops/pallas_conv.py::_kernel
// (pallas_call at pallas_conv.py:134, wrapped by _conv3x3_pallas and exposed as
// conv3x3_bias_relu). It computes what that kernel computes, for NHWC inputs x
// (B, H, W, IC) and HWIO weights (3, 3, IC, OC) in the input's type, a float32 bias:
//
//   y = conv3x3_SAME(x, w) summed in float32; y += bias; y = max(y, 0) if relu;
//   y = cast(y) to the input type; y = 2x2/s2 max-pool of y if pool.
//
// The pool runs on the float32 values and the cast comes after it, which is the same
// result: rounding to nearest is monotone, so the maximum of rounded values is the
// rounded maximum.
//
// Design. The TPU kernel's point was to read the input once and write the (pooled)
// output once, with bias, ReLU and the pool in fast memory. Here one CTA of 8 warps
// computes a 16x16 tile of output pixels for 64 output channels as an implicit GEMM
// (M = 256 pixels, N = 64 channels, K = 9 taps x IC):
//   - per chunk of 32 input channels it loads the 18x18 input halo into shared memory
//     (zero outside the image: that is the SAME padding, so no padded copy exists)
//     and the 3x3x32x64 weights of the chunk (zero past IC and OC);
//   - bf16: each warp owns two output rows (two 16-pixel M fragments) and all four
//     16-channel N fragments, and runs nvcuda::wmma 16x16x16 bf16 products with
//     float32 accumulators; the A fragment of tap (ky, kx) is the halo row r + ky
//     shifted by kx pixels, read in place (a halo pixel's channels are contiguous);
//   - float32: plain FMA on the CUDA cores, each thread 64 pixels x 1 channel;
//   - the epilogue stages the float32 tile in shared memory (over the halo, after a
//     barrier), adds the bias, applies ReLU, pools whole 2x2 windows (a tile's origin
//     is even and H, W are even when pooling), casts and stores. The full-resolution
//     activation never reaches device memory when pool is on.
//
// What bounds it on this card: at the SSD300 VGG shapes (batch 32, IC = OC = 64 to
// 256) the work is 212 GFLOP per layer against 0.2-0.5 GB of traffic, so the tensor
// cores bound it (0.215 ms at 989 TFLOP/s dense bf16; the bytes take 0.055-0.138 ms).
// This first version is far from that: wmma (mma.sync) rather than wgmma, no TMA and
// no overlap of a chunk's loads with the previous chunk's products (two CTAs per SM
// overlap each other instead), the halo re-read for each 64-channel block of OC, and
// the weights re-read by every CTA from L2. Those are the next steps.
//
// Entry point: ssd_conv3x3_forward (plain C, loaded with ctypes). It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 16;              // output rows per CTA
constexpr int kTW = 16;              // output columns per CTA (one 16-row M fragment)
constexpr int kHR = kTH + 2;         // halo rows
constexpr int kHC = kTW + 2;         // halo columns
constexpr int kM = kTH * kTW;        // output pixels per CTA
constexpr int kBN = 64;              // output channels per CTA
constexpr int kKC = 32;              // input channels per chunk
constexpr int kThreads = 256;        // 8 warps
constexpr int kEpl = kBN + 4;        // leading dimension of the float32 epilogue tile

template <typename T>
struct Layout;

// bf16: wmma loads need 32-byte aligned fragment pointers, so a halo pixel is padded
// to 48 channels (96 bytes) and a weight row to 80 channels (160 bytes).
template <>
struct Layout<bf16> {
  static constexpr int kKCP = kKC + 16;
  static constexpr int kBNP = kBN + 16;
  static constexpr int kVec = 8;  // elements in one 16-byte load
};

// float32: the warp reads one halo word (broadcast) and 32 consecutive weights.
template <>
struct Layout<float> {
  static constexpr int kKCP = kKC;
  static constexpr int kBNP = kBN;
  static constexpr int kVec = 4;
};

template <typename T>
constexpr size_t smem_bytes() {
  const size_t operands = (static_cast<size_t>(kHR) * kHC * Layout<T>::kKCP +
                           static_cast<size_t>(9) * kKC * Layout<T>::kBNP) * sizeof(T);
  const size_t epilogue = static_cast<size_t>(kM) * kEpl * sizeof(float);
  return operands > epilogue ? operands : epilogue;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ bias,
               T* __restrict__ out, int H, int W, int IC, int OC, int tiles_w, int relu, int pool,
               int vec_x, int vec_w) {
  constexpr int kKCP = Layout<T>::kKCP;
  constexpr int kBNP = Layout<T>::kBNP;
  constexpr int kVec = Layout<T>::kVec;

  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);                        // [kHR * kHC][kKCP]
  T* ws = halo + kHR * kHC * kKCP;                               // [9 * kKC][kBNP]
  float* ep = reinterpret_cast<float*>(smem);                    // [kM][kEpl], after the loop

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const T zero = from_float<T>(0.f);

  // bf16: warp `warp` owns output rows 2*warp and 2*warp + 1, all four N fragments.
  const int warp = tid / 32;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_mma[2][4];
  // float32: thread owns channel n_lane and the 64 pixels of rows 4*mg .. 4*mg + 3.
  const int n_lane = tid % kBN;
  const int mg = tid / kBN;
  float acc_fma[std::is_same<T, float>::value ? 64 : 1];

  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) nvcuda::wmma::fill_fragment(acc_mma[j][nf], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_fma[i] = 0.f;
  }

  const T* xb = x + static_cast<size_t>(b) * H * W * IC;
  for (int c0 = 0; c0 < IC; c0 += kKC) {
    __syncthreads();  // the previous chunk's products are done with the buffers

    // Halo of this chunk: zero outside the image (SAME padding) and past IC.
    constexpr int kHaloVecs = kHR * kHC * (kKC / kVec);
    for (int v = tid; v < kHaloVecs; v += kThreads) {
      const int p = v / (kKC / kVec);
      const int cv = v - p * (kKC / kVec);
      const int hr = p / kHC;
      const int h = h0 - 1 + hr;
      const int w = w0 - 1 + (p - hr * kHC);
      const int c = c0 + cv * kVec;
      T* dst = halo + p * kKCP + cv * kVec;
      const bool inside = h >= 0 && h < H && w >= 0 && w < W;
      const T* src = inside ? xb + (static_cast<size_t>(h) * W + w) * IC + c : xb;
      if (inside && vec_x && c + kVec <= IC) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = (inside && c + e < IC) ? src[e] : zero;
      }
    }
    // Weights of this chunk, [tap][k][n]: zero past IC and OC.
    constexpr int kWVecs = 9 * kKC * (kBN / kVec);
    for (int v = tid; v < kWVecs; v += kThreads) {
      const int row = v / (kBN / kVec);
      const int nv = v - row * (kBN / kVec);
      const int tap = row / kKC;
      const int ci = c0 + (row - tap * kKC);
      const int n = n0 + nv * kVec;
      T* dst = ws + row * kBNP + nv * kVec;
      const T* src = wt + (static_cast<size_t>(tap) * IC + ci) * OC + n;
      if (ci < IC && vec_w && n + kVec <= OC) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = (ci < IC && n + e < OC) ? src[e] : zero;
      }
    }
    __syncthreads();

    if constexpr (std::is_same<T, bf16>::value) {
      using namespace nvcuda;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap - ky * 3;
#pragma unroll
        for (int ks = 0; ks < kKC / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = 2 * warp + j;
            wmma::load_matrix_sync(a[j], halo + ((r + ky) * kHC + kx) * kKCP + ks * 16, kKCP);
          }
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
            wmma::load_matrix_sync(bfrag, ws + (tap * kKC + ks * 16) * kBNP + nf * 16, kBNP);
            wmma::mma_sync(acc_mma[0][nf], a[0], bfrag, acc_mma[0][nf]);
            wmma::mma_sync(acc_mma[1][nf], a[1], bfrag, acc_mma[1][nf]);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3;
        const int kx = tap - ky * 3;
        const T* hbase = halo + ((4 * mg + ky) * kHC + kx) * kKCP;
#pragma unroll 2
        for (int k = 0; k < kKC; ++k) {
          const float wv = ws[(tap * kKC + k) * kBNP + n_lane];
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            acc_fma[i] += hbase[((i / kTW) * kHC + (i % kTW)) * kKCP + k] * wv;
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the halo before the tile overwrites it

  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        nvcuda::wmma::store_matrix_sync(ep + (2 * warp + j) * kTW * kEpl + nf * 16,
                                        acc_mma[j][nf], kEpl, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) ep[(mg * 64 + i) * kEpl + n_lane] = acc_fma[i];
  }
  __syncthreads();

  if (!pool) {
    for (int idx = tid; idx < kM * kBN; idx += kThreads) {
      const int m = idx / kBN;
      const int n = idx - m * kBN;
      const int h = h0 + m / kTW;
      const int w = w0 + m % kTW;
      const int oc = n0 + n;
      if (h < H && w < W && oc < OC) {
        float v = ep[m * kEpl + n] + bias[oc];
        if (relu) v = fmaxf(v, 0.f);
        out[((static_cast<size_t>(b) * H + h) * W + w) * OC + oc] = from_float<T>(v);
      }
    }
  } else {
    const int Hp = H / 2;
    const int Wp = W / 2;
    for (int idx = tid; idx < (kM / 4) * kBN; idx += kThreads) {
      const int pm = idx / kBN;
      const int n = idx - pm * kBN;
      const int pr = pm / (kTW / 2);
      const int pc = pm - pr * (kTW / 2);
      const int ph = h0 / 2 + pr;
      const int pw = w0 / 2 + pc;
      const int oc = n0 + n;
      if (ph < Hp && pw < Wp && oc < OC) {
        const int m = 2 * pr * kTW + 2 * pc;
        const float bv = bias[oc];
        float v = fmaxf(fmaxf(ep[m * kEpl + n] + bv, ep[(m + 1) * kEpl + n] + bv),
                        fmaxf(ep[(m + kTW) * kEpl + n] + bv, ep[(m + kTW + 1) * kEpl + n] + bv));
        if (relu) v = fmaxf(v, 0.f);
        out[((static_cast<size_t>(b) * Hp + ph) * Wp + pw) * OC + oc] = from_float<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
           int IC, int OC, int relu, int pool, void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec = Layout<T>::kVec;
  const int vec_x = IC % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = OC % kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (OC + kBN - 1) / kBN, B);
  conv3x3_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(out), H, W, IC,
      OC, tiles_w, relu, pool, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, IC) and w (3, 3, IC, OC) are
// contiguous in that type, bias (OC,) float32; out is (B, H, W, OC), or
// (B, H/2, W/2, OC) with pool (H and W even).
int ssd_conv3x3_forward(const void* x, const void* w, const float* bias, void* out, int B, int H,
                        int W, int IC, int OC, int relu, int pool, int dtype, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1) return launch<bf16>(x, w, bias, out, B, H, W, IC, OC, relu, pool, stream);
  return launch<float>(x, w, bias, out, B, H, W, IC, OC, relu, pool, stream);
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// int8 post-training-quantized convolution for Hopper (sm_90a): quantize + int8 conv.
//
// Replaces the int8 conv of ssd_object_detection_tpu/ops/quant.py::_int8_conv
// (quant.py:192-217). The JAX package has no Pallas kernel there: XLA lowers
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32). It computes, for
// NHWC activations x in the compute dtype, int8 weights w (OC, KH, KW, IC), per-output-
// channel weight scales w_scale (OC,), a per-tensor activation scale x_scale and an
// optional bias (OC,):
//
//   xq  = clip(rint(float(x) / x_scale), -127, 127) as int8             (quantize)
//   acc = conv(xq, w) summed in int32, stride (SH, SW), zero padding     (int8 conv)
//   y   = float(acc) * (x_scale * w_scale[oc]) [+ bias[oc]], cast to the compute dtype
//
// Numerics, held bit-equal to the plain PyTorch version (ops/cuda_int8.py):
//   - the division is IEEE (__fdiv_rn by the scale read from device memory, never a
//     reciprocal multiply) and the rounding is rintf, half to even, as jnp.round;
//   - int32 sums are exact in any order (|acc| <= 127^2 * KH*KW*IC < 2^31);
//   - the epilogue forms x_scale * w_scale first, as quant.py:214 does, with __fmul_rn
//     and __fadd_rn so that nothing is contracted into an FMA (and -fmad=false).
//
// What bounds it on this card: at SSD300's 17 eligible convs at batch 32 a conv is
// 29-110 GOP of int8 products against 0.02-0.1 GB of traffic, so the tensor cores bound
// it (1,979 TOPS dense int8): 0.015-0.056 ms each, 0.628 ms in all. This first version
// is right and simple, not at that bound:
//   - quantize: one thread per 16 output channels of a pixel, one 16-byte store; the
//     channels are padded with zeros to ICp, a multiple of 64, so every K chunk of the
//     conv is 64 bytes of one tap and every load is 16 bytes and aligned;
//   - conv: an implicit GEMM, output pixels x output channels x (KH*KW taps x ICp), on
//     mma.sync.m16n8k32 s8 (warp-level tensor-core products; wgmma s8 and TMA are the
//     levers for later). A CTA of 8 warps computes 128 pixels x 128 channels; each warp
//     64 x 32 (4 x 4 m16n8 tiles, 64 int32 accumulators a thread). A stage holds one
//     64-byte K chunk of the 128 pixel rows (gathered for the tap, zero outside the image:
//     SAME or VALID padding, any stride) and of the 128 weight rows (zero past OC); three
//     stages ride a cp.async ring. Rows are 80 bytes apart in shared memory, so the
//     32-bit fragment reads of a warp hit 32 distinct banks.
//
// Entry points (plain C, loaded with ctypes) launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() after the launch (or the failing call's code).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 128;          // output pixels per CTA tile
constexpr int kBN = 128;          // output channels per CTA tile
constexpr int kBK = 64;           // K bytes per stage: 64 input channels of one tap
constexpr int kRow = kBK + 16;    // shared-memory row pitch (bytes): conflict-free reads
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kRow;
constexpr int kSmem = kStages * kStageBytes;  // 61,440 bytes: dynamic shared memory

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename In>
__global__ void quantize_kernel(const In* __restrict__ x, const float* __restrict__ x_scale,
                                int8_t* __restrict__ xq, long long groups, int ic, int icp) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= groups) return;
  const int per_pixel = icp / 16;
  const long long pixel = idx / per_pixel;
  const int c0 = static_cast<int>(idx % per_pixel) * 16;
  const float xs = *x_scale;
  const In* src = x + pixel * ic;
  alignas(16) int8_t v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + j;
    float q = 0.0f;
    if (c < ic) {
      q = rintf(__fdiv_rn(to_float(src[c]), xs));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
    }
    v[j] = static_cast<int8_t>(static_cast<int>(q));
  }
  *reinterpret_cast<int4*>(xq + pixel * icp + c0) = *reinterpret_cast<const int4*>(v);
}

struct ConvArgs {
  const int8_t* xq;        // (B, H, W, ICp)
  const int8_t* w;         // (OC, KH, KW, ICp)
  const float* w_scale;    // (OC,)
  const float* x_scale;    // scalar
  const float* bias;       // (OC,) or null
  void* out;               // (B, Ho, Wo, OC): int32, float32 or bf16
  int B, H, W, ICp, Ho, Wo, OC, KH, KW, SH, SW, PT, PL;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: the hardware writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Out: int32_t (raw accumulators), float or __nv_bfloat16 (dequantized).
template <typename Out>
__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int warp_m = warp & 1, warp_n = warp >> 1;  // 2 x 4 warps: 64 pixels x 32 channels
  const long long m_total = static_cast<long long>(args.B) * args.Ho * args.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = args.ICp / kBK;
  const int k_tiles = args.KH * args.KW * chunks;

  // Each thread copies two 16-byte segments of pixel rows and two of weight rows per
  // stage: rows tid / 4 and tid / 4 + 64, segment tid % 4.
  const int seg = tid & 3;
  long long a_base[2];  // offset of (b, 0, 0, seg * 16) in xq, or -1 past M
  int a_h0[2], a_w0[2];
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    if (m < m_total) {
      const int wo = static_cast<int>(m % args.Wo);
      const long long rest = m / args.Wo;
      const int ho = static_cast<int>(rest % args.Ho);
      const long long b = rest / args.Ho;
      a_base[i] = b * args.H * args.W * args.ICp + seg * 16;
      a_h0[i] = ho * args.SH - args.PT;
      a_w0[i] = wo * args.SW - args.PL;
    } else {
      a_base[i] = -1;
      a_h0[i] = a_w0[i] = 0;
    }
  }
  const int taps = args.KH * args.KW;

  auto load_stage = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * kStageBytes;
    unsigned char* sb = sa + kBM * kRow;
    const int tap = kt / chunks;
    const int c0 = (kt - tap * chunks) * kBK;
    const int kh = tap / args.KW, kw = tap - (tap / args.KW) * args.KW;
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 64 * i;
      const int h = a_h0[i] + kh, w = a_w0[i] + kw;
      const bool ok = a_base[i] >= 0 && h >= 0 && h < args.H && w >= 0 && w < args.W;
      const int8_t* src = ok ? args.xq + a_base[i] + (static_cast<long long>(h) * args.W + w) * args.ICp + c0
                             : args.xq;
      cp_async16(sa + row * kRow + seg * 16, src, ok);
      const int oc = n0 + row;
      const bool ok_w = oc < args.OC;
      const int8_t* wsrc = ok_w ? args.w + (static_cast<long long>(oc) * taps + tap) * args.ICp + c0 + seg * 16
                                : args.w;
      cp_async16(sb + row * kRow + seg * 16, wsrc, ok_w);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sb = sa + kBM * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* p = sa + (warp_m * 64 + i * 16 + gid) * kRow + kk * 32 + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p = sb + (warp_n * 32 + j * 8 + gid) * kRow + kk * 32 + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread (gid, tig) holds rows gid and gid + 8, channels 2 tig and 2 tig + 1
  // of each m16n8 tile.
  Out* out = static_cast<Out*>(args.out);
  float xs = 0.0f;
  if constexpr (!std::is_same<Out, int32_t>::value) xs = *args.x_scale;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int oc = n0 + warp_n * 32 + j * 8 + tig * 2 + c;
      if (oc >= args.OC) continue;
      float scale = 0.0f, bias = 0.0f;
      if constexpr (!std::is_same<Out, int32_t>::value) {
        scale = __fmul_rn(xs, args.w_scale[oc]);  // the product of the scales first
        if (args.bias != nullptr) bias = args.bias[oc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + warp_m * 64 + i * 16 + gid + 8 * h;
          if (m >= m_total) continue;
          const int v = acc[i][j][2 * h + c];
          Out* dst = out + m * args.OC + oc;
          if constexpr (std::is_same<Out, int32_t>::value) {
            *dst = v;
          } else {
            float y = __fmul_rn(__int2float_rn(v), scale);
            if (args.bias != nullptr) y = __fadd_rn(y, bias);
            store(dst, y);
          }
        }
      }
    }
  }
}

template <typename Out>
int launch_conv(const ConvArgs& args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_total = static_cast<long long>(args.B) * args.Ho * args.Wo;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), (args.OC + kBN - 1) / kBN);
  conv_kernel<Out><<<grid, kThreads, kSmem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (pixels, IC) contiguous, bf16 (x_is_bf16 = 1) or float32; x_scale a float32 on the
// device; xq (pixels, ICp) int8 with ICp % 64 == 0, zero past IC.
int ssd_int8_quantize(const void* x, int x_is_bf16, const float* x_scale, int8_t* xq,
                      long long pixels, int ic, int icp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = pixels * (icp / 16);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((groups + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quantize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), x_scale, xq, groups, ic, icp);
  } else {
    quantize_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x), x_scale, xq,
                                                     groups, ic, icp);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq (B, H, W, ICp) and w (OC, KH, KW, ICp) int8, ICp % 64 == 0; out (B, Ho, Wo, OC) as
// out_mode 0: int32 accumulators, 1: float32, 2: bf16 (dequantized, + bias if given).
int ssd_int8_conv(const int8_t* xq, const int8_t* w, const float* w_scale, const float* x_scale,
                  const float* bias, void* out, int out_mode, int B, int H, int W, int ICp,
                  int Ho, int Wo, int OC, int KH, int KW, int SH, int SW, int PT, int PL,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvArgs args{xq, w, w_scale, x_scale, bias, out, B, H, W, ICp, Ho, Wo, OC, KH, KW,
                      SH, SW, PT, PL};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case 0: return launch_conv<int32_t>(args, s);
    case 1: return launch_conv<float>(args, s);
    case 2: return launch_conv<__nv_bfloat16>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

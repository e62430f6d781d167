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
// What bounds it on this card. SSD300-VGG16 at batch 32 has 17 int8 convs, 1,242 GOP:
//   - the six 3x3 stride-1 convs of >= 38x38 hold 1,070 GOP against 0.02-0.1 GB each, so
//     the tensor cores bound them (1,979 TOP/s dense int8: 0.541 ms together);
//   - extra1_conv0 (3x3 stride 2, 109 GOP) and two 1x1 convs (24 GOP each) likewise;
//   - the other eight are under 8 GOP each: their time is the launch and the host.
// Feeding the tensor cores is the work: TMA serves a box row by row (a pixel's channels
// of the chunk, 16 to 128 bytes), so the design cuts the TMA rows per product and the
// L2 bytes per product.
//
// What the design does about the operations (an implicit GEMM on wgmma, no im2col):
//   - Products: D^T (64 output channels x 256 pixels) = W^T X^T, one
//     wgmma.m64n256k32.s32.s8.s8 per tap and 32 input channels, 128 s32 accumulators a
//     thread. Both operands are K-major in shared memory, in rows of ROW = 32, 64 or 128
//     bytes (one pixel's or one output channel's ROW input channels) under the swizzle of
//     that width; a product reads a 32-byte slice of each row, so the descriptor's start
//     moves by 32 bytes per slice (ops/cuda_int8.py::plan_int8 picks ROW).
//   - Halo mode (stride 1, any kernel and padding): a tile is R output rows x
//     (P - KW + 1) columns of one image; GEMM column m = r * P + c. Per ROW-channel chunk
//     one TMA load brings the tile's halo, R + KH - 1 rows at pitch P, from a 4-D map over
//     xq (ICp, W, H, B) at (c0, w0 - PL, h0 - PT, b); the hardware's zero fill outside the
//     image is the padding (SAME, with (0, 1) pads too, and VALID). Tap (kh, kw) reads
//     halo pixel m + kh * P + kw: the B descriptor's start moves by (kh * P + kw) rows,
//     so the halo is read once per chunk, not once per tap. The swizzle is a function of
//     the shared-memory address, so a start moved by whole rows reads what TMA wrote. A
//     1x1 stride-1 unpadded conv runs on its pixels as one row of 128-byte rows.
//   - Tap mode (every other conv: stride 2): one box per chunk and tap, at
//     (c0, w0 * SW - PL + kw, h0 * SH - PT + kh, b) with the map's element strides set to
//     (SW, SH), so it lands the inputs of R x P output pixels for that tap.
//   - Weights: packed once per weight tensor (ops/cuda_int8.py::pack_weights) in the
//     ring's order and swizzle, [N-block][chunk][tap][64 output channels][ROW bytes], so a
//     stage's weights are one cp.async.bulk copy: one request, not one per row.
//   - Ring: one producer thread keeps the stages of the CTA's (tile, K step) sequence in
//     flight on full and empty mbarriers with transaction counts. Two consumer
//     warpgroups ping-pong whole tiles, so one's epilogue overlaps the other's products;
//     they take turns at the ring (a pair of turn mbarriers), so every wait's parity
//     names the right phase at any ring depth. setmaxnreg moves registers to them.
//   - Persistent grid: one CTA per SM walks tiles blockIdx.x, + gridDim.x, ... with the
//     N-block innermost, so neighbouring CTAs read the same halo from L2.
//   - TMA rows per product: 3x3 halo mode at P = 17 and ROW = 32: the halo's 289 rows
//     serve 9 products; 1x1 at ROW = 128: 256 rows serve 4; stride 2 at ROW = 128: up
//     to 256 rows serve 4 (tap mode loads no halo that taps share). A 3x3 stage of
//     64-byte rows (18 products) fits only two deep beside the two staging tiles; one
//     staging tile shared by the warpgroups made room for three, and lost on the card.
//   - Epilogue: dequantize (or keep the int32) from the accumulators, a row per output
//     channel, into the warpgroup's staging tile [pixel][channel] in shared memory
//     (apart from the ring, which keeps loading), then 16-byte stores of valid pixels.
// What it does about the launches: the quantize pass and the conv are one launch each,
// the conv's host work is one tensor-map encode; the rest is the caller's (ROADMAP B3:
// quantize in the producing layer's epilogue, CUDA-graph capture of the small convs).
//
// Quantize: neighbouring threads read neighbouring 16-byte pieces of x (8 bf16 or 4
// float32 values each), so each warp-wide load is 512 contiguous bytes; each thread
// quantizes 16 values and writes their 16 bytes, as 2 x 8 or 4 x 4 coalesced stores.
// Where IC % 32 != 0 (xq's channels are padded to ICp, a multiple of 32, with zeros), one
// thread makes one 16-channel group of a pixel from scalar loads.
//
// Entry points (plain C, loaded with ctypes) launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() after the launch (or the failing call's code).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// |v| < xs / 4 (ReLU's zeros among them) gives a quotient below 0.25, which rounds to 0:
// those values skip the division, whose slow path a zero dividend takes.
__device__ __forceinline__ int8_t quantize_one(float v, float xs) {
  if (fabsf(v) < 0.25f * xs) return 0;
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// IC == ICp (IC % 32 == 0): x and xq have the same element order. A warp covers 512
// values: piece j * 32 + lane (16 bytes of x) for j < 16 / (values per piece).
template <typename In>
__global__ void quantize_pieces(const In* __restrict__ x, const float* __restrict__ x_scale,
                                int8_t* __restrict__ xq, long long n) {
  constexpr int kPer = 16 / sizeof(In);  // values per 16-byte piece: 8 bf16, 4 float32
  constexpr int kPieces = 16 / kPer;     // pieces per thread: 16 values
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const float xs = *x_scale;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const long long e = warp * 512 + static_cast<long long>(j * 32 + lane) * kPer;
    if (e >= n) break;  // n % 32 == 0: pieces are whole
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + e));
    const In* v = reinterpret_cast<const In*>(&raw);
    alignas(8) int8_t q[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) q[i] = quantize_one(to_float(v[i]), xs);
    if constexpr (kPer == 8) {
      *reinterpret_cast<uint2*>(xq + e) = *reinterpret_cast<const uint2*>(q);
    } else {
      *reinterpret_cast<uint32_t*>(xq + e) = *reinterpret_cast<const uint32_t*>(q);
    }
  }
}

// IC % 32 != 0: one thread per 16-channel group of a pixel of xq, zero past IC.
template <typename In>
__global__ void quantize_groups(const In* __restrict__ x, const float* __restrict__ x_scale,
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
  for (int j = 0; j < 16; ++j) v[j] = c0 + j < ic ? quantize_one(to_float(src[c0 + j]), xs) : 0;
  *reinterpret_cast<int4*>(xq + pixel * icp + c0) = *reinterpret_cast<const int4*>(v);
}

// ---------------------------------------------------------------------------------
// The conv: wgmma s8 fed by TMA through an mbarrier ring.

constexpr int kTileM = 256;        // GEMM columns (pixels) per tile: the N of one wgmma
constexpr int kNBlock = 64;        // output channels per tile: the M of one wgmma
constexpr int kK = 32;             // input channels (bytes) of one wgmma's K
constexpr uint32_t kAlign = 1024;  // ring regions start on this (the swizzle's phase 0)
constexpr int kConsumers = 256;    // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kMaxTaps = 9;        // taps a stage may hold (3x3 in halo mode)

// The launch's integers, in this order: ops/cuda_int8.py::Int8Plan.kernel_ints works all
// of them out and the host copies them as they are, so the tile plan has one owner (the
// planner), which the CPU model of the tile walk (ops/int8_conv_model.py) replays.
struct Plan {
  int B, H, W, ICp;      // xq as the kernel views it (the x map)
  int Ho, Wo, OC, KW, SH, SW, PT, PL;
  int row;               // bytes (input channels) of a pixel's or a weight's stage row
  int P, R, cols;        // pitch, rows, output columns per tile
  int box_rows;          // rows of the x box
  int taps, taps_per_stage, k_taps;  // KH*KW; taps a stage; stages per chunk
  int chunks, tiles_w, tiles_h, n_blocks, num_tiles, k_steps;
  int halo_pixels, box_pixels, stages;
  int smem, grid;        // dynamic shared memory bytes; persistent CTAs
  int shift[kMaxTaps];   // halo rows a stage's tap s reads ahead: (s / KW) * P + s % KW
};

struct Params : Plan {
  const int8_t* wpack;   // (NB, chunks, taps, 64, row): ops/cuda_int8.py::pack_weights
  const float* w_scale;  // (OC,), dequantized outputs only
  const float* x_scale;  // scalar, dequantized outputs only
  const float* bias;     // (OC,) or null
  void* out;             // (B, Ho, Wo, OC) of the kernel's view
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in rows of `row` bytes under the
// swizzle of that width (layout 3: 32 bytes, 2: 64, 1: 128), 8-row groups 8 * row bytes
// apart. The swizzle is a function of the shared-memory address itself (TMA writes it
// so, and wgmma reads it so with a zero base offset, as the card tests show), so the
// start may move by whole rows (the per-tap shift) and by 32 bytes within a row (the K
// slice).
template <int kRow>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr int row = kRow;
  constexpr uint64_t layout = row == 128 ? 1 : row == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * row >> 4) << 32) | (layout << 62);
}

#define SSD_ACC8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),             \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256 s32 over the warpgroup) += A (64 x 32 s8) * B (32 x 256 s8); d = A*B if
// !scale_d. Both operands from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : SSD_ACC8(0), SSD_ACC8(8), SSD_ACC8(16), SSD_ACC8(24), SSD_ACC8(32), SSD_ACC8(40),
        SSD_ACC8(48), SSD_ACC8(56), SSD_ACC8(64), SSD_ACC8(72), SSD_ACC8(80), SSD_ACC8(88),
        SSD_ACC8(96), SSD_ACC8(104), SSD_ACC8(112), SSD_ACC8(120)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef SSD_ACC8

struct TileCoords {
  int nb, b, h0, w0;
};

__device__ __forceinline__ TileCoords tile_coords(const Params& p, int t) {
  TileCoords c;
  c.nb = t % p.n_blocks;
  int u = t / p.n_blocks;
  const int tw = u % p.tiles_w;
  u /= p.tiles_w;
  const int th = u % p.tiles_h;
  c.b = u / p.tiles_h;
  c.h0 = th * p.R;
  c.w0 = tw * p.cols;
  return c;
}

template <typename Out>
__device__ __forceinline__ Out dequantize(int v, float scale, float bias, bool has_bias) {
  if constexpr (std::is_same<Out, int32_t>::value) {
    return v;
  } else {
    float y = __fmul_rn(__int2float_rn(v), scale);
    if (has_bias) y = __fadd_rn(y, bias);
    if constexpr (std::is_same<Out, float>::value) {
      return y;
    } else {
      return __float2bfloat16_rn(y);
    }
  }
}

// Shared memory, from the first 1,024-byte boundary: [2 staging tiles, one per consumer
// warpgroup, of kTileM x (64 + 16 / sizeof(Out)) outputs][stages x (halo_pixels rows of
// `row` bytes, taps_per_stage x 64 weight rows of `row` bytes)][full barriers][empty
// barriers][2 turns].
//
// Consumer warpgroup w owns the CTA's tiles i = w, w + 2, ... whole. Before tile i > 0
// it waits on turn[w], which the other warpgroup arrives on once it has seen tile
// i - 1's last stage full. Without the turn, a wait could pass on a phase of the ring
// one round old whenever the ring holds no more stages than a tile has K steps. Ring
// position i * k_steps + k holds K step k of the CTA's i-th tile.
//
// kTaps (taps a stage) and kSlices (row / 32) are compile-time, so a stage's kTaps x
// kSlices products unroll into one chain of wgmmas on the same accumulators; the plan
// picks (9, 1): 3x3 halo mode, or (1, 1), (1, 2), (1, 4): one tap a stage.
template <typename Out, int kTaps, int kSlices>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgmma(__grid_constant__ const CUtensorMap x_map, const Params p) {
  constexpr int kRow = kSlices * kK;
  constexpr int kSP = kNBlock + 16 / static_cast<int>(sizeof(Out));  // staging pitch
  constexpr size_t kStagingBytes = static_cast<size_t>(kTileM) * kSP * sizeof(Out);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  unsigned char* ring = smem + 2 * kStagingBytes;
  const uint32_t halo_bytes = static_cast<uint32_t>(p.halo_pixels) * kRow;
  constexpr uint32_t w_bytes = static_cast<uint32_t>(kTaps) * kNBlock * kRow;
  const uint32_t stage_bytes = halo_bytes + w_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(p.stages) * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* turn = empty + p.stages;
  const uint32_t ring_s = smem_addr(ring);

  const int tid = threadIdx.x;
  // The box fills box_pixels rows; the junk columns of the last taps read up to
  // kTileM + (KH - 1) P + KW - 1 rows. Zero the slack once, for every stage.
  const int slack = (p.halo_pixels - p.box_pixels) * kRow / 16;  // 16-byte words
  for (int i = tid; i < p.stages * slack; i += blockDim.x) {
    *reinterpret_cast<uint4*>(ring + static_cast<size_t>(i / slack) * stage_bytes +
                              static_cast<size_t>(p.box_pixels) * kRow + (i % slack) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 128);  // the warpgroup that consumes a stage
    }
    mbar_init(smem_addr(&turn[0]), 1);
    mbar_init(smem_addr(&turn[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // zeros -> wgmma reads
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      const uint32_t tx = static_cast<uint32_t>(p.box_pixels) * kRow + w_bytes;
      for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
        const TileCoords c = tile_coords(p, t);
        const int8_t* wsrc = p.wpack + static_cast<size_t>(c.nb) * p.chunks * p.taps * kNBlock * kRow;
        for (int k = 0; k < p.k_steps; ++k) {
          const int chunk = k / p.k_taps;
          const int tap = k - chunk * p.k_taps;  // 0 in halo mode: the stage holds all taps
          const int kh = tap / p.KW, kw = tap - (tap / p.KW) * p.KW;
          const uint32_t full_s = smem_addr(&full[stage]);
          mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
          mbar_expect_tx(full_s, tx);
          const uint32_t dst = ring_s + stage * stage_bytes;
          tma_load_4d(dst, &x_map, full_s, chunk * kRow, c.w0 * p.SW - p.PL + kw,
                      c.h0 * p.SH - p.PT + kh, c.b);
          bulk_load(dst + halo_bytes,
                    wsrc + (static_cast<size_t>(chunk) * p.taps + tap) * kNBlock * kRow,
                    w_bytes, full_s);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    int acc[128];  // D^T: 64 output channels x 256 pixels over the warpgroup
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int wg_tid = tid % 128;
    Out* staging = reinterpret_cast<Out*>(smem + wg * kStagingBytes);
    Out* out = static_cast<Out*>(p.out);
    const bool has_bias = p.bias != nullptr;
    float xs = 0.f;
    if constexpr (!std::is_same<Out, int32_t>::value) xs = __ldg(p.x_scale);
    for (int i = wg, t = blockIdx.x + wg * gridDim.x; t < p.num_tiles;
         i += 2, t += 2 * gridDim.x) {
      const TileCoords c = tile_coords(p, t);
      if (i > 0) mbar_wait(smem_addr(&turn[wg]), ((i - 1) / 2) & 1);
      int prev = -1;
      for (int k = 0; k < p.k_steps; ++k) {
        const int pos = i * p.k_steps + k;
        const int stage = pos % p.stages;
        mbar_wait(smem_addr(&full[stage]), (pos / p.stages) & 1);
        if (k == p.k_steps - 1 && wg_tid == 0) {
          mbar_arrive(smem_addr(&turn[1 - wg]));  // every position up to here is loaded
        }
        const uint32_t halo_s = ring_s + stage * stage_bytes;
        const uint32_t w_s = halo_s + halo_bytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < kTaps; ++s) {
#pragma unroll
          for (int q = 0; q < kSlices; ++q) {
            const uint64_t adesc = make_desc<kRow>(w_s + (s * kNBlock * kRow + q * kK));
            const uint64_t bdesc = make_desc<kRow>(halo_s + p.shift[s] * kRow + q * kK);
            wgmma_m64n256k32_s8(acc, adesc, bdesc, (k > 0 || s > 0 || q > 0) ? 1 : 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0) mbar_arrive(smem_addr(&empty[prev]));
        prev = stage;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(smem_addr(&empty[prev]));

      // Epilogue: dequantize into the staging tile [pixel][channel] (its threads are past
      // the previous tile's reads of it), then store. The thread holds channels ch and
      // ch + 8 of pixels 8j + 2 (lane % 4) + {0, 1}.
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      const int n0 = c.nb * kNBlock;
      const int ch = warp * 16 + lane / 4;
      float scale[2] = {0.f, 0.f}, bias[2] = {0.f, 0.f};
      if constexpr (!std::is_same<Out, int32_t>::value) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oc = n0 + ch + 8 * h;
          if (oc < p.OC) {
            scale[h] = __fmul_rn(xs, __ldg(p.w_scale + oc));  // the product of the scales first
            if (has_bias) bias[h] = __ldg(p.bias + oc);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 128; r += 2) {
        const int h = (r >> 1) & 1;
        const int px = 8 * (r >> 2) + 2 * (lane & 3);
        staging[px * kSP + ch + 8 * h] = dequantize<Out>(acc[r], scale[h], bias[h], has_bias);
        staging[(px + 1) * kSP + ch + 8 * h] =
            dequantize<Out>(acc[r + 1], scale[h], bias[h], has_bias);
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

      constexpr int kPerVec = 16 / static_cast<int>(sizeof(Out));  // outputs per 16 bytes
      constexpr int kVecs = kNBlock / kPerVec;                     // 16-byte vectors a row
      const bool vec_out = p.OC % kPerVec == 0;
      for (int idx = wg_tid; idx < kTileM * kVecs; idx += 128) {
        const int m = idx / kVecs;
        const int v = idx - m * kVecs;
        const int r = m / p.P;
        const int col = m - r * p.P;
        const int ho = c.h0 + r;
        const int wo = c.w0 + col;
        const int n = n0 + v * kPerVec;
        if (r >= p.R || col >= p.cols || ho >= p.Ho || wo >= p.Wo || n >= p.OC) continue;
        const Out* src = staging + m * kSP + v * kPerVec;
        Out* dst = out + ((static_cast<size_t>(c.b) * p.Ho + ho) * p.Wo + wo) * p.OC + n;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kPerVec && n + e < p.OC; ++e) dst[e] = src[e];
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded (PyTorch loads
// it), so the source links against nothing beyond the runtime.
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The 4-D map over xq (ICp, W, H, B): a box of `row` channels x (P * SW) x (box_rows *
// SH) x 1 with element strides (1, SW, SH, 1), so it lands box_rows x P pixels; zero
// fill outside; the swizzle of `row` bytes. Returns a CUDA error code (0 on success).
int encode_x_map(CUtensorMap* map, const void* xq, const Plan& p) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int B = p.B, H = p.H, W = p.W, ICp = p.ICp, row = p.row, SH = p.SH, SW = p.SW;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ICp), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ICp), static_cast<cuuint64_t>(W) * ICp,
                                 static_cast<cuuint64_t>(H) * W * ICp};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(row), static_cast<cuuint32_t>(p.P * SW),
                             static_cast<cuuint32_t>(p.box_rows * SH), 1};
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(SW), static_cast<cuuint32_t>(SH), 1};
  const CUtensorMapSwizzle swizzle = row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(xq), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename Out, int kTaps, int kSlices>
int launch(const CUtensorMap& x_map, const Params& p, int device, cudaStream_t stream) {
  const int smem = p.smem;
  static int allowed[64] = {};  // dynamic shared memory set per device so far (host time)
  auto* kernel = conv_wgmma<Out, kTaps, kSlices>;
  if (device >= 64 || smem > allowed[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) allowed[device] = smem;
  }
  kernel<<<p.grid, kThreads, smem, stream>>>(x_map, p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (taps a stage, row bytes): ops/cuda_int8.py::STAGE_SHAPES.
template <typename Out>
int launch_shape(const CUtensorMap& x_map, const Params& p, int device, cudaStream_t stream) {
  const int shape = p.taps_per_stage * 1000 + p.row;
  switch (shape) {
    case 9032: return launch<Out, 9, 1>(x_map, p, device, stream);
    case 1032: return launch<Out, 1, 1>(x_map, p, device, stream);
    case 1064: return launch<Out, 1, 2>(x_map, p, device, stream);
    case 1128: return launch<Out, 1, 4>(x_map, p, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x (pixels, IC) contiguous, bf16 (x_is_bf16 = 1) or float32, 16-byte aligned; x_scale a
// float32 on the device; xq (pixels, ICp) int8 with ICp % 32 == 0, zero past IC.
int ssd_int8_quantize(const void* x, int x_is_bf16, const float* x_scale, int8_t* xq,
                      long long pixels, int ic, int icp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ic == icp) {
    const long long n = pixels * ic;
    const unsigned blocks = static_cast<unsigned>((n + 16 * threads - 1) / (16 * threads));
    if (x_is_bf16) {
      quantize_pieces<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), x_scale, xq, n);
    } else {
      quantize_pieces<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x), x_scale,
                                                        xq, n);
    }
  } else {
    const long long groups = pixels * (icp / 16);
    const unsigned blocks = static_cast<unsigned>((groups + threads - 1) / threads);
    if (x_is_bf16) {
      quantize_groups<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), x_scale, xq, groups, ic, icp);
    } else {
      quantize_groups<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x), x_scale,
                                                        xq, groups, ic, icp);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// xq viewed as (B, H, W, ICp) int8, ICp % 32 == 0, 16-byte aligned; wpack the weights of
// ops/cuda_int8.py::pack_weights for this `row`; out viewed as (B, Ho, Wo, OC) as
// out_mode 0: int32 accumulators, 1: float32, 2: bf16 (dequantized, + bias if given).
// `plan` holds the n_plan integers of struct Plan from ops/cuda_int8.py::Int8Plan.kernel_ints.
int ssd_int8_conv(const int8_t* xq, const int8_t* wpack, const float* w_scale,
                  const float* x_scale, const float* bias, void* out, int out_mode,
                  const int* plan, int n_plan, int device, void* stream) {
  if (static_cast<size_t>(n_plan) * sizeof(int) != sizeof(Plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  std::memcpy(static_cast<Plan*>(&p), plan, sizeof(Plan));
  if (p.taps_per_stage > kMaxTaps || p.grid < 1 || p.grid > p.num_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.wpack = wpack;
  p.w_scale = w_scale;
  p.x_scale = x_scale;
  p.bias = bias;
  p.out = out;
  CUtensorMap x_map;
  const int enc = encode_x_map(&x_map, xq, p);
  if (enc != 0) return enc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case 0: return launch_shape<int32_t>(x_map, p, device, s);
    case 1: return launch_shape<float>(x_map, p, device, s);
    case 2: return launch_shape<__nv_bfloat16>(x_map, p, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

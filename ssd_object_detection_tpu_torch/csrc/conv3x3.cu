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
// What bounds it on this card: at the SSD300 VGG trunk shapes (batch 32, IC = OC = 64
// to 256) a layer is 212 GFLOP against 0.2-0.5 GB of traffic, so the tensor cores bound
// it: 0.215 ms at 989 TFLOP/s dense bf16 (the bytes take 0.055-0.138 ms at 3.35 TB/s).
//
// bf16 path (conv3x3_wgmma): an implicit GEMM on wgmma over output pixels x output
// channels x (9 taps x IC), with no im2col and no padded copy of x.
//   - Tile: one tile is R image rows x (P - 2) columns of one image for an N-block of
//     64 output channels (ops/cuda_conv.py::plan_conv picks P and R). The halo of the
//     tile, (R + 2) rows of pitch P pixels, sits in shared memory flattened and in the
//     no-swizzle K-major core-matrix order [8-channel group][pixel][8 ch]. Output pixel
//     (r, c) is GEMM column m = r * P + c of the tile's 256, and tap (ky, kx) reads halo
//     pixel m + ky * P + kx: the same buffer with the wgmma descriptor's start address
//     moved by (ky * P + kx) * 16 bytes. Columns c >= P - 2 and m >= R * P are junk,
//     computed and dropped.
//   - Transposed products: D^T (channels x pixels) = W^T X^T, one wgmma.m64n256k16 per
//     tap and 16-channel chunk, the weights as A (64 output channels) and the halo as B
//     (256 pixels). A shared-memory wgmma reads both operands each time: m64n256k16
//     reads 10 KB per 262,144 MACs, 0.039 B/MAC, 78 B/clock at the peak's 2,048
//     MACs/clock per SM, where pixels as M would read m64n64k16's 0.0625 (the whole
//     128 B/clock).
//   - Consumers: two warpgroups ping-pong, each owning every other tile of the CTA
//     whole (128 f32 accumulators per thread), so one warpgroup's epilogue overlaps
//     the other's products. They take turns at the ring (a pair of turn mbarriers): a
//     warpgroup starts a tile's waits only once the other has seen the last chunk of
//     its tile full, so every earlier ring position is loaded and the parity of each
//     wait names the right phase at any ring depth.
//   - Input by TMA: a 4-D tensor map over x (C, W, H, B), box (8, P, R + 2, 1), loaded at
//     (c0, w0 - 1, h0 - 1, b). The hardware fills the box's out-of-image part with zeros,
//     which is the SAME padding, and the channels past IC, which is the K padding. The
//     slack past the box that the junk columns of the last taps read is zeroed once.
//   - Weights: the wrapper lays them out once per call in the descriptor's K-major
//     core-matrix order, [N-block][16-channel chunk][tap][n/8][k/8][8 n][8 k], zero past
//     IC and OC; a chunk's 9 x 16 x 64 block is one cp.async.bulk copy into its stage.
//   - Ring: a stage is one 16-channel chunk (two halo channel groups + its weights).
//     One producer thread keeps the stages of the CTA's sequence of (tile, chunk) in
//     flight on full/empty mbarriers with transaction counts; a consumer waits, issues
//     9 taps, commits, waits for the previous stage's group and releases it. Consumers
//     first, the producer warpgroup last, with setmaxnreg moving registers to the
//     consumers.
//   - Persistent grid: one CTA per SM walks tiles t = blockIdx.x, + gridDim.x, ... with
//     the N-block innermost (neighbouring CTAs read the same halo, from L2).
//   - Epilogue: bias, ReLU and the cast to bf16 from the accumulators into the
//     warpgroup's staging tile [pixel][channel] in shared memory (apart from the ring,
//     so the ring keeps loading), then the 2x2 pool over pixels m, m + 1, m + P,
//     m + P + 1 and 16-byte stores of valid pixels and channels. Pooling after the cast
//     is the reference's own order.
//   - L2 -> SM bytes per stage at P = 32, R = 8: 10,240 B of halo and 18,432 B of
//     weights for 4.7 MFLOP, 164 FLOP/B (block3 at P = 77, R = 3: 153). Half the bf16
//     peak, 494 TFLOP/s, therefore needs about 3.0-3.2 TB/s from L2 across the card.
//     Two alternatives measured slower on the card (conv_ab.py, PERF.md): weights
//     resident in shared memory where one N-block's fit (block1, 460 FLOP/B), and
//     N-blocks of 128 with the two warpgroups splitting a tile's channels (200 FLOP/B,
//     but both warpgroups stop for the epilogue).
//
// float32 path (conv3x3_fma): wgmma has no full-float32 product and TF32 would break the
// 1e-5 tolerance, so float32 keeps plain FMA on the CUDA cores: one CTA of 8 warps per
// 16x16 output pixels x 64 channels, 32-channel chunks of the 18x18 halo and the
// weights in shared memory (zero outside the image and past IC, OC), each thread 64
// pixels x 1 channel; float32 lies on no timed path.
//
// Entry points (plain C, loaded with ctypes) launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() after the launch (or the failing call's code).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <chrono>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------------
// float32: CUDA-core FMA.

constexpr int kTH = 16;              // output rows per CTA
constexpr int kTW = 16;              // output columns per CTA
constexpr int kHR = kTH + 2;         // halo rows
constexpr int kHC = kTW + 2;         // halo columns
constexpr int kM = kTH * kTW;        // output pixels per CTA
constexpr int kBN = 64;              // output channels per CTA
constexpr int kKC = 32;              // input channels per chunk
constexpr int kThreads = 256;        // 8 warps
constexpr int kEpl = kBN + 4;        // leading dimension of the epilogue tile

constexpr size_t kFmaSmem = [] {
  const size_t operands = (static_cast<size_t>(kHR) * kHC * kKC + 9 * kKC * kBN) * sizeof(float);
  const size_t epilogue = static_cast<size_t>(kM) * kEpl * sizeof(float);
  return operands > epilogue ? operands : epilogue;
}();

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fma(const float* __restrict__ x, const float* __restrict__ wt,
            const float* __restrict__ bias, float* __restrict__ out, int H, int W, int IC,
            int OC, int tiles_w, int relu, int pool, int vec_x, int vec_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);  // [kHR * kHC][kKC]
  float* ws = halo + kHR * kHC * kKC;             // [9 * kKC][kBN]
  float* ep = reinterpret_cast<float*>(smem);     // [kM][kEpl], after the loop

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  // thread owns channel n_lane and the 64 pixels of rows 4*mg .. 4*mg + 3
  const int n_lane = tid % kBN;
  const int mg = tid / kBN;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const float* xb = x + static_cast<size_t>(b) * H * W * IC;
  for (int c0 = 0; c0 < IC; c0 += kKC) {
    __syncthreads();  // the previous chunk's products are done with the buffers
    constexpr int kHaloVecs = kHR * kHC * (kKC / 4);
    for (int v = tid; v < kHaloVecs; v += kThreads) {
      const int p = v / (kKC / 4);
      const int cv = v - p * (kKC / 4);
      const int hr = p / kHC;
      const int h = h0 - 1 + hr;
      const int w = w0 - 1 + (p - hr * kHC);
      const int c = c0 + cv * 4;
      float* dst = halo + p * kKC + cv * 4;
      const bool inside = h >= 0 && h < H && w >= 0 && w < W;
      const float* src = inside ? xb + (static_cast<size_t>(h) * W + w) * IC + c : xb;
      if (inside && vec_x && c + 4 <= IC) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = (inside && c + e < IC) ? src[e] : 0.f;
      }
    }
    constexpr int kWVecs = 9 * kKC * (kBN / 4);
    for (int v = tid; v < kWVecs; v += kThreads) {
      const int row = v / (kBN / 4);
      const int nv = v - row * (kBN / 4);
      const int tap = row / kKC;
      const int ci = c0 + (row - tap * kKC);
      const int n = n0 + nv * 4;
      float* dst = ws + row * kBN + nv * 4;
      const float* src = wt + (static_cast<size_t>(tap) * IC + ci) * OC + n;
      if (ci < IC && vec_w && n + 4 <= OC) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = (ci < IC && n + e < OC) ? src[e] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - ky * 3;
      const float* hbase = halo + ((4 * mg + ky) * kHC + kx) * kKC;
#pragma unroll 2
      for (int k = 0; k < kKC; ++k) {
        const float wv = ws[(tap * kKC + k) * kBN + n_lane];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += hbase[((i / kTW) * kHC + (i % kTW)) * kKC + k] * wv;
      }
    }
  }
  __syncthreads();  // every warp is done with the halo before the tile overwrites it
#pragma unroll
  for (int i = 0; i < 64; ++i) ep[(mg * 64 + i) * kEpl + n_lane] = acc[i];
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
        out[((static_cast<size_t>(b) * H + h) * W + w) * OC + oc] = v;
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
        out[((static_cast<size_t>(b) * Hp + ph) * Wp + pw) * OC + oc] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring.

constexpr int kTileM = 256;            // pixels per tile: the N of one m64n256k16
constexpr int kChunk = 16;             // input channels per stage (one k16 step per tap)
constexpr int kNBlock = 64;            // output channels per tile: the M of one m64n256k16
constexpr int kConsumers = 256;        // threads of the two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // + the producer warpgroup

struct WgmmaParams {
  int H, W, OC;
  int P, R;              // halo pitch (pixels) and output rows per tile
  int tiles_w, tiles_h, n_blocks, chunks, num_tiles;
  int halo_pixels;       // pixels per channel group in a stage, >= kTileM - 1 + 2P + 2 + 1
  int stages;
  int relu, pool;
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

// wgmma shared-memory descriptor, no swizzle: start address, leading (K-direction)
// and stride (M/N-direction) byte offsets between 8x16-byte core matrices.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 256 f32 over the warpgroup) += A (64 x 16) * B (16 x 256); d = A*B if !scale_d.
// Both operands from shared memory, K-major, no swizzle.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

struct TileCoords {
  int nb, b, h0, w0;
};

__device__ __forceinline__ TileCoords tile_coords(const WgmmaParams& p, int t) {
  TileCoords c;
  c.nb = t % p.n_blocks;
  int u = t / p.n_blocks;
  const int tw = u % p.tiles_w;
  u /= p.tiles_w;
  const int th = u % p.tiles_h;
  c.b = u / p.tiles_h;
  c.h0 = th * p.R;
  c.w0 = tw * (p.P - 2);
  return c;
}

// Shared memory: [2 staging tiles, one per consumer warpgroup, of kTileM x (64 + 8)
// bf16][stages x (2 halo groups, the chunk's weights)][full barriers][empty
// barriers][2 turn barriers].
//
// The products run transposed: D^T (output channels x pixels) = W^T x X^T, one
// wgmma.m64n256k16 per tap, the weights as A (64 output channels x 16 input channels)
// and the halo as B (16 input channels x the tile's 256 pixels, shifted per tap). Both
// are K-major core matrices, so the layouts are those of the untransposed product.
// Consumer warpgroup w owns the CTA's tiles i = w, w + 2, ... whole. Before tile i > 0
// it waits on turn[w], which the other warpgroup arrives on once it has seen tile
// i - 1's last chunk full. Without the turn, a wait could pass on a phase of the ring
// one round old whenever the ring holds no more stages than a tile has chunks. The
// ring's position i * chunks + k holds chunk k of the CTA's i-th tile.
__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_wgmma(__grid_constant__ const CUtensorMap x_map, const bf16* __restrict__ wpack,
              const float* __restrict__ bias, bf16* __restrict__ out, const WgmmaParams p) {
  constexpr int kSP = kNBlock + 8;  // staging pitch; +16 bytes: conflict-free row writes
  constexpr uint32_t kWBytes = 9 * kChunk * kNBlock * 2;  // one chunk's weights
  constexpr size_t kStagingBytes = static_cast<size_t>(kTileM) * kSP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + 2 * kStagingBytes;
  const uint32_t group_bytes = static_cast<uint32_t>(p.halo_pixels) * 16;
  const uint32_t stage_bytes = 2 * group_bytes + kWBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(p.stages) * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* turn = empty + p.stages;
  const uint32_t ring_s = smem_addr(ring);

  const int tid = threadIdx.x;
  // The box fills (R + 2) * P pixels of each channel group; the junk rows of the last
  // taps read up to kTileM + 2P + 2 pixels. Zero the slack once, for every stage.
  const int box_pixels = (p.R + 2) * p.P;
  for (int i = tid; i < p.stages * 2 * (p.halo_pixels - box_pixels); i += blockDim.x) {
    const int per_group = p.halo_pixels - box_pixels;
    const int g = i / per_group;
    const int px = box_pixels + i % per_group;
    *reinterpret_cast<uint4*>(ring + static_cast<size_t>(g / 2) * stage_bytes +
                              (g % 2) * group_bytes + static_cast<size_t>(px) * 16) =
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
      const uint32_t tx = 2 * static_cast<uint32_t>(box_pixels) * 16 + kWBytes;
      for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
        const TileCoords c = tile_coords(p, t);
        const bf16* wsrc = wpack + static_cast<size_t>(c.nb) * p.chunks * (kWBytes / 2);
        for (int k = 0; k < p.chunks; ++k) {
          const uint32_t full_s = smem_addr(&full[stage]);
          mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
          mbar_expect_tx(full_s, tx);
          const uint32_t dst = ring_s + stage * stage_bytes;
          tma_load_4d(dst, &x_map, full_s, k * kChunk, c.w0 - 1, c.h0 - 1, c.b);
          tma_load_4d(dst + group_bytes, &x_map, full_s, k * kChunk + 8, c.w0 - 1, c.h0 - 1, c.b);
          bulk_load(dst + 2 * group_bytes, wsrc + static_cast<size_t>(k) * (kWBytes / 2),
                    kWBytes, full_s);
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
    float acc[128];  // D^T: 64 output channels x 256 pixels over the warpgroup
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int Wt = p.P - 2;
    const int wg_tid = tid % 128;
    bf16* staging = reinterpret_cast<bf16*>(smem + wg * kStagingBytes);
    for (int i = wg, t = blockIdx.x + wg * gridDim.x; t < p.num_tiles;
         i += 2, t += 2 * gridDim.x) {
      const TileCoords c = tile_coords(p, t);
      if (i > 0) mbar_wait(smem_addr(&turn[wg]), ((i - 1) / 2) & 1);
      int prev = -1;
      for (int k = 0; k < p.chunks; ++k) {
        const int pos = i * p.chunks + k;
        const int stage = pos % p.stages;
        mbar_wait(smem_addr(&full[stage]), (pos / p.stages) & 1);
        if (k == p.chunks - 1 && wg_tid == 0) {
          mbar_arrive(smem_addr(&turn[1 - wg]));  // every position up to here is loaded
        }
        const uint32_t halo_s = ring_s + stage * stage_bytes;
        const uint32_t w_s = halo_s + 2 * group_bytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift = (tap / 3) * p.P + tap % 3;
          const uint64_t adesc = make_desc(w_s + tap * (kNBlock * kChunk * 2), 128, 256);
          const uint64_t bdesc = make_desc(halo_s + shift * 16, group_bytes, 128);
          wgmma_m64n256k16(acc, adesc, bdesc, (k > 0 || tap > 0) ? 1 : 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0) mbar_arrive(smem_addr(&empty[prev]));
        prev = stage;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(smem_addr(&empty[prev]));

      // Epilogue: bias, ReLU, one cast into the staging tile [pixel][channel] (its
      // threads are past the previous tile's reads of it), then pool and store. The
      // thread holds channels oc and oc + 8 of pixels 8j + 2 (lane % 4) + {0, 1}.
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      const int n0 = c.nb * kNBlock;
      const int oc = warp * 16 + lane / 4;
      const float bias_lo = n0 + oc < p.OC ? __ldg(bias + n0 + oc) : 0.f;
      const float bias_hi = n0 + oc + 8 < p.OC ? __ldg(bias + n0 + oc + 8) : 0.f;
#pragma unroll
      for (int r = 0; r < 128; r += 2) {
        const int ch = oc + 8 * ((r >> 1) & 1);
        const int px = 8 * (r >> 2) + 2 * (lane & 3);
        const float b = (r & 2) ? bias_hi : bias_lo;
        float v0 = acc[r] + b;
        float v1 = acc[r + 1] + b;
        if (p.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        staging[px * kSP + ch] = __float2bfloat16_rn(v0);
        staging[(px + 1) * kSP + ch] = __float2bfloat16_rn(v1);
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

      constexpr int kVecs = kNBlock / 8;  // 16-byte vectors per staged row
      const bool vec_out = (p.OC & 7) == 0;
      if (!p.pool) {
        for (int idx = wg_tid; idx < kTileM * kVecs; idx += 128) {
          const int m = idx / kVecs;
          const int v = idx - m * kVecs;
          const int r = m / p.P;
          const int col = m - r * p.P;
          const int h = c.h0 + r;
          const int w = c.w0 + col;
          const int n = n0 + v * 8;
          if (r >= p.R || col >= Wt || h >= p.H || w >= p.W || n >= p.OC) continue;
          const bf16* src = staging + m * kSP + v * 8;
          bf16* dst = out + ((static_cast<size_t>(c.b) * p.H + h) * p.W + w) * p.OC + n;
          if (vec_out && n + 8 <= p.OC) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && n + e < p.OC; ++e) dst[e] = src[e];
          }
        }
      } else {
        const int Hp = p.H / 2;
        const int Wp = p.W / 2;
        const int half_p = p.P / 2;
        for (int idx = wg_tid; idx < (p.R / 2) * half_p * kVecs; idx += 128) {
          const int pm = idx / kVecs;
          const int v = idx - pm * kVecs;
          const int pr = pm / half_p;
          const int pc = pm - pr * half_p;
          const int ph = c.h0 / 2 + pr;
          const int pw = c.w0 / 2 + pc;
          const int n = n0 + v * 8;
          if (2 * pc >= Wt || ph >= Hp || pw >= Wp || n >= p.OC) continue;
          const int m = 2 * pr * p.P + 2 * pc;
          uint4 q[4];
          q[0] = *reinterpret_cast<const uint4*>(staging + m * kSP + v * 8);
          q[1] = *reinterpret_cast<const uint4*>(staging + (m + 1) * kSP + v * 8);
          q[2] = *reinterpret_cast<const uint4*>(staging + (m + p.P) * kSP + v * 8);
          q[3] = *reinterpret_cast<const uint4*>(staging + (m + p.P + 1) * kSP + v * 8);
          uint4 res;
          const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&q[0]);
          const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q[1]);
          const __nv_bfloat162* cc = reinterpret_cast<const __nv_bfloat162*>(&q[2]);
          const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(&q[3]);
          __nv_bfloat162* r2 = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
          for (int e = 0; e < 4; ++e) r2[e] = __hmax2(__hmax2(a[e], b[e]), __hmax2(cc[e], d[e]));
          bf16* dst = out + ((static_cast<size_t>(c.b) * Hp + ph) * Wp + pw) * p.OC + n;
          if (vec_out && n + 8 <= p.OC) {
            *reinterpret_cast<uint4*>(dst) = res;
          } else {
            const bf16* rs = reinterpret_cast<const bf16*>(&res);
            for (int e = 0; e < 8 && n + e < p.OC; ++e) dst[e] = rs[e];
          }
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

// The 4-D map over x (C, W, H, B), box (8 channels, P pixels, R + 2 rows, 1 image),
// zero fill outside: the SAME padding. Returns a CUDA error code (0 on success).
int encode_x_map(CUtensorMap* map, const void* x, int B, int H, int W, int C, int P, int R) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(P), static_cast<cuuint32_t>(R + 2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_wgmma(const CUtensorMap& map, const void* wpack, const float* bias, void* out,
                 const WgmmaParams& p, int grid, int smem, int device, cudaStream_t stream) {
  static int allowed[64] = {};  // dynamic shared memory set per device so far (host time)
  if (device >= 64 || smem > allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) allowed[device] = smem;
  }
  conv3x3_wgmma<<<grid, kWgThreads, smem, stream>>>(
      map, static_cast<const bf16*>(wpack), bias, static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32. x (B, H, W, IC) and w (3, 3, IC, OC) contiguous float32, bias (OC,) float32;
// out is (B, H, W, OC), or (B, H/2, W/2, OC) with pool (H and W even).
int ssd_conv3x3_f32(const float* x, const float* w, const float* bias, float* out, int B, int H,
                    int W, int IC, int OC, int relu, int pool, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv3x3_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFmaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = IC % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = OC % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (OC + kBN - 1) / kBN, B);
  conv3x3_fma<<<grid, kThreads, kFmaSmem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, H, W, IC, OC, tiles_w, relu, pool, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// bf16. x (B, H, W, IC) contiguous bf16 with IC % 8 == 0 and a 16-byte aligned base;
// wpack the weights in the wgmma operand order (ops/cuda_conv.py::pack_weights) for
// N-blocks of 64; bias (OC,) float32; out as for float32. The tile plan (pitch P, rows
// R, halo_pixels, stages, smem bytes, grid) comes from ops/cuda_conv.py::plan_conv.
int ssd_conv3x3_bf16(const void* x, const void* wpack, const float* bias, void* out, int B,
                     int H, int W, int IC, int OC, int relu, int pool, int P, int R,
                     int halo_pixels, int stages, int smem, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int enc = encode_x_map(&map, x, B, H, W, IC, P, R);
  if (enc != 0) return enc;
  WgmmaParams p;
  p.H = H;
  p.W = W;
  p.OC = OC;
  p.P = P;
  p.R = R;
  p.tiles_w = (W + P - 3) / (P - 2);
  p.tiles_h = (H + R - 1) / R;
  p.n_blocks = (OC + kNBlock - 1) / kNBlock;
  p.chunks = (IC + kChunk - 1) / kChunk;  // IC: channels of x as loaded (a multiple of 8)
  p.num_tiles = B * p.tiles_h * p.tiles_w * p.n_blocks;
  p.halo_pixels = halo_pixels;
  p.stages = stages;
  p.relu = relu;
  p.pool = pool;
  if (grid > p.num_tiles) grid = p.num_tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_wgmma(map, wpack, bias, out, p, grid, smem, device, s);
}

// Host microseconds of one tensor-map encode for x's shape, the mean over `iters`.
double ssd_conv3x3_encode_us(const void* x, int B, int H, int W, int IC, int P, int R,
                             int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (encode_x_map(&map, x, B, H, W, IC, P, R) != 0) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

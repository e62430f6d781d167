// Greedy anchor matcher for Hopper (sm_90a): one CTA per image.
//
// Replaces the TPU kernel ssd_object_detection_tpu/ops/pallas_matcher.py::_matcher_kernel
// (pallas_call at pallas_matcher.py:204, wrapped by match_anchors_pallas). It computes,
// per image, exactly what the JAX reference ops/matching.py::match_anchors computes:
//
//   IoU     legacy-clamp IoU of the G ground truths against the D anchors, with the
//           JAX operation order (corners c - w*0.5; side = max(min(max) - max(min),
//           1e-10); inter = dx*dy; union = ((area_a + area_b) - inter) + 1e-10;
//           iou = inter / union). Every step is an explicit round-to-nearest
//           intrinsic, and the library is built with -fmad=false, so no FMA
//           contraction changes a bit: the integer outputs must be bit-equal to the
//           plain PyTorch matcher or assignments flip on near-ties. Invalid GT rows
//           read -1.
//   phase 1 num_valid greedy picks of the flat row-major first maximum of the masked
//           matrix (consumed rows and columns read -2), each consuming its row and
//           its column.
//   phase 2 each column phase 1 left takes its best row (lowest row on ties) when
//           that IoU is strictly greater than thresh.
//   gather  the matched GT's box and class are copied, so they are exact (the TPU
//           kernel needed a HIGHEST-precision one-hot matmul for the same result).
//
// Design. The TPU kernel keeps the (G, D) IoU matrix in 16 MB of VMEM and rescans all
// of it on each of the num_valid sequential phase-1 steps. A CTA here has at most
// 227 KB of shared memory, so the matrix (3.5 MB per image at G=100, D=8,732) lives
// in a global scratch of (B, G, D) f32, and a full rescan per step would be
// num_valid sequential passes over it from one SM. Instead each column caches its
// best (value, lowest row) over the rows not yet consumed. A phase-1 step is then an
// argmax over D cached pairs (the block reduction carries (value, flat index) and
// keeps the lower index on equal values), and afterwards only the columns whose
// cached row was just consumed rescan their column. The same build pass yields
// phase 2's per-column best over all rows, so phase 2 reads no matrix at all. Only
// the valid GT rows are ever computed, stored or rescanned (invalid rows are -1 and
// cannot win while a valid row is left; see the note above the build loop), so the
// work scales with num_valid, not with the padded G.
//
// What bounds it on this card: the build pass is num_valid*D IoUs per image (about 13
// fp32 operations each, one of them an IEEE division) and one write of them; phase 1
// is num_valid sequential block-wide reductions over D, each behind barriers, plus the
// rescans: with the legacy clamp every anchor far from all GTs has a tiny positive
// IoU, and its best is the smallest GT, so consuming that GT rescans most columns.
// Only B CTAs run (32 on the main path, for 132 SMs). Left for later: splitting one
// image across a thread-block cluster (distributed shared memory) to fill the card,
// and keeping the column cache in shared memory.
//
// Why the scratch stays: a variant that drops it and recomputes each rescanned IoU
// from the GT corners in shared memory (bit-identical values) was slower on the H100,
// 0.24 vs 0.20-0.22 ms on the main path's synthetic batch and 3.13-3.19 vs 2.62-2.65
// ms on a dense batch of 1,716 valid GTs (chip_smoke.py, both versions in one run;
// PERF.md, Findings). The likely reason: a rescanned cell then costs ~13 operations
// and an IEEE division, a multi-instruction sequence, where the stored value is one
// coalesced load (a warp reads consecutive columns of one row), and the build's
// stores do not stall the threads that issue them.
//
// Entry point: ssd_match_anchors (plain C, loaded with ctypes). It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (value, flat index) order of a first-maximum argmax: larger value wins, and on
// equal values the lower index wins.
__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other_v = __shfl_down_sync(0xffffffffu, v, offset);
    const int other_i = __shfl_down_sync(0xffffffffu, i, offset);
    if (better(other_v, other_i, v, i)) {
      v = other_v;
      i = other_i;
    }
  }
}

// Block-wide argmax; every thread returns with the winner.
__device__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      red_v[0] = v;
      red_i[0] = i;
    }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();  // red_v / red_i are rewritten by the next call
}

__global__ void __launch_bounds__(kThreads, 1)
match_kernel(const float* __restrict__ gt_boxes,         // (B, G, 4) cxcywh
             const int* __restrict__ gt_cls,             // (B, G)
             const unsigned char* __restrict__ gt_valid, // (B, G) bool
             const float* __restrict__ anchors,          // (D, 4) cxcywh
             int G, int D, float thresh,
             float* __restrict__ iou_all,     // scratch (B, G, D)
             float* __restrict__ cache_v_all, // scratch (B, D): best value, unconsumed rows
             int* __restrict__ cache_r_all,   // scratch (B, D): its lowest row
             int* __restrict__ out_index,     // (B, D)
             int* __restrict__ out_cls,       // (B, D)
             float* __restrict__ out_box,     // (B, D, 4)
             unsigned char* __restrict__ out_mask) {  // (B, D) bool
  extern __shared__ float smem[];
  float* g_x0 = smem;  // GT corners and areas, one row of G each
  float* g_y0 = g_x0 + G;
  float* g_x1 = g_y0 + G;
  float* g_y1 = g_x1 + G;
  float* g_area = g_y1 + G;
  int* col_gt = reinterpret_cast<int*>(g_area + G);  // (D,) phase-1 row, -1 if none
  int* valid_rows = col_gt + D;  // (G,) the valid rows in ascending order
  unsigned char* row_removed = reinterpret_cast<unsigned char*>(valid_rows + G);  // (G,)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int num_valid;
  __shared__ int first_invalid;  // lowest invalid row, G if none

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* gtb = gt_boxes + static_cast<size_t>(b) * G * 4;
  const int* gtc = gt_cls + static_cast<size_t>(b) * G;
  const unsigned char* gtv = gt_valid + static_cast<size_t>(b) * G;
  float* iou = iou_all + static_cast<size_t>(b) * G * D;
  float* cache_v = cache_v_all + static_cast<size_t>(b) * D;
  int* cache_r = cache_r_all + static_cast<size_t>(b) * D;
  int* idx_out = out_index + static_cast<size_t>(b) * D;

  for (int r = tid; r < G; r += kThreads) {
    const float cx = gtb[4 * r], cy = gtb[4 * r + 1];
    const float w = gtb[4 * r + 2], h = gtb[4 * r + 3];
    g_x0[r] = __fsub_rn(cx, __fmul_rn(w, 0.5f));
    g_y0[r] = __fsub_rn(cy, __fmul_rn(h, 0.5f));
    g_x1[r] = __fadd_rn(cx, __fmul_rn(w, 0.5f));
    g_y1[r] = __fadd_rn(cy, __fmul_rn(h, 0.5f));
    g_area[r] = __fmul_rn(w, h);
    row_removed[r] = 0;
  }
  for (int c = tid; c < D; c += kThreads) col_gt[c] = -1;
  if (tid == 0) {
    int n = 0, first = G;
    for (int r = 0; r < G; ++r) {
      if (gtv[r] != 0) {
        valid_rows[n++] = r;
      } else if (first == G) {
        first = r;
      }
    }
    num_valid = n;
    first_invalid = first;
  }
  __syncthreads();
  const int nv = num_valid;

  // Invalid rows read -1 everywhere, and a valid row's IoU is > 0 (w, h >= 0), so an
  // invalid row can only win a column with no valid row. Phase 1 consumes at most one
  // valid row per step, so while steps remain every column keeps an unconsumed valid
  // row: the build, the cache and the rescans visit valid rows only, and only phase
  // 2's all-rows maximum adds the (-1, first_invalid) candidate.
  //
  // Build: one thread per column writes the column's valid-row IoUs (coalesced across
  // threads), its phase-1 cache and its phase-2 candidate (kept in idx_out).
  for (int c = tid; c < D; c += kThreads) {
    const float4 a = reinterpret_cast<const float4*>(anchors)[c];
    const float ax0 = __fsub_rn(a.x, __fmul_rn(a.z, 0.5f));
    const float ay0 = __fsub_rn(a.y, __fmul_rn(a.w, 0.5f));
    const float ax1 = __fadd_rn(a.x, __fmul_rn(a.z, 0.5f));
    const float ay1 = __fadd_rn(a.y, __fmul_rn(a.w, 0.5f));
    const float a_area = __fmul_rn(a.z, a.w);
    float best_v = -INFINITY;
    int best_r = 0;
    for (int k = 0; k < nv; ++k) {
      const int r = valid_rows[k];
      const float dx = fmaxf(__fsub_rn(fminf(g_x1[r], ax1), fmaxf(g_x0[r], ax0)), 1e-10f);
      const float dy = fmaxf(__fsub_rn(fminf(g_y1[r], ay1), fmaxf(g_y0[r], ay0)), 1e-10f);
      const float inter = __fmul_rn(dx, dy);
      const float uni = __fadd_rn(__fsub_rn(__fadd_rn(g_area[r], a_area), inter), 1e-10f);
      const float v = __fdiv_rn(inter, uni);
      iou[static_cast<size_t>(r) * D + c] = v;
      if (v > best_v) {  // ascending rows + strict '>' keeps the lowest row on ties
        best_v = v;
        best_r = r;
      }
    }
    cache_v[c] = best_v;
    cache_r[c] = best_r;
    if (first_invalid < G && better(-1.0f, first_invalid, best_v, best_r)) {
      best_v = -1.0f;
      best_r = first_invalid;
    }
    idx_out[c] = best_v > thresh ? best_r : -1;
  }
  __syncthreads();

  // Phase 1. While a column is unconsumed at least one row is unconsumed, and its
  // entries (>= -1) beat every -2 cell, so the masked matrix's first maximum is the
  // best cached pair over unconsumed columns. Only when every column is consumed is
  // the whole matrix -2, and the first maximum is then flat index 0: thread 0 seeds
  // that candidate.
  for (int t = 0; t < nv; ++t) {
    float best_v = tid == 0 ? -2.0f : -INFINITY;
    int best_i = tid == 0 ? 0 : INT_MAX;
    for (int c = tid; c < D; c += kThreads) {
      if (col_gt[c] >= 0) continue;
      const float v = cache_v[c];
      const int i = cache_r[c] * D + c;
      if (better(v, i, best_v, best_i)) {
        best_v = v;
        best_i = i;
      }
    }
    block_argmax(best_v, best_i, red_v, red_i);
    const int row = best_i / D;
    const int col = best_i - row * D;
    if (tid == 0) {
      col_gt[col] = row;
      row_removed[row] = 1;
    }
    __syncthreads();
    if (t + 1 == nv) break;
    // Only columns whose cached row was just consumed change their best.
    for (int c = tid; c < D; c += kThreads) {
      if (col_gt[c] >= 0 || cache_r[c] != row) continue;
      float v_best = -INFINITY;
      int r_best = 0;
      for (int k = 0; k < nv; ++k) {
        const int r = valid_rows[k];
        if (row_removed[r]) continue;
        const float v = iou[static_cast<size_t>(r) * D + c];
        if (v > v_best) {
          v_best = v;
          r_best = r;
        }
      }
      cache_v[c] = v_best;
      cache_r[c] = r_best;
    }
    // The next step's block_argmax barrier orders these writes before any reuse.
  }
  __syncthreads();

  // Phase 2 result (from the build) unless phase 1 took the column; exact gather.
  for (int c = tid; c < D; c += kThreads) {
    const int g = col_gt[c] >= 0 ? col_gt[c] : idx_out[c];
    const size_t o = static_cast<size_t>(b) * D + c;
    idx_out[c] = g;
    out_mask[o] = g >= 0;
    out_cls[o] = g >= 0 ? gtc[g] : 0;
    reinterpret_cast<float4*>(out_box)[o] =
        g >= 0 ? reinterpret_cast<const float4*>(gtb)[g] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for G ground truths and D anchors.
size_t ssd_match_anchors_smem_bytes(int G, int D) {
  return static_cast<size_t>(5 * G) * sizeof(float) + static_cast<size_t>(D + G) * sizeof(int) +
         static_cast<size_t>(G);
}

int ssd_match_anchors(const float* gt_boxes, const int* gt_cls, const unsigned char* gt_valid,
                      const float* anchors, int B, int G, int D, float thresh, float* iou_scratch,
                      float* cache_v, int* cache_r, int* out_index, int* out_cls, float* out_box,
                      unsigned char* out_mask, int device, void* stream) {
  const size_t smem = ssd_match_anchors_smem_bytes(G, D);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  match_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gt_boxes, gt_cls, gt_valid, anchors, G, D, thresh, iou_scratch, cache_v, cache_r, out_index,
      out_cls, out_box, out_mask);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

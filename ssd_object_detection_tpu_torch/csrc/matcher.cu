// Greedy anchor matcher for Hopper (sm_90a): one thread-block cluster per image, a
// per-GT row cache in shared memory, no IoU matrix anywhere.
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
// What bounds it on this card. The bytes are tiny (inputs and outputs once: 2 us at
// B=32, G=100, D=8,732), and the operations are few for the card; the time is the
// launch, the IoU instructions of the build on the SMs an image gets (about 36 a pair,
// an IEEE division among them; instruction throughput limits it), and a chain of dependent
// steps: num_valid sequential picks per image, each needing the maximum of what is
// left of a (num_valid, D) matrix.
//
// What the design does about it.
//
//   Row cache. A phase-1 pick is the best, by (value, lowest row), of each unconsumed
//   valid row's own best (value, lowest column) over the unconsumed columns. So the
//   state of the greedy loop is one 64-bit key per valid row (at most G of them) in
//   shared memory, not one entry per column: key = (ordered value bits << 31) |
//   (0x7fffffff - column), so that an unsigned maximum is "largest value, then lowest
//   column"; 0 means "no column left". A step is an argmax over those keys by ONE warp
//   (two warp reductions and a shuffle, no barrier, no pass over D). Only a row whose
//   cached column was just consumed by another row has to look again: it rescans the
//   unconsumed columns (a D-bit mask in shared memory), recomputing its D IoUs from
//   the corners with the very same intrinsics, so no IoU is ever stored. All rows
//   flagged by one pick share one pass of rank 0's whole CTA; this is the rare path (no
//   rescan at all on the synthetic training batch) and the only one behind a barrier.
//
//   Cluster. The parallel part is the build: num_valid x D IoUs, each column's best
//   over all valid rows (phase 2, which does not depend on phase 1 except on the
//   picked columns) and each row's best over the columns. An image's columns are split
//   over the C CTAs of a cluster, as many as the card holds all at once (C and the
//   threads come from ops/cuda_matcher.py::plan; small CTAs of several images share an
//   SM). A thread holds kColsPerThread columns in registers and walks the rows; a warp
//   reduces a row with two redux instructions and one 64-bit shared-memory atomicMax.
//   Each CTA writes phase 2's result for its slice straight to the outputs (the box
//   with 16-byte stores), then hands its row keys to rank 0 through distributed shared
//   memory (one slot per rank, so no remote atomics) and leaves after the cluster's
//   barrier. Rank 0 merges the slots, its first warp runs phase 1, and the CTA then
//   overwrites the at most num_valid picked columns. The pick list never travels:
//   phase 2 is already in place.
//
//   Corner cases keep the meaning they had: invalid rows read -1 and enter only phase
//   2's candidate as (-1, first_invalid), which matters for a thresh below -1; when
//   every column is consumed (num_valid > D) the masked matrix is all -2 and the pick
//   is flat index 0, so column 0 ends at row 0; an image with no valid GT writes
//   phase 2 only.
//
// Measured and dropped (conv_ab.py --kernel matcher on an NVIDIA H100 80GB HBM3 at
// 700 W, times replayed from a CUDA graph; PERF.md has the tables): per-warp key slots
// instead of the shared-memory atomicMax (no faster on the training batch, 7 % slower
// on the dense one); rescans by the whole cluster, told by rank 0 through distributed
// shared memory (two cluster barriers a pass: 2 % slower on the training batch, 3 %
// faster on the dense one, and the other ranks can no longer leave early); the build's
// row loop without its branch on ragged columns (no faster).
//
// The design this one replaced (one CTA of 1,024 threads per image, the valid rows'
// IoUs in a (B, G, D) float32 scratch in device memory, a per-COLUMN cache of the best
// unconsumed row in device memory, a block-wide argmax over D behind four barriers per
// step, and a rescan of every column whose cached row was consumed) took, on the same
// card in the same calls, 0.1355 ms on the synthetic training batch (B=32, G=100,
// D=8,732, 291 valid GTs; 0.1772-0.1987 ms per call on an idle card), 2.5688 ms on a
// dense batch (1,716 valid of 3,200) and 1.0907 ms with SSD512's 24,564 anchors at
// B=8, where this design takes 0.0193, 0.339 and 0.042 ms.
//
// Entry point: ssd_match_anchors (plain C, loaded with ctypes). It launches on the
// caller's stream, allocates nothing, and returns the launch's error code. The function
// attribute for large dynamic shared memory is set once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kColsPerThread = 4;  // columns a thread holds in registers (plan: COLS_PER_THREAD)
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kColumnField = 0x7fffffffu;  // low 31 bits of a key
constexpr int kMaxDevices = 64;
constexpr int kMaxDynamicSmem = 232448 - 1024;  // a CTA's limit less the static buffers

typedef unsigned long long Key;

// (value, index) order of a first-maximum argmax: larger value wins, and on equal
// values the lower index wins.
__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

// A float's bits mapped so that the unsigned order is the float order (finite values;
// never 0 for a number).
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned bits = __float_as_uint(v);
  return bits ^ (static_cast<unsigned>(static_cast<int>(bits) >> 31) | 0x80000000u);
}

// Larger key = larger value, then lower column.
__device__ __forceinline__ Key make_key(unsigned value_bits, unsigned column) {
  return (static_cast<Key>(value_bits) << 31) | (kColumnField - column);
}

__device__ __forceinline__ int key_column(Key key) {
  return static_cast<int>(kColumnField - (static_cast<unsigned>(key) & kColumnField));
}

struct Corners {
  float x0, y0, x1, y1, area;
};

__device__ __forceinline__ Corners corners_of(float cx, float cy, float w, float h) {
  Corners c;
  c.x0 = __fsub_rn(cx, __fmul_rn(w, 0.5f));
  c.y0 = __fsub_rn(cy, __fmul_rn(h, 0.5f));
  c.x1 = __fadd_rn(cx, __fmul_rn(w, 0.5f));
  c.y1 = __fadd_rn(cy, __fmul_rn(h, 0.5f));
  c.area = __fmul_rn(w, h);
  return c;
}

__device__ __forceinline__ float legacy_iou(const Corners& g, const Corners& a) {
  const float dx = fmaxf(__fsub_rn(fminf(g.x1, a.x1), fmaxf(g.x0, a.x0)), 1e-10f);
  const float dy = fmaxf(__fsub_rn(fminf(g.y1, a.y1), fmaxf(g.y0, a.y0)), 1e-10f);
  const float inter = __fmul_rn(dx, dy);
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(g.area, a.area), inter), 1e-10f);
  return __fdiv_rn(inter, uni);
}

// The warp's best (value bits, lowest column) goes into the row's key; lanes with no
// candidate take part with value_bits == 0.
__device__ __forceinline__ void warp_offer(Key* row_key, unsigned value_bits, unsigned column) {
  const unsigned top = __reduce_max_sync(kFullMask, value_bits);
  const unsigned col = __reduce_min_sync(kFullMask, value_bits == top ? column : kColumnField);
  if ((threadIdx.x & 31) == 0 && top != 0) atomicMax(row_key, make_key(top, col));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct Gts {  // shared-memory views of one image's ground truths
  const float* x0;
  const float* y0;
  const float* x1;
  const float* y1;
  const float* area;
  __device__ __forceinline__ Corners at(int r) const {
    Corners c;
    c.x0 = x0[r];
    c.y0 = y0[r];
    c.x1 = x1[r];
    c.y1 = y1[r];
    c.area = area[r];
    return c;
  }
};

__device__ __forceinline__ void write_column(int g, size_t o, const float* gtb, const int* gtc,
                                             int* out_index, int* out_cls, float* out_box,
                                             unsigned char* out_mask) {
  out_index[o] = g;
  out_mask[o] = g >= 0;
  out_cls[o] = g >= 0 ? gtc[g] : 0;
  reinterpret_cast<float4*>(out_box)[o] =
      g >= 0 ? reinterpret_cast<const float4*>(gtb)[g] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
match_kernel(const float* __restrict__ gt_boxes,         // (B, G, 4) cxcywh
             const int* __restrict__ gt_cls,             // (B, G)
             const unsigned char* __restrict__ gt_valid, // (B, G) bool
             const float* __restrict__ anchors,          // (D, 4) cxcywh
             int G, int D, float thresh, int slice_cols,
             int* __restrict__ out_index,     // (B, D)
             int* __restrict__ out_cls,       // (B, D)
             float* __restrict__ out_box,     // (B, D, 4)
             unsigned char* __restrict__ out_mask) {  // (B, D) bool
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / ranks;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Dynamic shared memory; smem_bytes() below and ops/cuda_matcher.py::smem_bytes count it.
  extern __shared__ __align__(16) unsigned char smem[];
  Key* row_key = reinterpret_cast<Key*>(smem);  // (G,) per valid row k: best unconsumed column
  Key* slots = row_key + G;                     // (ranks, G) rank 0's inbox, one row per rank
  int2* picks = reinterpret_cast<int2*>(slots + static_cast<size_t>(ranks) * G);  // (G,) (k, col)
  float* g_x0 = reinterpret_cast<float*>(picks + G);  // GT corners and areas, (G,) each
  float* g_y0 = g_x0 + G;
  float* g_x1 = g_y0 + G;
  float* g_y1 = g_x1 + G;
  float* g_area = g_y1 + G;
  int* valid_rows = reinterpret_cast<int*>(g_area + G);  // (G,) the valid rows, ascending
  int* flagged = valid_rows + G;                         // (G,) rows k that must rescan
  unsigned* consumed = reinterpret_cast<unsigned*>(flagged + G);  // ceil(D / 32) words, a bit per column
  __shared__ int num_valid;
  __shared__ int first_invalid;  // lowest invalid row, G if none
  __shared__ int num_flagged;    // rows to rescan; 0 ends the greedy loop
  __shared__ int num_picks;
  __shared__ int all_consumed;   // the pick at flat index 0 happened

  // Every CTA of the cluster runs before any of them writes into rank 0's shared
  // memory: arrive now, wait just before those writes.
  cluster_arrive();

  const float* gtb = gt_boxes + static_cast<size_t>(b) * G * 4;
  const int* gtc = gt_cls + static_cast<size_t>(b) * G;
  const unsigned char* gtv = gt_valid + static_cast<size_t>(b) * G;
  const size_t out0 = static_cast<size_t>(b) * D;

  for (int r = tid; r < G; r += threads) {
    const float4 g = reinterpret_cast<const float4*>(gtb)[r];
    const Corners c = corners_of(g.x, g.y, g.z, g.w);
    g_x0[r] = c.x0;
    g_y0[r] = c.y0;
    g_x1[r] = c.x1;
    g_y1[r] = c.y1;
    g_area[r] = c.area;
    row_key[r] = 0;
  }
  if (rank == 0) {
    for (int w = tid; w < (D + 31) / 32; w += threads) consumed[w] = 0;
  }
  if (warp == 0) {  // compact the valid rows in ascending order
    int n = 0, first = G;
    for (int base = 0; base < G; base += 32) {
      const int r = base + lane;
      const bool ok = r < G && gtv[r] != 0;
      const unsigned votes = __ballot_sync(kFullMask, ok);
      if (ok) valid_rows[n + __popc(votes & ((1u << lane) - 1u))] = r;
      n += __popc(votes);
      const unsigned holes = __ballot_sync(kFullMask, r < G && !ok);
      if (first == G && holes != 0) first = base + __ffs(holes) - 1;
    }
    if (lane == 0) {
      num_valid = n;
      first_invalid = first;
    }
  }
  __syncthreads();
  const int nv = num_valid;
  const Gts gts = {g_x0, g_y0, g_x1, g_y1, g_area};

  // Invalid rows read -1 everywhere, and a valid row's IoU is > 0 (w, h >= 0), so an
  // invalid row can only win a column with no valid row. Phase 1 consumes at most one
  // valid row per step, so while steps remain every column keeps an unconsumed valid
  // row: the build, the row keys and the rescans visit valid rows only, and only phase
  // 2's all-rows maximum adds the (-1, first_invalid) candidate.
  //
  // Build, over this CTA's slice of the columns. Thread t holds columns base + j *
  // threads + t (j < kColsPerThread) in registers and walks the valid rows in
  // ascending order: per column the best over all valid rows (phase 2), per row the
  // warp's best (value, lowest column) into the row's key.
  const int c0 = min(D, rank * slice_cols);
  const int c1 = min(D, c0 + slice_cols);
  for (int base = c0; base < c1; base += threads * kColsPerThread) {
    if (base + warp * 32 >= c1) continue;  // the whole warp has no column in this chunk
    Corners a[kColsPerThread];
    float best_v[kColsPerThread];
    int best_r[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = base + j * threads + tid;
      const float4 box = c < c1 ? reinterpret_cast<const float4*>(anchors)[c]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      a[j] = corners_of(box.x, box.y, box.z, box.w);
      best_v[j] = -INFINITY;
      best_r[j] = 0;
    }
    for (int k = 0; k < nv; ++k) {
      const int r = valid_rows[k];
      const Corners g = gts.at(r);
      unsigned top = 0, top_col = kColumnField;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = base + j * threads + tid;
        const float v = legacy_iou(g, a[j]);
        if (c < c1) {
          if (v > best_v[j]) {  // ascending rows + strict '>' keeps the lowest row on ties
            best_v[j] = v;
            best_r[j] = r;
          }
          const unsigned bits = ordered_bits(v);
          if (bits > top) {  // ascending columns + strict '>' keeps the lowest column
            top = bits;
            top_col = static_cast<unsigned>(c);
          }
        }
      }
      warp_offer(&row_key[k], top, top_col);
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = base + j * threads + tid;
      if (c >= c1) continue;
      float v = best_v[j];
      int r = best_r[j];
      if (first_invalid < G && better(-1.0f, first_invalid, v, r)) {
        v = -1.0f;
        r = first_invalid;
      }
      write_column(v > thresh ? r : -1, out0 + c, gtb, gtc, out_index, out_cls, out_box, out_mask);
    }
  }
  __syncthreads();

  // Hand this slice's row keys to rank 0, one slot per rank; the cluster's barrier
  // orders them, and this CTA's output writes, before anything rank 0 does next.
  cluster_wait();
  if (rank != 0) {
    Key* inbox = cluster.map_shared_rank(slots, 0) + static_cast<size_t>(rank) * G;
    for (int k = tid; k < nv; k += threads) inbox[k] = row_key[k];
  }
  cluster_arrive();
  cluster_wait();
  if (rank != 0) return;  // nobody reads or writes this CTA's shared memory from here on

  for (int k = tid; k < nv; k += threads) {
    Key key = row_key[k];
    for (int other = 1; other < ranks; ++other) {
      const Key theirs = slots[static_cast<size_t>(other) * G + k];
      key = theirs > key ? theirs : key;
    }
    row_key[k] = key;
  }
  if (tid == 0) {
    num_picks = 0;
    all_consumed = 0;
  }
  __syncthreads();

  // Phase 1. Warp 0 runs the greedy steps on the row keys alone; the other warps wait
  // at the barrier below and only ever wake for a rescan or the end. Lane l owns rows
  // l, l + 32, ...: only it reads and writes their keys, so a step needs no barrier and
  // no __syncwarp(): two warp reductions find the winner, a shuffle tells its column.
  int step = 0;       // picks made (warp 0)
  int last_col = -1;  // the column of the last pick, not yet checked against the keys
  for (;;) {
    if (warp == 0) {
      int waiting = 0;
      while (step < nv) {
        // Read the keys: a row whose cached column the last pick consumed is flagged,
        // every other live row is a candidate.
        unsigned top = 0;
        int top_k = INT_MAX, top_col = 0;
        for (int base = 0; base < nv; base += 32) {
          const int k = base + lane;
          const Key key = k < nv ? row_key[k] : 0;
          const int col = key_column(key);
          const bool clash = key != 0 && col == last_col;
          const unsigned votes = __ballot_sync(kFullMask, clash);
          if (clash) {
            flagged[waiting + __popc(votes & ((1u << lane) - 1u))] = k;
            row_key[k] = 0;
          }
          waiting += __popc(votes);
          const unsigned bits = static_cast<unsigned>(key >> 31);
          if (!clash && bits > top) {  // ascending rows + strict '>' keeps the lowest row
            top = bits;
            top_k = k;
            top_col = col;
          }
        }
        last_col = -1;
        if (waiting != 0) break;  // rescan first, then take this step again
        const unsigned best = __reduce_max_sync(kFullMask, top);
        if (best == 0) {
          // Every column is consumed: the masked matrix is all -2, its first maximum is
          // flat index 0, in this step and in all that follow.
          if (lane == 0) all_consumed = 1;
          break;
        }
        const int k = static_cast<int>(
            __reduce_min_sync(kFullMask, top == best ? static_cast<unsigned>(top_k) : kColumnField));
        const int col = __shfl_sync(kFullMask, top_col, k & 31);
        if (lane == (k & 31)) row_key[k] = 0;  // placed
        if (lane == 0) {
          picks[step] = make_int2(k, col);
          consumed[col >> 5] |= 1u << (col & 31);
        }
        last_col = col;
        ++step;
      }
      if (lane == 0) {
        num_flagged = waiting;
        num_picks = step;
      }
    }
    __syncthreads();
    const int todo = num_flagged;
    if (todo == 0) break;
    // Rescan: each flagged row's best (value, lowest column) over the unconsumed
    // columns, IoUs recomputed from the corners. A thread takes kColsPerThread columns
    // at a time, ascending, so that their anchor loads are in flight together.
    for (int f = 0; f < todo; ++f) {
      const int k = flagged[f];
      const Corners g = gts.at(valid_rows[k]);
      unsigned top = 0, top_col = kColumnField;
      for (int base = 0; base < D; base += threads * kColsPerThread) {
        float4 box[kColsPerThread];
        bool open[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int c = base + j * threads + tid;
          open[j] = c < D && ((consumed[c >> 5] >> (c & 31)) & 1u) == 0;
          if (open[j]) box[j] = __ldg(reinterpret_cast<const float4*>(anchors) + c);
        }
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          if (!open[j]) continue;
          const Corners a = corners_of(box[j].x, box[j].y, box[j].z, box[j].w);
          const unsigned bits = ordered_bits(legacy_iou(g, a));
          if (bits > top) {  // ascending columns + strict '>' keeps the lowest column
            top = bits;
            top_col = static_cast<unsigned>(base + j * threads + tid);
          }
        }
      }
      warp_offer(&row_key[k], top, top_col);
    }
    __syncthreads();
  }

  // The picked columns take their pick; when every column was consumed, column 0
  // ends at row 0 (the last pick of flat index 0 overwrote it).
  const int n = num_picks;
  for (int i = tid; i < n; i += threads) {
    const int2 pick = picks[i];  // (valid row k, column)
    const int g = (all_consumed && pick.y == 0) ? 0 : valid_rows[pick.x];
    write_column(g, out0 + pick.y, gtb, gtc, out_index, out_cls, out_box, out_mask);
  }
}

__global__ void empty_kernel() {}

// Dynamic shared memory one CTA needs for G ground truths, D anchors and a cluster of
// `ranks` CTAs per image; a launch with less is refused.
size_t smem_bytes(int G, int D, int ranks) {
  return static_cast<size_t>(G) * (sizeof(Key) * (1 + ranks) + sizeof(int2) + 5 * sizeof(float) +
                                   2 * sizeof(int)) +
         static_cast<size_t>((D + 31) / 32) * sizeof(unsigned);
}

// The device is made current for this library's runtime, and the kernel's function
// attribute is set, once per device and thread, not per call.
cudaError_t prepare(int device) {
  static bool configured[kMaxDevices] = {};
  static thread_local int current = -1;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    current = device;
  }
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int ctas, int threads, size_t smem, void* stream,
                                 cudaLaunchAttribute* attribute, int ranks) {
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = ranks;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

// One launch: B clusters of `ranks` CTAs of `threads` threads; CTA `rank` takes columns
// [rank * slice_cols, (rank + 1) * slice_cols) of its image.
int ssd_match_anchors(const float* gt_boxes, const int* gt_cls, const unsigned char* gt_valid,
                      const float* anchors, int B, int G, int D, float thresh, int* out_index,
                      int* out_cls, float* out_box, unsigned char* out_mask, int ranks,
                      int threads, int slice_cols, int smem, int device, void* stream) {
  if (B < 1 || G < 1 || D < 1 || ranks < 1 || ranks > 8 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(ranks) * slice_cols < D ||
      static_cast<size_t>(smem) < smem_bytes(G, D, ranks) || smem > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config =
      launch_config(B * ranks, threads, static_cast<size_t>(smem), stream, &attribute, ranks);
  err = cudaLaunchKernelEx(&config, match_kernel, gt_boxes, gt_cls, gt_valid, anchors, G, D,
                           thresh, slice_cols, out_index, out_cls, out_box, out_mask);
  return static_cast<int>(err);
}

// An empty kernel with the matcher's grid and cluster shape: the launch floor.
int ssd_match_empty_launch(int ctas, int ranks, int threads, int device, void* stream) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = launch_config(ctas, threads, 0, stream, &attribute, ranks);
  return static_cast<int>(cudaLaunchKernelEx(&config, empty_kernel));
}

// How many clusters of this shape the device can hold at once (0: it cannot be
// scheduled); negative: a CUDA error code, negated.
int ssd_match_max_active_clusters(int ranks, int threads, int smem, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config =
      launch_config(ranks, threads, static_cast<size_t>(smem), nullptr, &attribute, ranks);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, match_kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

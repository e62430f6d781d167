// JPEG decoding on Hopper (sm_90a): K1 (five kernels) and the fused K2 + K3 kernel,
// launched by ops/cuda_image.py in order on one stream (progressive refinement scans go
// through csrc/jpeg_progressive.cu's K6 after K1, into the same coefficients).
//
//   K1 guess_kernel, round2_kernel, repair_kernel, write_kernel, dc_kernel
//                      Huffman decoding of each restart segment of a scan that first
//                      sends its coefficients: sequential (jdhuff.c), progressive DC
//                      first and AC first (jdphuff.c), many threads a segment; corrupt
//                      data as libjpeg decodes it (a code longer than 16 bits is symbol
//                      0 after 17 bits; where a segment's data runs out at its marker,
//                      the MCU finishes on zero bits and the segment's later MCUs are
//                      not decoded).
//   K2 + K3 idct_color_kernel
//                      dequantisation and libjpeg's jpeg_idct_islow as libjpeg-turbo's
//                      SIMD code computes it (16-bit lanes, saturating passes), then
//                      libjpeg-turbo's upsampling (jdsample.c), YCbCr->RGB (jdcolor.c),
//                      CMYK and YCCK as cv2 converts them, and the Exif orientation, as
//                      cv2.imdecode gives them: a CTA a tile of MCUs, the component
//                      planes in shared memory only. A JPEG-in-TIFF chunk but YCbCr's
//                      (colour space 5, data/codec.py SPACE_RAW) leaves its components
//                      unconverted, a byte each a pixel, as libtiff asks libjpeg for them
//                      (JCS_UNKNOWN): its tile holds 3 / ncomp of the rows, so that the
//                      RGB stage holds its 4 bytes a pixel.
//
// Replaces no Pallas kernel: the JAX package decodes with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70-87, eval/serve.py:374-381). The plain
// versions, which these are held to bit for bit, are ops/plain_image.py::entropy_decode
// and ::color(::idct(...)); the host lays the batch out (data/codec.py::jpeg_batch). K2 is the
// islow IDCT as the SIMD code of the libjpeg-turbo inside cv2 computes it (16-bit lanes,
// saturating passes), which differs from the C code's range_limit on the blocks corrupt
// data gives.
//
// What bounds them on an H100:
//   K1 is a serial walk of bits: a symbol's length is known only once it is decoded.
//      Its design (self-synchronising decoding, Weissenberger and Schmidt, ICPP 2018 and
//      HiPC 2021; modelled pass by pass in numpy by ops/jpeg_sync_model.py): each
//      restart segment's bits cut into subsequences of `sub_bits`; a decoder's state is
//      (bit, block of the MCU, zig-zag position). Five kernels: (1) subsequence 0 decodes
//      from the exact start, every other one from one guess for each block of the MCU;
//      (2) each subsequence takes its predecessor's most common guessed end and decodes
//      from it; (3) a block a segment finds the first start that differs from its
//      predecessor's end, gives it that end, and one thread decodes on until its state
//      equals the next recorded start, until no start differs; then the prefix sum of
//      the blocks each subsequence completed; (4) each subsequence decodes again, writing
//      AC coefficients and DC differences; (5) a block a segment sums the DC differences
//      over the MCUs. (1), (2) and (4) give each guess or subsequence a warp of its own
//      (lane 0 walks), 8 a block, spread over the card: 32 lanes walking 32 different
//      bit streams diverge at every symbol, and a pass then took several times a single
//      walk, on one SM or spread over many. A wrong
//      guess that keeps the right bit but the wrong block of the MCU can stay wrong for
//      thousands of bits (seen on the fixtures), so only exact states move forward
//      after round 2. Huffman tables in shared memory, libjpeg's 9-bit lookahead and
//      `maxcode` slow path; the bit buffer refills 32 bits at a time.
//   K2 + K3 (fused) move the coefficients in and the RGB out, once each: the coefficients
//      are read with 16-byte loads, the planes never leave shared memory, and the RGB rows
//      leave with 16-byte stores. An estimate of their integer operations (about 1,100 a
//      block for the IDCT and 30 a pixel for upsampling and colour) at the SM's peak
//      integer issue (the INT32 and FMA pipes, 128 lanes a clock) takes a little less time
//      than those bytes; at the INT32 pipe's 64 lanes alone, twice as long.
// Everything is integer; no float, so -fmad changes nothing here.

#include <climits>
#include <cstdint>

#include "jpeg_common.cuh"
#include "orientation.cuh"

namespace {

constexpr int kImgInts = 40;  // data/codec.py IMG_INTS
constexpr int kMaxUnits = 10;  // blocks in an MCU (libjpeg's D_MAX_BLOCKS_IN_MCU)
constexpr int kEntropyThreads = 256;  // K1's per-segment passes
constexpr int kWalksPerBlock = 8;     // K1's spread passes: a warp a walk (lane 0), 8 a block

// s extra bits, sign-extended as JPEG codes them (HUFF_EXTEND). At most 15 bits, and
// decode_symbol left at least 17 in the buffer.
__device__ int receive_extend(BitReader& br, int s) {
  if (s == 0) return 0;
  const int v = br.peek(s);
  br.skip(s);
  return extend(v, s);
}

// One scan's MCU in decode order, and its Huffman tables, in shared memory. A
// progressive DC first scan ends each block after its DC; an AC first one decodes the
// band Ss..Se of one component, with EOB runs.
struct Scan {
  int tab[2 * kMaxScanComps][kTableInts];
  int comp[kMaxUnits], by[kMaxUnits], bx[kMaxUnits];
  int units, ncomp, per_row;
  int h[kMaxScanComps], v[kMaxScanComps], fb[kMaxScanComps], bw[kMaxScanComps];
  int kstart, se, p1;  // a block's first zig-zag position, its last, 1 << Al
  bool dc_only, ac_first;

  // Coefficient block of the segment's b-th block in decode order.
  __device__ long long block(int first_mcu, int b) const {
    const int m = first_mcu + b / units;
    const int u = b - (b / units) * units;
    const int my = m / per_row, mx = m - my * per_row;
    const int k = comp[u];
    return fb[k] + static_cast<long long>(my * v[k] + by[u]) * bw[k] + mx * h[k] + bx[u];
  }
};

// A decoder's state: bit offset (-1: invalid), block of the MCU, zig-zag position.
struct State {
  int p, uk;  // uk = unit << 6 | k
};

struct Step {
  int dc;     // DC difference (valid when has_dc)
  int zpos;   // zig-zag position of an AC coefficient (0: none)
  int value;  // its value (scaled by 1 << Al)
  int blocks;  // blocks completed: 0, 1, or an AC first scan's EOB run
  bool has_dc, bad;  // bad: a code no table has (libjpeg warns)
};

// Decode one symbol from (u, k), as libjpeg does, corrupt data included.
__device__ void decode_step(BitReader& br, const Scan& sc, int& u, int& k, Step& out) {
  out.has_dc = false;
  out.zpos = out.blocks = 0;
  const int c = sc.comp[u];
  if (k == 0) {
    const int s = decode_symbol(br, sc.tab[2 * c]);
    out.bad = s == kBadCode;
    out.dc = receive_extend(br, s & 15);
    out.has_dc = true;
    k = sc.dc_only ? 64 : 1;
  } else {
    const int rs = decode_symbol(br, sc.tab[2 * c + 1]);
    out.bad = rs == kBadCode;
    const int r = (rs >> 4) & 15, sz = rs & 15;
    if (sz) {
      k += r;
      out.zpos = k;
      out.value = receive_extend(br, sz) * sc.p1;
      ++k;
    } else if (r == 15) {  // ZRL
      k += 16;
    } else {  // EOB; in an AC first scan an EOB run of 2^r + r more bits blocks, this one among them
      out.blocks = sc.ac_first ? (1 << r) + (r ? br.get(r) : 0) - 1 : 0;
      k = 64;
    }
  }
  if (k > sc.se) {
    u = u + 1 == sc.units ? 0 : u + 1;
    k = sc.kstart;
    ++out.blocks;
  }
}

// From `s`, decode until the next symbol starts at or past `end_bit`: that state;
// `count` gets the blocks completed. A `guess` (round 1) that meets a code no table has
// ends invalid (p -1): on clean data that marks a wrong guess, and the vote leaves it
// out; every other decode reads the code as libjpeg does, so an exact start stays exact
// through corrupt data (ops/jpeg_sync_model.py::decode_to_end).
__device__ State decode_to_end(const uint8_t* data, long long base, int nbits, const Scan& sc, State s,
                               long long end_bit, int& count, bool guess = false) {
  count = 0;
  if (s.p < 0) return s;
  BitReader br;
  br.start(data, base, nbits, s.p);
  int u = s.uk >> 6, k = s.uk & 63;
  Step st;
  while (br.used < end_bit) {
    decode_step(br, sc, u, k, st);
    if (guess && st.bad) return State{-1, 0};
    count += st.blocks;
  }
  return State{static_cast<int>(br.used), (u << 6) | k};
}

// Inclusive prefix sum over the block (blockDim.x a multiple of 32); `total` gets the
// block's sum. Every thread must call it.
__device__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_sums[w - 1];
  total = warp_sums[nw - 1];
  __syncthreads();
  return v;
}

// Scratch columns of a subsequence (ops/cuda_image.py::entropy_decode).
constexpr int kStartP = 0, kStartUK = 1, kEndP = 2, kEndUK = 3, kCount = 4, kFirst = 5;

// A restart segment of a sequential scan as K1's kernels see it.
struct Segment {
  long long base;  // first byte in `data`
  int nbits, first_mcu, mcus, n;  // n subsequences
  int* sub;    // 6 scratch ints a subsequence
  int* guess;  // 2 ints (end bit, unit << 6 | k) a guess, kMaxUnits guesses a subsequence
  const int* job;
  const int* seg;

  __device__ Segment(const int* segs, const int* jobs, int s, int sub_bits, int* scratch, int* cand) {
    const int* sg = segs + static_cast<long long>(s) * kSegInts;
    seg = sg;
    job = jobs + static_cast<long long>(sg[2]) * kJobInts;
    base = sg[0];
    nbits = sg[1];
    first_mcu = sg[3];
    mcus = sg[4];
    n = nbits > sub_bits ? (nbits + sub_bits - 1) / sub_bits : 1;
    sub = scratch + static_cast<long long>(sg[5]) * 6;
    guess = cand + static_cast<long long>(sg[5]) * 2 * kMaxUnits;
  }
  // K1 decodes the segments of the scans that first send their coefficients at its
  // step, but the first interval past a scan's data (the DC pass decodes that one)
  __device__ bool skip(int step) const {
    return job[kJobRoute] != 0 || job[kJobStep] != step || seg[kSegMissing] != 0 || mcus == 0;
  }
  __device__ int units() const {
    int u = 0;
    for (int k = 0; k < job[0]; ++k) u += job[4 + 6 * k] * job[5 + 6 * k];
    return u;
  }
  // round 1's decodes: subsequence 0 from the exact start, then one guess for each
  // block of the MCU of every subsequence but the first and the last
  __device__ int guesses() const { return n > 1 ? 1 + (n - 2) * units() : 0; }
};

// The scan's MCU layout into shared memory (thread 0), and with `with_tables` its
// Huffman tables (all threads); the caller synchronises.
__device__ void load_scan(Scan& sc, const int* job, const int* tables, bool with_tables) {
  if (threadIdx.x == 0) {
    sc.ncomp = job[0];
    sc.per_row = job[1];
    int units = 0;
    for (int k = 0; k < sc.ncomp; ++k) {
      const int* c = job + 2 + 6 * k;
      sc.h[k] = c[2];
      sc.v[k] = c[3];
      sc.fb[k] = c[4];
      sc.bw[k] = c[5];
      for (int y = 0; y < c[3]; ++y)
        for (int x = 0; x < c[2]; ++x) {
          sc.comp[units] = k;
          sc.by[units] = y;
          sc.bx[units] = x;
          ++units;
        }
    }
    sc.units = units;
    const bool progressive = job[kJobProgressive] != 0;
    sc.dc_only = progressive && job[kJobSs] == 0;
    sc.ac_first = progressive && job[kJobSs] > 0;
    sc.kstart = sc.ac_first ? job[kJobSs] : 0;
    sc.se = progressive ? job[kJobSe] : 63;
    sc.p1 = progressive ? 1 << job[kJobAl] : 1;
  }
  if (!with_tables) return;
  for (int i = threadIdx.x; i < 2 * job[0] * kTableInts; i += blockDim.x) {
    const int t = i / kTableInts;
    const int j = i - t * kTableInts;
    const int which = job[2 + 6 * (t >> 1) + (t & 1)];  // -1: a table the scan does not use
    if (which >= 0) sc.tab[t][j] = tables[static_cast<long long>(which) * kTableInts + j];
  }
}

// The most common valid end among subsequence i's guesses (the first guess's among
// equals; ops/jpeg_sync_model.py::vote); p -1 when every guess met a bad code.
__device__ State vote(const int* guess, int i, int units) {
  const int* g = guess + 2 * i * kMaxUnits;
  State best{-1, 0};
  int best_n = 0;
  for (int a = 0; a < units; ++a) {
    if (g[2 * a] < 0) continue;
    int same = 0;
    for (int c = 0; c < units; ++c) same += g[2 * c] == g[2 * a] && g[2 * c + 1] == g[2 * a + 1];
    if (same > best_n) {
      best_n = same;
      best = State{g[2 * a], g[2 * a + 1]};
    }
  }
  return best;
}

// Pass 1 (round 1), a warp a guess, a block 8 of a segment's guesses: blockIdx.x =
// segment * chunks + chunk, so a segment's guesses spread over the card.
__global__ void __launch_bounds__(32 * kWalksPerBlock)
    guess_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                 const int* __restrict__ jobs, const int* __restrict__ tables, int sub_bits, int chunks,
                 int step, int* scratch, int* cand) {
  __shared__ Scan sc;
  const Segment g(segs, jobs, blockIdx.x / chunks, sub_bits, scratch, cand);
  const int t = (blockIdx.x % chunks) * kWalksPerBlock + (threadIdx.x >> 5);
  if (g.skip(step) || (blockIdx.x % chunks) * kWalksPerBlock >= g.guesses()) return;  // the whole block
  load_scan(sc, g.job, tables, true);
  __syncthreads();
  if (t >= g.guesses() || (threadIdx.x & 31)) return;
  const int units = sc.units;
  const int i = t == 0 ? 0 : 1 + (t - 1) / units;
  const int u = t == 0 ? 0 : (t - 1) - (i - 1) * units;
  int count;
  const State e = decode_to_end(data, g.base, g.nbits, sc, State{i * sub_bits, (u << 6) | sc.kstart},
                                static_cast<long long>(i + 1) * sub_bits, count, t > 0);
  if (t == 0) {
    g.sub[kEndP] = e.p;
    g.sub[kEndUK] = e.uk;
    g.sub[kCount] = count;
  } else {
    g.guess[2 * (i * kMaxUnits + u)] = e.p;
    g.guess[2 * (i * kMaxUnits + u) + 1] = e.uk;
  }
}

// Pass 2 (round 2), a warp a subsequence, spread as pass 1: each subsequence takes its
// predecessor's voted end (subsequence 0's exact one) as its start and decodes from it.
__global__ void __launch_bounds__(32 * kWalksPerBlock)
    round2_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                  const int* __restrict__ jobs, const int* __restrict__ tables, int sub_bits, int chunks,
                  int step, int* scratch, int* cand) {
  __shared__ Scan sc;
  const Segment g(segs, jobs, blockIdx.x / chunks, sub_bits, scratch, cand);
  const int i = (blockIdx.x % chunks) * kWalksPerBlock + (threadIdx.x >> 5);
  if (g.skip(step) || (blockIdx.x % chunks) * kWalksPerBlock >= g.n) return;  // the whole block
  load_scan(sc, g.job, tables, true);
  __syncthreads();
  if (i >= g.n || (threadIdx.x & 31)) return;
  int* r = g.sub + 6 * i;
  const State start = i == 0 ? State{0, sc.kstart}
                             : (i == 1 ? State{g.sub[kEndP], g.sub[kEndUK]} : vote(g.guess, i - 1, sc.units));
  r[kStartP] = start.p;
  r[kStartUK] = start.uk;
  if (i == 0 || i == g.n - 1) return;  // subsequence 0 is decoded; the last one's end is nobody's start
  int count;
  const State e = decode_to_end(data, g.base, g.nbits, sc, start, static_cast<long long>(i + 1) * sub_bits, count);
  r[kEndP] = e.p;
  r[kEndUK] = e.uk;
  r[kCount] = count;
}

// Pass 3, a block a segment: later rounds (the first start that differs from its
// predecessor's end takes it, and one thread decodes on until its end equals the next
// recorded start), then each subsequence's first block, an exclusive prefix sum of the
// blocks completed. sync_out[2 s] gets the segment's rounds, sync_out[2 s + 1] the
// subsequences that one thread decoded one after another in the rounds after 2.
__global__ void __launch_bounds__(kEntropyThreads)
    repair_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                  const int* __restrict__ jobs, const int* __restrict__ tables, int sub_bits, int step,
                  int* scratch, int* cand, int* __restrict__ sync_out) {
  __shared__ Scan sc;
  __shared__ int warp_sums[32];
  __shared__ int brk, verified, carry;
  const Segment g(segs, jobs, blockIdx.x, sub_bits, scratch, cand);
  if (g.skip(step)) return;
  const int tid = threadIdx.x, n = g.n;
  int* sub = g.sub;
  load_scan(sc, g.job, tables, true);
  if (tid == 0) {
    verified = 1;
    carry = 0;
  }
  __syncthreads();
  int rounds = 2, walked = 0;
  while (true) {
    if (tid == 0) brk = INT_MAX;
    __syncthreads();
    for (int i = verified + tid; i < n; i += blockDim.x) {
      const int* a = sub + 6 * (i - 1);
      const int* b = sub + 6 * i;
      if (a[kEndP] != b[kStartP] || a[kEndUK] != b[kStartUK]) atomicMin(&brk, i);
    }
    __syncthreads();
    const int b = brk;
    if (b == INT_MAX) break;
    ++rounds;
    if (tid == 0) {
      int i = b;
      sub[6 * i + kStartP] = sub[6 * (i - 1) + kEndP];
      sub[6 * i + kStartUK] = sub[6 * (i - 1) + kEndUK];
      while (i < n - 1) {
        int* r = sub + 6 * i;
        int count;
        const State e = decode_to_end(data, g.base, g.nbits, sc, State{r[kStartP], r[kStartUK]},
                                      static_cast<long long>(i + 1) * sub_bits, count);
        r[kEndP] = e.p;
        r[kEndUK] = e.uk;
        r[kCount] = count;
        ++walked;
        if (e.p == r[6 + kStartP] && e.uk == r[6 + kStartUK]) break;
        ++i;
        r[6 + kStartP] = e.p;
        r[6 + kStartUK] = e.uk;
      }
      verified = i + 1;
    }
    __syncthreads();
  }
  for (int at = 0; at < n; at += blockDim.x) {
    const int i = at + tid;
    const int v = i < n - 1 ? sub[6 * i + kCount] : 0;
    int chunk;
    const int incl = block_scan(v, warp_sums, chunk);
    if (i < n) sub[6 * i + kFirst] = carry + incl - v;
    __syncthreads();
    if (tid == 0) carry += chunk;
    __syncthreads();
  }
  if (tid == 0) {
    sync_out[2 * blockIdx.x] = rounds;
    sync_out[2 * blockIdx.x + 1] = walked;
  }
}

// Pass 4, a warp a subsequence, spread as pass 1: decode again from the exact start,
// writing AC coefficients and DC differences, counting the codes no table has into
// `status`. Where a block completes past the segment's data (libjpeg's bit reader met
// the marker and fed zeros), its MCU is finished and the segment's MCUs after it are
// not decoded: `stops` gets that MCU of the scan. A walker that starts past the data at
// an MCU boundary decodes nothing.
__global__ void __launch_bounds__(32 * kWalksPerBlock)
    write_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs,
                 const int* __restrict__ jobs, const int* __restrict__ tables, int sub_bits, int chunks, int step,
                 int* scratch, int* cand, int* dcdiff, short* __restrict__ coef, int* stops, int* status) {
  __shared__ Scan sc;
  const int s = blockIdx.x / chunks;
  const Segment g(segs, jobs, s, sub_bits, scratch, cand);
  const int i = (blockIdx.x % chunks) * kWalksPerBlock + (threadIdx.x >> 5);
  if (g.skip(step) || (blockIdx.x % chunks) * kWalksPerBlock >= g.n) return;  // the whole block
  load_scan(sc, g.job, tables, true);
  __syncthreads();
  if (i >= g.n || (threadIdx.x & 31)) return;
  const int* r = g.sub + 6 * i;
  const int total = g.mcus * sc.units;
  int b = r[kFirst];
  if (b >= total || (r[kStartP] > g.nbits && r[kStartUK] == sc.kstart)) return;
  const long long end_bit = i < g.n - 1 ? static_cast<long long>(i + 1) * sub_bits : LLONG_MAX;
  BitReader br;
  br.start(data, g.base, g.nbits, r[kStartP]);
  int u = r[kStartUK] >> 6, k = r[kStartUK] & 63;
  long long blk = sc.block(g.first_mcu, b);
  bool stopping = false;
  int bad = 0;
  Step st;
  while (br.used < end_bit) {
    decode_step(br, sc, u, k, st);
    bad += st.bad;
    if (st.has_dc) dcdiff[blk] = st.dc;
    if (st.zpos) coef[blk * 64 + kZigzag[st.zpos]] = static_cast<short>(st.value);
    if (st.blocks) {
      if (!stopping && br.used > g.nbits) {
        stopping = true;
        atomicMin(stops + s, g.first_mcu + b / sc.units);
      }
      b += st.blocks;
      if ((stopping && u == 0) || b >= total) break;
      blk = sc.block(g.first_mcu, b);
    }
  }
  if (bad) atomicAdd(status + s, bad);
}

// The first interval past a scan's data (thread 0): libjpeg decodes its first MCU on
// zero bits where the interval before it did not run out, else nothing.
__device__ void missing_interval(const uint8_t* data, const Segment& g, const Scan& sc, int s, short* coef,
                                 int* stops, int* status) {
  stops[s] = g.first_mcu;
  if (stops[s - 1] != kNoStop) return;
  BitReader br;
  br.start(data, g.base, 0, 0);
  int u = 0, k = sc.kstart, bad = 0;
  int pred[kMaxScanComps] = {0, 0, 0, 0};
  Step st;
  for (int b = 0; b < sc.units;) {
    const long long blk = sc.block(g.first_mcu, b);
    const int c = sc.comp[u];
    decode_step(br, sc, u, k, st);
    bad += st.bad;
    if (st.has_dc) {
      pred[c] += st.dc;
      coef[blk * 64] = static_cast<short>(pred[c] * sc.p1);
    }
    if (st.zpos) coef[blk * 64 + kZigzag[st.zpos]] = static_cast<short>(st.value);
    b += st.blocks ? 1 : 0;
  }
  status[s] = bad + 1;
}

// Pass 5, a block a segment: per component, a prefix sum of the DC differences over the
// MCUs decoded (those up to the one in which the data ran out) gives the DC values
// (scaled by 1 << Al in a DC first scan; a sequential scan's later blocks get DC 0, an
// AC first scan has none); a segment whose data ran out counts one warning more. The
// first interval past a scan's data is decoded here.
__global__ void __launch_bounds__(kEntropyThreads)
    dc_kernel(const uint8_t* __restrict__ data, const int* __restrict__ segs, const int* __restrict__ jobs,
              const int* __restrict__ tables, int sub_bits, int step, int* scratch, int* cand, const int* dcdiff,
              short* __restrict__ coef, int* stops, int* __restrict__ status) {
  __shared__ Scan sc;
  __shared__ int warp_sums[32];
  __shared__ int carry[kMaxScanComps];
  const Segment g(segs, jobs, blockIdx.x, sub_bits, scratch, cand);
  const int tid = threadIdx.x;
  const bool missing = g.seg[kSegMissing] != 0;
  if (g.job[kJobRoute] != 0 || g.job[kJobStep] != step || g.mcus == 0) return;
  load_scan(sc, g.job, tables, missing);
  if (tid < kMaxScanComps) carry[tid] = 0;
  __syncthreads();
  if (missing) {
    if (tid == 0) missing_interval(data, g, sc, blockIdx.x, coef, stops, status);
    return;
  }
  const int stop = stops[blockIdx.x];
  const int decoded = stop == kNoStop ? g.mcus : stop - g.first_mcu + 1;
  if (!sc.ac_first) {
    for (int at = 0; at < g.mcus; at += blockDim.x) {
      const int m = at + tid;
      int sums[kMaxScanComps] = {0, 0, 0, 0};
      if (m < decoded)
        for (int u = 0; u < sc.units; ++u) sums[sc.comp[u]] += dcdiff[sc.block(g.first_mcu, m * sc.units + u)];
      int before[kMaxScanComps];
      for (int c = 0; c < sc.ncomp; ++c) {
        int chunk;
        before[c] = carry[c] + block_scan(sums[c], warp_sums, chunk) - sums[c];
        __syncthreads();
        if (tid == 0) carry[c] += chunk;
      }
      if (m < g.mcus && (m < decoded || !sc.dc_only))
        for (int u = 0; u < sc.units; ++u) {
          const long long blk = sc.block(g.first_mcu, m * sc.units + u);
          before[sc.comp[u]] += m < decoded ? dcdiff[blk] : 0;
          coef[blk * 64] = static_cast<short>(m < decoded ? before[sc.comp[u]] * sc.p1 : 0);
        }
      __syncthreads();
    }
  }
  if (tid == 0 && stop != kNoStop) status[blockIdx.x] += 1;
}

__device__ __forceinline__ int wrap16(int x) { return static_cast<short>(x); }

// One 1-D pass of jpeg_idct_islow as libjpeg-turbo's SIMD code (jidctint-avx2) computes
// it over z[0..7] (int16 values): in0 +- in4 and the odd part's in7 + in3 and in5 + in1
// are 16-bit sums, the rest 32-bit multiply-adds of 16-bit inputs, and each output is
// DESCALEd by `shift` and saturated to int16.
__device__ __forceinline__ void idct_1d(const int* z, int* out, int shift) {
  const int tmp3 = z[2] * (4433 + 6270) + z[6] * 4433;
  const int tmp2 = z[2] * 4433 + z[6] * (4433 - 15137);
  const int tmp0 = wrap16(z[0] + z[4]) * 8192;  // LEFT_SHIFT(., CONST_BITS)
  const int tmp1 = wrap16(z[0] - z[4]) * 8192;
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int z3 = wrap16(z[7] + z[3]), z4 = wrap16(z[5] + z[1]);
  const int z3n = z3 * (9633 - 16069) + z4 * 9633;
  const int z4n = z3 * 9633 + z4 * (9633 - 3196);
  const int t0 = z[7] * (2446 - 7373) - z[1] * 7373 + z3n;
  const int t3 = -z[7] * 7373 + z[1] * (12299 - 7373) + z4n;
  const int t1 = z[5] * (16819 - 20995) - z[3] * 20995 + z4n;
  const int t2 = -z[5] * 20995 + z[3] * (25172 - 20995) + z3n;
  const int r = 1 << (shift - 1);
  const int o[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = min(32767, max(-32768, (o[k] + r) >> shift));
}

// ---- K2 + K3 fused: a CTA a tile of MCUs of one image (data/codec.py::jpeg_batch's
// tile table: image, first row and column, rows and columns in decoded pixels, at most
// kTileH x kTileW). Each component's blocks under the tile, and the halo of blocks one
// sample around it that fancy upsampling reads, go through the islow IDCT into planes in
// shared memory (8 threads a block: a 16-byte row of coefficients each, then a column
// each in pass 1 and a row each in pass 2, through shared memory whose strides are padded
// off the banks' period, each sample row leaving as one 8-byte store); every pixel of the
// tile is then upsampled and converted from those planes (a warp a staged row, each
// component's parameters in registers; 4:2:0 YCbCr at orientation 1, the COCO case, a
// 2 x 2 quad a thread, each chroma quad from one 3 x 3 neighbourhood) and staged in
// shared memory in the output's orientation, so that a warp writes each output row of
// the tile with 16-byte stores. A halo block is decoded again by every tile that needs
// it. The choices and the times that decided them: PERF.md §6 (the fused kernel's designs A-F).
constexpr int kTileW = 128, kTileH = 32;  // data/codec.py JPEG_TILE_W, JPEG_TILE_H
constexpr int kTileInts = 5;             // data/codec.py TILE_INTS
constexpr int kPoolBlocks = 256;         // data/codec.py JPEG_POOL_BLOCKS: the blocks a tile holds
constexpr int kPad = 8;                  // bytes after each plane row: rows 8 apart start 2 banks apart
constexpr int kPoolBytes = kPoolBlocks * 64 + 4 * 6 * 8 * kPad;  // and the padding of 4 planes of <= 6 block rows
constexpr int kCoefRow = 72, kWsRow = 9;  // padded coefficient and workspace strides: the 4 groups of a warp
                                          // (and pass 2's 8 rows) on different banks
constexpr int kFusedThreads = 256;
constexpr int kGroups = kFusedThreads / 8;  // blocks decoded at once
constexpr int kMaxComps = 4;

struct FusedShared {
  uint8_t pool[kPoolBytes];  // the components' planes, each its block rectangle row-major, rows padded
  uint8_t rgb[kTileW * kTileH * 3];  // the tile's pixels in the output's orientation
  short coef[kGroups][kCoefRow];
  int ws[kGroups][8 * kWsRow];
  int qt[kMaxComps][64];
  int at[kMaxComps + 1];  // each component's first block in the tile's order; at[ncomp]: the tile's blocks
  int off[kMaxComps];     // each component's plane's first byte in the pool
  int bx0[kMaxComps], by0[kMaxComps], nbx[kMaxComps];
};

// Sample (y, x) of a full-size component (jdsample.c's upsamplers, as
// ops/plain_image.py::upsample), its plane in shared memory from sample (ly0, lx0) with
// rows of `ls` samples; c is the component's IMG_INTS fields.
struct Plane {  // one component's plane in shared memory and its upsampling
  const uint8_t* p;
  int ls, ly0, lx0, dw, dh, fh, fv, mode;
};

__device__ __forceinline__ int upsample(const Plane& pl, int y, int x) {
  const uint8_t* p = pl.p;
  const int ls = pl.ls, ly0 = pl.ly0, lx0 = pl.lx0, dw = pl.dw, dh = pl.dh, fh = pl.fh, fv = pl.fv, mode = pl.mode;
  auto at = [&](int i, int j) { return static_cast<int>(p[(i - ly0) * ls + (j - lx0)]); };
  if (mode == 0) return at(y, x);                  // UP_COPY
  if (mode == 4) return at(y / fv, x / fh);        // UP_BOX
  if (mode == 2) {                                 // UP_H1V2
    const int i = y >> 1;
    const bool odd = y & 1;
    const int j = odd ? min(i + 1, dh - 1) : max(i - 1, 0);
    return (3 * at(i, x) + at(j, x) + (odd ? 2 : 1)) >> 2;
  }
  const int j = x >> 1;
  const bool xodd = x & 1;
  const bool edge = xodd ? (j == dw - 1) : (j == 0);
  const int jj = xodd ? j + 1 : j - 1;
  if (mode == 1) {                                 // UP_H2V1
    const int near = at(y, j);
    if (edge) return near;
    return (3 * near + at(y, jj) + (xodd ? 2 : 1)) >> 2;
  }
  const int i = y >> 1;                            // UP_H2V2
  const bool yodd = y & 1;
  const int i1 = yodd ? min(i + 1, dh - 1) : max(i - 1, 0);
  const int here = 3 * at(i, j) + at(i1, j);
  if (edge) return (4 * here + (xodd ? 7 : 8)) >> 4;
  const int there = 3 * at(i, jj) + at(i1, jj);
  return (3 * here + there + (xodd ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// RGB of one pixel from its components' samples (jdcolor.c, cv2's CMYK), as
// ops/plain_image.py::color converts them.
__device__ void to_rgb(const int* s, int space, int ncomp, uint8_t* o) {
  int r, gr, b;
  if (space == 5) {  // SPACE_RAW: the components as they are (a JPEG-in-TIFF chunk)
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c)
      if (c < ncomp) o[c] = static_cast<uint8_t>(s[c]);
    return;
  }
  if (space == 0) {
    r = gr = b = s[0];
  } else if (space == 2) {
    r = s[0];
    gr = s[1];
    b = s[2];
  } else if (space == 3) {  // CMYK, as cv2's icvCvt_CMYK2BGR_8u_C4C3R converts it
    r = s[3] - (((255 - s[0]) * s[3]) >> 8);
    gr = s[3] - (((255 - s[1]) * s[3]) >> 8);
    b = s[3] - (((255 - s[2]) * s[3]) >> 8);
  } else {  // YCbCr, and YCCK's first three: jdcolor.c, SCALEBITS 16, ONE_HALF 1 << 15
    const int cb = s[1] - 128, cr = s[2] - 128;
    r = s[0] + ((91881 * cr + 32768) >> 16);
    gr = s[0] + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
    b = s[0] + ((116130 * cb + 32768) >> 16);
    if (space == 4) {  // ycck_cmyk_convert (C = 255 - R, ...), then cv2's CMYK: R = K - (R' K >> 8)
      r = s[3] - ((clamp255(r) * s[3]) >> 8);
      gr = s[3] - ((clamp255(gr) * s[3]) >> 8);
      b = s[3] - ((clamp255(b) * s[3]) >> 8);
    }
  }
  o[0] = clamp255(r);
  o[1] = clamp255(gr);
  o[2] = clamp255(b);
}

// The common case, 4:2:0 YCbCr at orientation 1 (Y copied, Cb and Cr by fancy h2v2), a
// 2 x 2 quad of pixels at a time: a quad's four chroma samples of a component come from
// one 3 x 3 neighbourhood (rows i - 1 .. i + 1, columns j - 1 .. j + 1, clamped as
// jdsample.c clamps them), read once for all four; the same arithmetic as upsample().
__device__ __forceinline__ void chroma_quad(const Plane& pl, int i, int j, int* q) {
  const int dh = pl.dh, dw = pl.dw;
  auto at = [&](int a, int b) { return static_cast<int>(pl.p[(a - pl.ly0) * pl.ls + (b - pl.lx0)]); };
  const int up = max(i - 1, 0), down = min(i + 1, dh - 1);
  int even[3], odd[3];  // column sums of the even output row (rows i, i - 1) and the odd one (i, i + 1)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int b = min(max(j - 1 + k, 0), dw - 1);
    const int mid = 3 * at(i, b);
    even[k] = mid + at(up, b);
    odd[k] = mid + at(down, b);
  }
  const bool left = j == 0, right = j == dw - 1;
  q[0] = left ? (4 * even[1] + 8) >> 4 : (3 * even[1] + even[0] + 8) >> 4;
  q[1] = right ? (4 * even[1] + 7) >> 4 : (3 * even[1] + even[2] + 7) >> 4;
  q[2] = left ? (4 * odd[1] + 8) >> 4 : (3 * odd[1] + odd[0] + 8) >> 4;
  q[3] = right ? (4 * odd[1] + 7) >> 4 : (3 * odd[1] + odd[2] + 7) >> 4;
}

__global__ void __launch_bounds__(kFusedThreads)
    idct_color_kernel(const short* __restrict__ coef, const int* __restrict__ qtables,
                      const int* __restrict__ images, const int* __restrict__ tiles, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  FusedShared& s = *reinterpret_cast<FusedShared*>(smem);
  const int* t = tiles + kTileInts * blockIdx.x;
  const int* im = images + kImgInts * t[0];
  const int y0 = t[1], x0 = t[2];
  const int h = im[3], w = im[4], orient = im[5], ncomp = im[6], space = im[7];
  const int th = min(t[3], h - y0), tw = min(t[4], w - x0);
  const int bpp = space == 5 ? ncomp : 3;  // bytes a pixel out (data/codec.py::pixel_bytes)
  const int tid = threadIdx.x;
  if (tid == 0) {  // each component's block rectangle under the tile, with the halo fancy upsampling reads
    // the RGB stage holds no more (JpegBatch.to refuses it)
    if (t[3] > kTileH || t[4] > kTileW || t[3] * t[4] * bpp > kTileH * kTileW * 3) __trap();
    int at = 0, bytes = 0;
    for (int c = 0; c < ncomp; ++c) {
      const int* cp = im + 8 + 8 * c;
      const int dw = cp[2], dh = cp[3], fh = cp[4], fv = cp[5], mode = cp[6];
      const int hh = mode == 1 || mode == 3, hv = mode == 2 || mode == 3;
      const int bx0 = max(0, x0 / fh - hh) >> 3, bx1 = min(dw - 1, (x0 + tw - 1) / fh + hh) >> 3;
      const int by0 = max(0, y0 / fv - hv) >> 3, by1 = min(dh - 1, (y0 + th - 1) / fv + hv) >> 3;
      s.at[c] = at;
      s.off[c] = bytes;
      s.bx0[c] = bx0;
      s.by0[c] = by0;
      s.nbx[c] = bx1 - bx0 + 1;
      at += (bx1 - bx0 + 1) * (by1 - by0 + 1);
      bytes += (by1 - by0 + 1) * 8 * ((bx1 - bx0 + 1) * 8 + kPad);
    }
    s.at[ncomp] = at;
    if (at > kPoolBlocks || bytes > kPoolBytes) __trap();  // nor does the pool (data/codec.py::jpeg_batch refuses it)
  }
  for (int i = tid; i < ncomp * 64; i += kFusedThreads) s.qt[i >> 6][i & 63] = qtables[64 * im[15 + 8 * (i >> 6)] + (i & 63)];
  __syncthreads();

  // IDCT: 8 threads a block, a warp's four groups on four consecutive blocks; every lane
  // of a warp takes each turn (and its __syncwarp), active or not
  const int group = tid >> 3, lane8 = tid & 7, total = s.at[ncomp];
  for (int first = (tid >> 5) * 4; first < total; first += kGroups) {
    const int b = first + (group & 3);
    const bool active = b < total;
    int c = 0, br = 0, bc = 0;
    if (active) {
      while (b >= s.at[c + 1]) ++c;
      const int local = b - s.at[c];
      br = local / s.nbx[c];
      bc = local - br * s.nbx[c];
      const int* cp = im + 8 + 8 * c;
      const long long gb = cp[0] / 64 + static_cast<long long>(s.by0[c] + br) * (cp[1] / 8) + s.bx0[c] + bc;
      reinterpret_cast<uint4*>(s.coef[group])[lane8] = __ldg(reinterpret_cast<const uint4*>(coef + gb * 64) + lane8);
    }
    __syncwarp();
    int z[8], o[8];
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        z[k] = wrap16(static_cast<int>(s.coef[group][8 * k + lane8]) * s.qt[c][8 * k + lane8]);
      idct_1d(z, o, 11);  // pass 1: column lane8
#pragma unroll
      for (int k = 0; k < 8; ++k) s.ws[group][kWsRow * k + lane8] = o[k];
    }
    __syncwarp();
    if (active) {
      idct_1d(s.ws[group] + kWsRow * lane8, o, 18);  // pass 2: row lane8
      const int ls = s.nbx[c] * 8 + kPad;
      unsigned int lo = 0, hi = 0;  // the row's 8 samples, one 8-byte store
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo |= static_cast<unsigned int>(min(127, max(-128, o[k])) + 128) << (8 * k);
        hi |= static_cast<unsigned int>(min(127, max(-128, o[k + 4])) + 128) << (8 * k);
      }
      *reinterpret_cast<uint2*>(s.pool + s.off[c] + (br * 8 + lane8) * ls + bc * 8) = make_uint2(lo, hi);
    }
    __syncwarp();  // before the groups' next blocks reuse coef and ws
  }
  __syncthreads();

  // upsample + colour, staged in the output's orientation: the tile's rows x cols there
  const bool turn = orient >= 5;
  const int rows = turn ? tw : th, cols = turn ? th : tw;
  int oy0, ox0;  // where the tile lands in the oriented image
  switch (orient) {
    case 2: oy0 = y0; ox0 = w - x0 - tw; break;
    case 3: oy0 = h - y0 - th; ox0 = w - x0 - tw; break;
    case 4: oy0 = h - y0 - th; ox0 = x0; break;
    case 5: oy0 = x0; ox0 = y0; break;
    case 6: oy0 = x0; ox0 = h - y0 - th; break;
    case 7: oy0 = w - x0 - tw; ox0 = h - y0 - th; break;
    case 8: oy0 = w - x0 - tw; ox0 = y0; break;
    default: oy0 = y0; ox0 = x0; break;
  }
  Plane planes[kMaxComps];  // each component's parameters, read once into registers
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c < ncomp) {
      const int* cp = im + 8 + 8 * c;
      planes[c] = {s.pool + s.off[c], s.nbx[c] * 8 + kPad, s.by0[c] * 8, s.bx0[c] * 8, cp[2], cp[3], cp[4], cp[5],
                   cp[6]};
    }
  }
  if (ncomp == 3 && space == 1 && orient == 1 && planes[0].mode == 0 && planes[1].mode == 3 &&
      planes[2].mode == 3) {  // 4:2:0 YCbCr: a quad of pixels a thread, a warp a row of quads
    for (int r2 = tid >> 5; 2 * r2 < rows; r2 += kFusedThreads / 32) {
      for (int q2 = tid & 31; 2 * q2 < cols; q2 += 32) {
        const int y = y0 + 2 * r2, x = x0 + 2 * q2;
        int cb[4], cr[4];
        chroma_quad(planes[1], y >> 1, x >> 1, cb);
        chroma_quad(planes[2], y >> 1, x >> 1, cr);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int dy = k >> 1, dx = k & 1;
          if (2 * r2 + dy < rows && 2 * q2 + dx < cols) {
            const int smp[3] = {static_cast<int>(planes[0].p[(y + dy - planes[0].ly0) * planes[0].ls + x + dx -
                                                             planes[0].lx0]), cb[k], cr[k]};
            to_rgb(smp, 1, 3, s.rgb + 3 * ((2 * r2 + dy) * cols + 2 * q2 + dx));
          }
        }
      }
    }
  } else {
  for (int r = tid >> 5; r < rows; r += kFusedThreads / 32) {  // a warp a staged row
    for (int q = tid & 31; q < cols; q += 32) {
      int y, x;
      orientation_source(orient, h, w, oy0 + r, ox0 + q, &y, &x);
      int smp[kMaxComps];
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) smp[c] = c < ncomp ? upsample(planes[c], y, x) : 0;
      to_rgb(smp, space, ncomp, s.rgb + bpp * (r * cols + q));
    }
  }
  }
  __syncthreads();

  // each output row of the tile by a warp: 16-byte stores where aligned, bytes at the ends
  const int warp = tid >> 5, lane = tid & 31;
  const int row_bytes = bpp * cols;
  for (int r = warp; r < rows; r += kFusedThreads / 32) {
    uint8_t* dst = out + im[0] + bpp * (static_cast<long long>(oy0 + r) * im[2] + ox0);
    const uint8_t* src = s.rgb + r * row_bytes;
    const int head = min(row_bytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
    const int body = (row_bytes - head) & ~15;
    for (int k = lane; k < head; k += 32) dst[k] = src[k];
    for (int k = head + 16 * lane; k < head + body; k += 16 * 32) {
      uint4 v;
      uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = src[k + j];
      *reinterpret_cast<uint4*>(dst + k) = v;
    }
    for (int k = head + body + lane; k < row_bytes; k += 32) dst[k] = src[k];
  }
}

}  // namespace

extern "C" {

// K1: five kernels in order on the stream, over the segments of the scans that first
// send their coefficients at `step`. coef, status and stops (an int a segment, NO_STOP
// where the data did not run out) as the earlier steps left them; scratch (6 ints a
// subsequence), cand (20 ints a subsequence) and dcdiff (an int a block) need no
// filling. max_guesses and max_subseqs: the most round-1 decodes and subsequences of one
// segment of the batch. sync (2 ints a segment): the rounds and the serially repaired
// subsequences of each segment (the others keep their values).
int ssd_jpeg_entropy(const uint8_t* data, long long nbytes, const int* segs, int nseg,
                     const int* jobs, const int* tables, int sub_bits, int max_guesses, int max_subseqs, int step,
                     int* scratch, int* cand, int* dcdiff, int* stops, short* coef, int* status,
                     int* sync, void* stream) {
  if (nbytes < 16 || nseg < 1 || sub_bits < 32 || max_subseqs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int guess_chunks = max_guesses > 0 ? (max_guesses + kWalksPerBlock - 1) / kWalksPerBlock : 1;
  const int sub_chunks = (max_subseqs + kWalksPerBlock - 1) / kWalksPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  guess_kernel<<<nseg * guess_chunks, 32 * kWalksPerBlock, 0, st>>>(data, segs, jobs, tables, sub_bits, guess_chunks,
                                                                     step, scratch, cand);
  round2_kernel<<<nseg * sub_chunks, 32 * kWalksPerBlock, 0, st>>>(data, segs, jobs, tables, sub_bits, sub_chunks,
                                                                   step, scratch, cand);
  repair_kernel<<<nseg, kEntropyThreads, 0, st>>>(data, segs, jobs, tables, sub_bits, step, scratch, cand, sync);
  write_kernel<<<nseg * sub_chunks, 32 * kWalksPerBlock, 0, st>>>(data, segs, jobs, tables, sub_bits, sub_chunks,
                                                                  step, scratch, cand, dcdiff, coef, stops, status);
  dc_kernel<<<nseg, kEntropyThreads, 0, st>>>(data, segs, jobs, tables, sub_bits, step, scratch, cand, dcdiff, coef,
                                              stops, status);
  return static_cast<int>(cudaGetLastError());
}

// K2 + K3 fused: a CTA a tile (tiles as data/codec.py::jpeg_batch, TILE_INTS rows);
// coefficients int16 (blocks, 64), qtables (C, 64), images IMG_INTS rows; `out` the
// batch's RGB (and raw components), each image at its byte offset.
int ssd_jpeg_idct_color(const short* coef, const int* qtables, const int* images, const int* tiles, int ntiles,
                        uint8_t* out, void* stream) {
  if (ntiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(FusedShared));
  cudaError_t err = cudaFuncSetAttribute(idct_color_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  idct_color_kernel<<<ntiles, kFusedThreads, bytes, static_cast<cudaStream_t>(stream)>>>(coef, qtables, images,
                                                                                      tiles, out);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

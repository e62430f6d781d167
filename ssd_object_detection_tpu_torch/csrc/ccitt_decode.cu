// CCITT (fax) and ThunderScan TIFF chunks on Hopper (sm_90a), K11: each chunk's coded
// bytes -> its decoded rows (packed 1-bit or 4-bit samples), launched by
// ops/cuda_image.py::ccitt_decode after the host has walked the TIFF and cut it into
// chunks (data/codec.py::parse_tiff, raw_batch). K8 (raw_image.cu) then reads the samples
// through the chunk table.
//
// Replaces no Pallas kernel: the JAX package reads TIFFs with cv2 on the host
// (ssd_object_detection_tpu/data/pipeline.py:70, eval/serve.py:379), whose libtiff 4.7
// decodes these codecs. Its plain version, which it is held to bit for bit, is
// ops/plain_image.py::ccitt_decode (fax_decode, thunder_decode), a step of libtiff's C at
// a time:
//   - tif_fax3.c / tif_fax3.h: Fax3DecodeRLE (compression 2, each row byte-aligned; 32771,
//     word-aligned by the address of the next byte), Fax3Decode1D and Fax3Decode2D
//     (compression 3, T4Options bit 0), Fax4Decode (compression 4), with libtiff's state
//     tables (plain_image.fax_tables, built from the T.4 code words as mkg3states builds
//     them): the LSB-first bit buffer over bit-reversed bytes, zero bits padded where the
//     data runs out, SYNC_EOL (and, where the data runs out after an EOL's zeros, the
//     retry from the chunk's first bit without EOLs, FAXMODE_NOEOL kept for the image),
//     EXPAND1D, EXPAND2D with its run-array checks, CLEANUP_RUNS and _TIFFFax3fillruns
//     (the cut runs written back, as the next row's reference reads them); the run arrays
//     live for the image, from chunk to chunk, as libtiff's do;
//   - tif_thunder.c: ThunderDecodeRow, a row at a time, the last pixel 0 at each row's
//     start, runs, 2- and 3-bit deltas with their skip codes, raw nibbles, a row of too
//     few or too many pixels zero from where it stopped and the chunk ended there.
// A decoding error fills the row as far as it got and ends the chunk; the rest stays zero
// (the wrapper zeroes the output), as cv2 reads it.
//
// What bounds it: the walk, a chain of dependent steps a code word (a table lookup, the
// reference line's runs), not bytes; PERF.md §6 has its time beside the byte bound and
// the reckoned chain. The design spreads the walks and takes everything else off them:
//   - A CTA a chunk, all of a call's chunks in one launch. Each CCITT chunk starts from the
//     state libtiff's Fax3PreDecode gives a chunk (a white reference line [lastx, 0], zero
//     run arrays, FAXMODE_NOEOL off) and records what that guess relied on: whether a
//     run-array entry it had not written itself decided anything (a high-water mark for
//     each of the two arrays: a row writes its array from the start, so what a chunk wrote
//     is a prefix of each; a value read past it taints the reference line's position b1
//     for the rest of the row, and b1's next use counts) and the FAXMODE_NOEOL it leaves. Its run arrays (prefixes) go to global scratch.
//     The image's last CTA to finish (an atomic counter) finds the first chunk whose guess
//     failed (it read state it did not write, or its predecessor leaves FAXMODE_NOEOL on);
//     from there it decodes the image's remaining chunks again in order, from the true
//     carried state (the saved prefixes laid over each other), their outputs zeroed first.
//     Chunks before it are final. ThunderScan chunks carry no state. The numpy replay of
//     this schedule is ops/fax_schedule_model.py.
//   - The walk and the fill split: lane 0 of warp 0 walks the codes into the run arrays in
//     shared memory; warps 1 and 2 turn the rows of even and odd line into bytes (their
//     runs' end positions by a warp scan, then a lane a 16-byte unit of the output: a
//     binary search for its first run, its bits set in registers, one 16-byte store where
//     the unit lies inside the row). Nothing reads the output, and no byte is ORed in
//     global memory. A row's slot (its run array) is free again when its fill is done;
//     the walker waits on that only two rows later. The cut of runs past the row's end
//     (which the next row reads) stays on the walker, and only where the runs do not sum
//     to the row's width.
//   - The coded bytes staged in shared memory by warp 3 with cp.async, in two halves (a
//     chunk larger than both streams through them), and read into a 64-bit window four
//     bytes at a time from a word loaded ahead, off the walk's chain; libtiff's byte
//     counters (what NeedBits would have loaded) run beside it for its end-of-data rules.
//   - The state tables in shared memory, copied once a CTA.
// Images whose run arrays and stage do not fit in shared memory (wider than about 5,000
// pixels) are walked chunk after chunk by the image's first CTA, its arrays in global
// scratch, nothing guessed.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// data/codec.py FAX_INTS, F_* (one stream, a chunk)
enum Stream { kSrc, kBytes, kMode, kRows, kWidth, kRowBytes, kOut, kOdd, kRuns, kFirst, kChunks, kFaxInts };
// data/codec.py FAX_RLE ... FAX_THUNDER
enum Mode { kRle, kRlew, kG3x1d, kG3x2d, kG4, kThunder };
// data/codec.py FAX_RECORD_INTS, R_* : one chunk's record (the image's counter and repair
// on its first chunk's)
enum Record { kFlags, kHigh0, kHigh1, kDone, kRepairFrom, kRecordInts };
constexpr int kForeign = 1, kNoEol = 2;  // kFlags bits
// tif_fax3.h's states (plain_image.FAX_*)
enum State { kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW, kMakeUpB, kMakeUp, kEol };
constexpr int kMainBits = 7, kWhiteBits = 12, kBlackBits = 13;
constexpr int kWhiteAt = 1 << kMainBits, kBlackAt = kWhiteAt + (1 << kWhiteBits);
constexpr int kThreads = 128;  // warp 0 walks (lane 0), warps 1 and 2 fill, warp 3 stages
constexpr int kTableInts = (1 << kMainBits) + (1 << kWhiteBits) + (1 << kBlackBits);  // plain_image.fax_tables()
constexpr int kSharedBytes = 227 * 1024 - 256;  // an H100 CTA's shared memory, less the kernel's static
constexpr int kTwoPerSm = 113 * 1024 - 256;     // two CTAs on an SM's 228 KB (each also holds 1 KB)
constexpr int kCtlInts = 32;
// a step's outcome: on, the data ran out (eoflab), the decoder gave up before filling the
// row (a run array overflow), SYNC_EOL's retry without EOLs, the expansion ended (eol2d)
enum Flow { kOn, kEof, kAbort, kRetry, kStop };

// The CTA's handshakes, in shared memory: rows published to and filled from each slot,
// each slot's row, the walk's end, the staged block the walker reads and each half's.
struct Ctl {
  int pub[2], fin[2], start[2], end[2], line[2];
  int over, want, ready[2], noeol;
};

// the kernel's dynamic shared memory: the tables, the handshakes (Ctl), the run arrays and
// rows, the stage (the handshakes reached through it are shared-memory loads and stores)
extern __shared__ __align__(16) int smem_ints[];

__device__ __forceinline__ int vload(const int* p) { return *reinterpret_cast<const volatile int*>(p); }
__device__ __forceinline__ void vstore(int* p, int v) { *reinterpret_cast<volatile int*>(p) = v; }

// A chunk's walk, as one CTA runs it
struct Env {
  const int* s;
  uint8_t* buffer;
  uint32_t* R;      // the run arrays: 2-D curruns then refruns (nruns each), 1-D a slot a row parity
  uint32_t* row[2]; // each fill warp's row of bytes (as words), 16-byte aligned
  uint8_t* stage;   // the coded bytes' two halves (null: read from global)
  int half_log;     // log2 of a half's bytes
  int size;         // codec.fax_scratch: the ints of libtiff's two run arrays
};

struct Fax {
  // libtiff's counters: bytes NeedBits has loaded (cp), bits in its buffer (avail)
  int n, cp, avail, eol;
  // the window: the stream's next `wbits` bits LSB first (zero past the data), the next
  // four bytes already loaded, the byte after them, the staged block being read
  uint64_t w;
  int wbits, q, block;
  uint32_t nxt;
  const uint8_t* raw;
  const uint8_t* stage;
  int half_log;
  Ctl* ctl;
  uint32_t* R;
  int size, nruns, lastx, lim, half_end, guard;  // guard: min(lim, half_end), put's one test
  const int* tab;
  // what this chunk wrote of each array (2-D: prefixes, marked at each row's end from the
  // row's highest write `top`); the reference array and its prefix at the row's start;
  // whether b1 holds a value read past it (taint), and whether such a value decided
  // anything (foreign)
  int hw0, hw1, top, ref, ref_hw;
  bool taint, foreign;
  unsigned long long sum;  // the row's runs (the cut is needed where they do not sum to lastx)
  int pub0, pub1;           // rows published to each slot (scalars: an indexed array would live in local memory)
  // the row
  int a0, rl, pa, pb, b1, thisrun, ref_end;
};

__device__ __forceinline__ int wrap(long long x) { return static_cast<int>(static_cast<uint32_t>(x)); }

// four stream bytes from byte q (a multiple of 4), each bit-reversed, the first lowest;
// zero past the data
__device__ __forceinline__ uint32_t load4(Fax& f, int q) {
  if (q >= f.n) return 0;
  uint32_t v;
  if (f.stage) {
    const int b = q >> f.half_log;
    if (b != f.block) {  // the next staged block: tell warp 3, wait for it
      f.block = b;
      vstore(&f.ctl->want, b);
      while (vload(&f.ctl->ready[b & 1]) != b) {
      }
      __threadfence_block();
    }
    v = *reinterpret_cast<const uint32_t*>(f.stage + ((b & 1) << f.half_log) + (q & ((1 << f.half_log) - 1)));
  } else if (q + 4 <= f.n) {
    v = *reinterpret_cast<const uint32_t*>(f.raw + q);
  } else {
    v = 0;
    for (int i = 0; i < f.n - q; ++i) v |= static_cast<uint32_t>(f.raw[q + i]) << (8 * i);
  }
  if (q + 4 > f.n) v &= (1u << (8 * (f.n - q))) - 1u;
  return __byte_perm(__brev(v), 0, 0x0123);
}

__device__ __forceinline__ void rewind(Fax& f) {
  f.cp = f.avail = f.eol = 0;
  f.w = 0;
  f.wbits = 0;
  f.nxt = load4(f, 0);
  f.q = 4;
}

__device__ __forceinline__ void refill(Fax& f) {
  if (f.wbits < 32) {
    f.w |= static_cast<uint64_t>(f.nxt) << f.wbits;
    f.wbits += 32;
    f.nxt = load4(f, f.q);  // its latency hides behind the lookups before the next refill
    f.q += 4;
  }
}

// NeedBits8 / NeedBits16 as libtiff counts them: false where the data has run out with no
// bit left (the bits themselves come from the window)
__device__ __forceinline__ bool need(Fax& f, int k, bool two) {
  refill(f);
  if (f.cp + 2 <= f.n) {  // the bytes it may load are there: whole bytes until k bits are in (k <= 16)
    const int d = max(0, (k - f.avail + 7) >> 3);
    f.cp += d;
    f.avail += d << 3;
    return true;
  }
  if (f.avail < k) {
    if (f.cp >= f.n) {
      if (f.avail == 0) return false;
      f.avail = k;
      return true;
    }
    ++f.cp;
    f.avail += 8;
    if (two && f.avail < k) {
      if (f.cp >= f.n) {
        f.avail = k;
      } else {
        ++f.cp;
        f.avail += 8;
      }
    }
  }
  return true;
}
__device__ __forceinline__ uint32_t get(const Fax& f, int k) {
  return static_cast<uint32_t>(f.w) & ((1u << k) - 1u);
}
__device__ __forceinline__ void clr(Fax& f, int k) {
  f.avail -= k;
  f.w >>= k;
  f.wbits -= k;
}
__device__ __forceinline__ bool lookup(Fax& f, int at, int bits, bool two, int& state, int& param) {
  if (!need(f, bits, two)) return false;
  const int e = f.tab[at + get(f, bits)];  // the tables in shared memory
  clr(f, (e >> 4) & 15);
  state = e & 15;
  param = e >> 8;
  return true;
}

// a run-array entry the walk reads into b1 through its reference line (pb): this chunk's
// own where it lies in the reference array below what the chunk had written of it when
// the row started, else b1 is tainted for the rest of the row (a read outside the
// reference array counts as not its own)
__device__ __forceinline__ uint32_t rd(Fax& f, int i) {
  f.taint |= static_cast<unsigned>(i - f.ref) >= static_cast<unsigned>(f.ref_hw);
  return f.R[i];
}
// b1's value decides something (a row's last code may read one entry past its
// reference line, which then decides nothing)
__device__ __forceinline__ void use_b1(Fax& f) { f.foreign |= f.taint; }

// slot p's rows all filled (its array may be written)
__device__ __forceinline__ void wait_filled(Fax& f, int p) {
  const int pub = p ? f.pub1 : f.pub0;
  while (vload(&f.ctl->fin[p]) != pub) {
  }
}

__device__ __forceinline__ void wr(Fax& f, int i, uint32_t v) {
  if (i >= f.half_end) {  // past curruns into refruns (a row of more runs than an array holds)
    wait_filled(f, 1);
    f.half_end = INT_MAX;
  }
  f.R[i] = v;
}

// the row's writes, R[thisrun, top) (a row writes its array from its start): the chunk's
// high-water marks of the two arrays
__device__ __forceinline__ void mark(Fax& f) {
  f.top = max(f.top, f.pa);
  if (f.thisrun < f.nruns) {
    f.hw0 = max(f.hw0, min(f.top, f.nruns));
    if (f.top > f.nruns) f.hw1 = max(f.hw1, f.top - f.nruns);
  } else {
    f.hw1 = max(f.hw1, f.top - f.nruns);
  }
}

__device__ __forceinline__ bool put(Fax& f, long long v) {
  if (f.pa >= f.guard) {
    if (f.pa >= f.lim) return false;  // past the run arrays (libtiff writes on; not pinned)
    f.guard = f.lim;                  // into refruns: wr waits for its fill
  }
  const uint32_t u = static_cast<uint32_t>(v);
  wr(f, f.pa++, u);
  f.sum += u;
  return true;
}
__device__ __forceinline__ bool setvalue(Fax& f, long long x) {
  if (!put(f, static_cast<long long>(f.rl) + x)) return false;
  f.a0 = wrap(f.a0 + x);
  f.rl = 0;
  return true;
}

// CLEANUP_RUNS
__device__ __forceinline__ bool cleanup(Fax& f) {
  if (f.rl && !setvalue(f, 0)) return false;
  if (f.a0 != f.lastx) {
    f.top = max(f.top, f.pa);
    while (f.a0 > f.lastx && f.pa > f.thisrun) {
      const uint32_t r = f.R[--f.pa];
      f.sum -= r;
      f.a0 = wrap(static_cast<long long>(f.a0) - r);
    }
    if (f.a0 < f.lastx) {
      if (f.a0 < 0) f.a0 = 0;
      if (((f.pa - f.thisrun) & 1) && !setvalue(f, 0)) return false;
      if (!setvalue(f, f.lastx - f.a0)) return false;
    } else if (f.a0 > f.lastx) {
      if (!setvalue(f, f.lastx) || !setvalue(f, 0)) return false;
    }
  }
  return true;
}

// A white or black run's codes: kOn at its terminating code, kStop at an EOL (*eol set)
// or no code, kEof, kAbort.
__device__ __forceinline__ Flow run_colour(Fax& f, bool black, bool* eol) {
  const int at = black ? kBlackAt : kWhiteAt, bits = black ? kBlackBits : kWhiteBits;
  const int term = black ? kTermB : kTermW;
  while (true) {
    int state, param;
    if (!lookup(f, at, bits, true, state, param)) return kEof;
    if (state == term) return setvalue(f, param) ? kOn : kAbort;
    if (state == kMakeUpW || state == kMakeUpB || state == kMakeUp) {
      f.a0 = wrap(static_cast<long long>(f.a0) + param);
      f.rl = wrap(static_cast<long long>(f.rl) + param);
      continue;
    }
    *eol = state == kEol;
    return kStop;
  }
}

// EXPAND1D, CLEANUP_RUNS at its end (done1d) or where the data ran out (kEof)
// (one run_colour a run, white and black in turn: one copy of the code)
__device__ __forceinline__ Flow expand1d(Fax& f) {
  Flow r = kOn;
  bool black = false;
  while (true) {
    bool eol = false;
    r = run_colour(f, black, &eol);
    if (r != kOn) {
      if (eol) f.eol = 1;
      break;
    }
    if (f.a0 >= f.lastx) break;
    if (black && f.R[f.pa - 1] == 0 && f.R[f.pa - 2] == 0) {
      f.top = max(f.top, f.pa);
      f.pa -= 2;
    }
    black = !black;
  }
  if (r == kAbort) return kAbort;
  if (!cleanup(f)) return kAbort;
  return r == kEof ? kEof : kOn;
}

__device__ __forceinline__ bool check_b1(Fax& f) {
  use_b1(f);
  if (f.pa != f.thisrun) {
    while (f.b1 <= f.a0 && f.b1 < f.lastx) {
      if (f.pb + 1 >= f.ref_end) return false;
      f.b1 = wrap(static_cast<long long>(f.b1) + static_cast<uint32_t>(rd(f, f.pb) + rd(f, f.pb + 1)));
      f.pb += 2;
      use_b1(f);
    }
  }
  return true;
}

// EXPAND2D, CLEANUP_RUNS at its end (eol2d) or where the data ran out (kEof)
__device__ __forceinline__ Flow expand2d(Fax& f) {
  Flow r = kOn;
  bool ended = false;  // left the loop by eol2d (a break), not by a0 reaching the row's end
  while (f.a0 < f.lastx) {
    if (f.pa >= f.thisrun + f.nruns) return kAbort;
    int state, param;
    if (!lookup(f, 0, kMainBits, false, state, param)) {
      r = kEof;
      break;
    }
    if (state == kV0 || state == kVR) {
      if (!check_b1(f)) return kAbort;
      if (!setvalue(f, static_cast<long long>(f.b1) - f.a0 + (state == kVR ? param : 0))) return kAbort;
      if (f.pb >= f.ref_end) return kAbort;
      f.b1 = wrap(static_cast<long long>(f.b1) + rd(f, f.pb++));
    } else if (state == kVL) {
      if (!check_b1(f)) return kAbort;
      if (f.b1 < static_cast<long long>(f.a0) + param) {  // unexpected: eol2d
        ended = true;
        break;
      }
      if (!setvalue(f, static_cast<long long>(f.b1) - f.a0 - param)) return kAbort;
      if (f.pb <= 0) return kAbort;  // before the run arrays (not pinned)
      f.b1 = wrap(static_cast<long long>(f.b1) - rd(f, --f.pb));
    } else if (state == kHoriz) {
      bool eol = false;
      const bool black_first = (f.pa - f.thisrun) & 1;
#pragma unroll 1
      for (int h = 0; h < 2 && r == kOn; ++h) r = run_colour(f, black_first != (h == 1), &eol);
      if (r == kEof || r == kAbort) break;
      if (r == kStop) {  // badBlack2d / badWhite2d: eol2d
        r = kOn;
        ended = true;
        break;
      }
      if (!check_b1(f)) return kAbort;
    } else if (state == kPass) {
      if (!check_b1(f) || f.pb + 1 >= f.ref_end) return kAbort;
      f.b1 = wrap(static_cast<long long>(f.b1) + rd(f, f.pb++));
      use_b1(f);
      f.rl = wrap(static_cast<long long>(f.rl) + f.b1 - f.a0);
      f.a0 = f.b1;
      f.b1 = wrap(static_cast<long long>(f.b1) + rd(f, f.pb++));
    } else if (state == kExt) {
      if (!put(f, static_cast<long long>(f.lastx) - f.a0)) return kAbort;
      ended = true;
      break;
    } else if (state == kEol) {
      if (!put(f, static_cast<long long>(f.lastx) - f.a0)) return kAbort;
      if (!need(f, 4, false)) {
        r = kEof;
        break;
      }
      clr(f, 4);
      f.eol = 1;
      ended = true;
      break;
    } else {  // badMain2d
      ended = true;
      break;
    }
  }
  if (r == kAbort) return kAbort;
  if (r == kOn && !ended && f.rl) {
    if (static_cast<long long>(f.rl) + f.a0 < f.lastx) {  // expect a final V0
      if (!need(f, 1, false)) {
        r = kEof;
      } else if (get(f, 1)) {
        clr(f, 1);
        if (!setvalue(f, 0)) return kAbort;
      }
    } else if (!setvalue(f, 0)) {
      return kAbort;
    }
  }
  if (!cleanup(f)) return kAbort;
  return r == kEof ? kEof : kOn;
}

// _TIFFFax3fillruns' run array side (an odd count gets a zero run; every run cut at lastx
// and written back cut, where the runs do not sum to lastx), then the row handed to its
// fill warp
__device__ __forceinline__ void publish(Fax& f, int line, int end) {
  if ((end - f.thisrun) & 1) wr(f, end++, 0);
  f.top = max(f.top, end);
  if (f.sum != static_cast<unsigned long long>(f.lastx)) {
    const uint32_t lastx = static_cast<uint32_t>(f.lastx);
    uint32_t x = 0;
    for (int k = f.thisrun; k < end; ++k) {
      uint32_t run = f.R[k];
      if (x + run > lastx || run > lastx) f.R[k] = run = lastx - x;
      x += run;
    }
  }
  const int p = line & 1;
  Ctl* c = f.ctl;
  c->start[p] = f.thisrun;
  c->end[p] = end;
  c->line[p] = line;
  __threadfence_block();
  vstore(&c->pub[p], p ? ++f.pub1 : ++f.pub0);
}

// One CCITT chunk (plain_image.fax_decode) on the walking thread: returns the image's
// Group 3 mode after it; rows go to the fill warps
__device__ __noinline__ bool fax_walk(const Env& e, bool noeol, int* hw, bool* foreign) {
  const int* s = e.s;
  const int mode = s[kMode], rows = s[kRows], odd = s[kOdd];
  const bool two_d = mode == kG3x2d || mode == kG4;
  Fax f;
  f.raw = e.buffer + s[kSrc];
  f.n = s[kBytes];
  f.stage = e.stage;
  f.half_log = e.half_log;
  f.ctl = reinterpret_cast<Ctl*>(smem_ints + kTableInts);
  f.block = -1;
  f.R = e.R;
  f.size = e.size;
  f.nruns = two_d ? (f.size - 8) / 2 : f.size;  // 1-D: the second slot starts at size
  f.lastx = s[kWidth];
  f.tab = smem_ints;
  f.hw0 = 0;
  f.hw1 = 0;
  f.foreign = false;
  f.pub0 = f.pub1 = 0;
  rewind(f);
  int cur = 0, ref = f.nruns;
  if (two_d) {
    wr(f, ref, static_cast<uint32_t>(f.lastx));
    wr(f, ref + 1, 0);
    f.hw1 = 2;
  }
  for (int line = 0; line < rows;) {
    if (!two_d) cur = (line & 1) * f.size;
    wait_filled(f, line & 1);  // this slot's row two lines up is filled
    f.thisrun = f.pa = f.top = cur;
    f.a0 = f.rl = 0;
    f.sum = 0;
    f.taint = false;
    f.ref = ref;
    f.ref_hw = ref ? f.hw1 : f.hw0;
    f.ref_end = ref + f.nruns;
    f.lim = two_d ? f.size - 1 : cur + f.size - 1;
    f.half_end = two_d && cur == 0 ? f.nruns : INT_MAX;
    f.guard = min(f.lim, f.half_end);
    Flow r = kOn;
    bool is1d = mode != kG4;  // one call of each expansion below: one copy of its code
    if (mode == kG3x1d || mode == kG3x2d) {
      if (!noeol) {  // SYNC_EOL
        if (f.eol == 0) {
          while (true) {
            if (!need(f, 11, true)) {
              r = kEof;
              break;
            }
            if (get(f, 11) == 0) break;
            clr(f, 1);
          }
        }
        while (r == kOn) {
          if (!need(f, 8, false)) {  // noEOLFound: again from the chunk's start, without EOLs
            noeol = true;
            rewind(f);
            r = kRetry;
            break;
          }
          if (get(f, 8)) break;
          clr(f, 8);
        }
        if (r == kOn) {
          while (get(f, 1) == 0) clr(f, 1);
          clr(f, 1);
          f.eol = 0;
        }
      }
      if (r == kRetry) continue;
      if (r == kOn && mode == kG3x2d) {
        if (!need(f, 1, false)) {
          r = kEof;
        } else {
          is1d = get(f, 1) != 0;
          clr(f, 1);
        }
      }
    }
    if (r == kEof) {
      if (!cleanup(f)) {
        mark(f);
        break;
      }
    } else {
      if (mode == kG3x2d || mode == kG4) {
        f.pb = ref + 1;
        f.b1 = static_cast<int>(rd(f, ref));
      }
      r = is1d ? expand1d(f) : expand2d(f);
      if (mode == kG4 && r == kOn && f.eol) r = kEof;
    }
    if (r == kAbort) {
      mark(f);
      break;
    }
    if (r == kEof) {
      if (mode == kG4) {  // EOFG4: EOFB's 13 bits (or what is left), then the row
        need(f, 13, true);
        clr(f, 13);
      }
      publish(f, line, f.pa);
      mark(f);
      break;
    }
    publish(f, line, f.pa);
    if (mode == kRle) {
      clr(f, f.avail - (f.avail & ~7));
    } else if (mode == kRlew) {
      clr(f, f.avail - (f.avail & ~15));
      if (f.avail == 0 && ((f.cp + odd) & 1)) {  // libtiff skips the byte it has not loaded
        ++f.cp;
        refill(f);
        f.w >>= 8;
        f.wbits -= 8;
      }
    } else if (two_d) {
      const bool ok = !(mode == kG4 || f.pa < f.thisrun + f.nruns) || setvalue(f, 0);
      mark(f);
      if (!ok) break;
      const int t = cur;
      cur = ref;
      ref = t;
    }
    ++line;
  }
  hw[0] = f.hw0;
  hw[1] = f.hw1;
  *foreign = f.foreign;
  return noeol;
}

// A fill warp: row after row of its slot (even or odd lines) into bytes, until the walk
// ends: the row's runs 32 at a time, their end pixels by a warp scan, each black run's
// bits ORed into the warp's row in shared memory a 32-bit word at a time, then the row
// stored a lane a 16-byte unit of the output (the units of the buffer's 16-byte grid; a
// partial one at either end byte by byte)
__device__ void fill_rows(const Env& e, int p, int lane) {
  const int* s = e.s;
  uint8_t* out = e.buffer + s[kOut];
  const int row_bytes = s[kRowBytes], words = (row_bytes + 3) >> 2;
  uint32_t* word = e.row[p];
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(word);
  Ctl* c = reinterpret_cast<Ctl*>(smem_ints + kTableInts);  // always in shared memory
  int seen = 0;
  while (true) {
    int pub, over;  // lane 0 reads them for the warp: its lanes take the same branch
    do {
      if (lane == 0) {
        over = vload(&c->over);
        __threadfence_block();
        pub = vload(&c->pub[p]);
      }
      pub = __shfl_sync(0xffffffffu, pub, 0);
      over = __shfl_sync(0xffffffffu, over, 0);
      if (pub == seen && !over) __nanosleep(64);
    } while (pub == seen && !over);
    if (pub == seen) break;  // the walk is over (its last row was published before it said so)
    __threadfence_block();
    const int start = vload(&c->start[p]), end = vload(&c->end[p]), line = vload(&c->line[p]);
    const uint32_t* R = e.R;
    for (int j = lane; j < words; j += 32) word[j] = 0;
    __syncwarp();
    uint32_t carry = 0;
    for (int b = start; b < end; b += 32) {
      const int k = b + lane;
      const uint32_t run = k < end ? R[k] : 0u;
      uint32_t v = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += t;
      }
      const uint32_t x1 = v + carry, x0 = x1 - run;
      carry = __shfl_sync(0xffffffffu, x1, 31);
      if (k < end && ((k - start) & 1) && run) {  // a black run: its pixels' bits, MSB first in each byte
        for (uint32_t j = x0 >> 5; j <= (x1 - 1) >> 5; ++j) {
          const uint32_t l0 = max(x0, j << 5) - (j << 5), l1 = min(x1, (j << 5) + 32) - (j << 5);
          const uint32_t m = (0xffffffffu >> l0) & (l1 >= 32 ? 0xffffffffu : ~(0xffffffffu >> l1));
          atomicOr(word + j, __byte_perm(m, 0, 0x0123));  // pixel order to memory order
        }
      }
    }
    __syncwarp();
    uint8_t* row = out + static_cast<long long>(line) * row_bytes;
    const uintptr_t a = reinterpret_cast<uintptr_t>(row), g = a & ~static_cast<uintptr_t>(15);
    const int units = static_cast<int>((a + row_bytes - g + 15) >> 4);
    for (int u = lane; u < units; u += 32) {
      const long long b0 = static_cast<long long>(g + 16 * static_cast<uintptr_t>(u)) - static_cast<long long>(a);
      const int lo = static_cast<int>(max(b0, 0LL)), hi = static_cast<int>(min(static_cast<long long>(row_bytes), b0 + 16));
      if (lo == b0 && hi == b0 + 16) {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint8_t* x = bytes + b0 + 4 * q;
          w[q] = x[0] | static_cast<uint32_t>(x[1]) << 8 | static_cast<uint32_t>(x[2]) << 16 |
                 static_cast<uint32_t>(x[3]) << 24;
        }
        *reinterpret_cast<uint4*>(row + b0) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int b = lo; b < hi; ++b) row[b] = bytes[b];
      }
    }
    __syncwarp();
    __threadfence_block();
    ++seen;
    if (lane == 0) vstore(&c->fin[p], seen);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Warp 3: keeps the halves holding the block the walker reads and the one after it
__device__ void stage_blocks(const Env& e, int lane) {
  const uint8_t* src = e.buffer + e.s[kSrc];
  const int n = e.s[kBytes], half = 1 << e.half_log;
  Ctl* c = reinterpret_cast<Ctl*>(smem_ints + kTableInts);  // always in shared memory
  while (true) {
    int over, want, ready0, ready1;  // lane 0 reads them for the warp: its lanes take the same branch
    if (lane == 0) {
      over = vload(&c->over);
      want = vload(&c->want);
      ready0 = vload(&c->ready[0]);
      ready1 = vload(&c->ready[1]);
    }
    over = __shfl_sync(0xffffffffu, over, 0);
    want = __shfl_sync(0xffffffffu, want, 0);
    ready0 = __shfl_sync(0xffffffffu, ready0, 0);
    ready1 = __shfl_sync(0xffffffffu, ready1, 0);
    if (over) break;
    bool copied = false;
    for (int t = want; t <= want + 1; ++t) {
      if (static_cast<long long>(t) * half >= n || (t & 1 ? ready1 : ready0) == t) continue;
      const int len = min(half, n - t * half);
      uint8_t* dst = e.stage + ((t & 1) << e.half_log);
      for (int i = 16 * lane; i < len; i += 16 * 32) cp_async16(dst + i, src + static_cast<long long>(t) * half + i);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      __threadfence_block();
      if (lane == 0) vstore(&c->ready[t & 1], t);
      if (t & 1) ready1 = t; else ready0 = t;
      __syncwarp();
      copied = true;
    }
    if (!copied) __nanosleep(128);
  }
}

// One chunk by the whole CTA: the walk on lane 0 of warp 0, the fills on warps 1 and 2, the
// stage on warp 3. `hw` out: the arrays' high-water marks. Returns the Group 3 mode after
// the chunk.
__device__ __noinline__ bool run_chunk(const Env& e, bool noeol, int* hw, bool* foreign) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Ctl* c = reinterpret_cast<Ctl*>(smem_ints + kTableInts);  // always in shared memory
  if (threadIdx.x == 0) {
    c->pub[0] = c->pub[1] = c->fin[0] = c->fin[1] = 0;
    c->over = 0;
    c->want = 0;
    c->ready[0] = c->ready[1] = -1;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      c->noeol = fax_walk(e, noeol, hw, foreign);
      __threadfence_block();
      vstore(&c->over, 1);
    }
  } else if (warp <= 2) {
    fill_rows(e, warp - 1, lane);
  } else if (e.stage) {
    stage_blocks(e, lane);
  }
  __syncthreads();
  return c->noeol != 0;
}

// One ThunderScan chunk (plain_image.thunder_decode)
__device__ __forceinline__ void thunder_chunk(const int* s, uint8_t* buffer) {
  const uint8_t* raw = buffer + s[kSrc];
  const int n = s[kBytes], rows = s[kRows], width = s[kWidth], row_bytes = s[kRowBytes];
  uint8_t* out = buffer + s[kOut];
  int cp = 0;
  for (int line = 0; line < rows; ++line) {
    uint8_t* row = out + static_cast<long long>(line) * row_bytes;
    int op = 0, npixels = 0;
    unsigned last = 0;
    auto setpixel = [&](unsigned v) {
      last = v & 0xF;
      if (npixels < width) {
        if (npixels++ & 1) {
          row[op++] |= static_cast<uint8_t>(last);
        } else {
          row[op] = static_cast<uint8_t>(last << 4);
        }
      }
    };
    while (cp < n && npixels < width) {
      const int b = raw[cp++];
      switch (b & 0xC0) {
        case 0x00: {  // a run of the last pixel
          int k = b & 0x3F;
          if (npixels & 1) {
            row[op] |= static_cast<uint8_t>(last);
            last = row[op++];
            ++npixels;
            --k;
          } else {
            last |= last << 4;
          }
          npixels += k;
          if (npixels <= width) {
            for (; k > 0; k -= 2) row[op++] = static_cast<uint8_t>(last);
          }
          if (k == -1) row[--op] &= 0xF0;
          last &= 0xF;
          break;
        }
        case 0x40:
          for (int sh = 4; sh >= 0; sh -= 2) {
            const int d = (b >> sh) & 3;
            if (d != 2) setpixel(static_cast<unsigned>(static_cast<int>(last) + (d == 1 ? 1 : d == 3 ? -1 : 0)));
          }
          break;
        case 0x80:
          for (int sh = 3; sh >= 0; sh -= 3) {
            const int d = (b >> sh) & 7;
            if (d != 4) setpixel(static_cast<unsigned>(static_cast<int>(last) + (d < 4 ? d : d - 8)));
          }
          break;
        default:
          setpixel(static_cast<unsigned>(b));
      }
    }
    if (npixels != width) {  // too few or too many: zero from here, and the chunk ends
      for (int i = op; i < (width + 1) / 2; ++i) row[i] = 0;
      return;
    }
  }
}

__device__ __forceinline__ int fax_size(const int* s) {  // data/codec.py fax_scratch
  const int n32 = ((s[kWidth] + 1 + 31) / 32) * 32;
  return 2 * (s[kMode] == kG3x2d || s[kMode] == kG4 ? 2 * n32 : n32) + 8;
}
__device__ __forceinline__ int fax_span(const int* s) {  // data/codec.py fax_span
  return s[kMode] == kG3x2d || s[kMode] == kG4 ? fax_size(s) : 2 * fax_size(s);
}
__device__ __forceinline__ int fax_row_ints(const int* s) {  // data/codec.py fax_row_ints
  return (((s[kRowBytes] + 15) / 16) * 16 + 16) / 4;
}

// the chunk's output zeroed (before it is decoded again)
__device__ void zero_output(const int* s, uint8_t* buffer) {
  uint8_t* out = buffer + s[kOut];
  const long long bytes = static_cast<long long>(s[kRows]) * s[kRowBytes];
  for (long long i = threadIdx.x; i < bytes; i += kThreads) out[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
    ccitt_kernel(uint8_t* __restrict__ buffer, int fax_at, const int* __restrict__ tab, uint32_t* __restrict__ runs,
                 int* __restrict__ records, int area, int half_log) {
  int* smem = smem_ints;
  const int k = blockIdx.x;
  const int* streams = reinterpret_cast<const int*>(buffer) + fax_at;
  const int* s = streams + k * kFaxInts;
  if (s[kMode] == kThunder) {
    if (threadIdx.x == 0) thunder_chunk(s, buffer);
    return;
  }
  const int first = s[kFirst], chunks = s[kChunks];
  const bool serial = half_log == 0;  // the run arrays do not fit in shared memory: the first CTA walks them all
  if (serial && k != first) return;
  for (int i = threadIdx.x; i < kTableInts; i += kThreads) smem[i] = __ldg(tab + i);
  const int size = fax_size(s), span = fax_span(s);
  Env e;
  e.s = s;
  e.buffer = buffer;
  uint32_t* work = serial ? runs + s[kRuns] : reinterpret_cast<uint32_t*>(smem + kTableInts + kCtlInts);
  e.R = work;
  e.row[0] = work + span;
  e.row[1] = work + span + fax_row_ints(s);
  e.stage = serial ? nullptr : reinterpret_cast<uint8_t*>(smem + kTableInts + kCtlInts + area);
  e.half_log = half_log;
  e.size = size;
  for (int i = threadIdx.x; i < span; i += kThreads) work[i] = 0;  // libtiff zeroes them at setup
  __shared__ int hw[2];
  __shared__ bool foreign;
  __shared__ int kf;
  if (serial) {  // every chunk in turn from the carried state
    bool noeol = false;
    for (int j = first; j < first + chunks; ++j) {
      e.s = streams + j * kFaxInts;
      noeol = run_chunk(e, noeol, hw, &foreign);
    }
    return;
  }
  const bool noeol = run_chunk(e, false, hw, &foreign);  // the guess: the state Fax3PreDecode gives a chunk
  // the arrays' prefixes this chunk wrote, for a repair that starts after it
  uint32_t* save = runs + s[kRuns];
  const int nruns = (size - 8) / 2;
  const bool two_d = s[kMode] == kG3x2d || s[kMode] == kG4;  // 1-D rows read no other row's runs
  for (int i = threadIdx.x; two_d && i < hw[0]; i += kThreads) save[i] = work[i];
  for (int i = threadIdx.x; two_d && i < hw[1]; i += kThreads) save[nruns + i] = work[nruns + i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* rec = records + k * kRecordInts;
    rec[kFlags] = (foreign ? kForeign : 0) | (noeol ? kNoEol : 0);
    rec[kHigh0] = hw[0];
    rec[kHigh1] = hw[1];
    __threadfence();
    const bool last = atomicAdd(records + first * kRecordInts + kDone, 1) == chunks - 1;
    kf = -1;
    if (last) {  // the image's last CTA: its first chunk whose guess failed
      __threadfence();
      for (int j = first + 1; j < first + chunks && kf < 0; ++j) {
        if ((__ldcg(records + j * kRecordInts + kFlags) & kForeign) ||
            (__ldcg(records + (j - 1) * kRecordInts + kFlags) & kNoEol))
          kf = j;
      }
      if (kf >= 0) records[first * kRecordInts + kRepairFrom] = kf - first + 1;
    }
  }
  __syncthreads();
  if (kf < 0) return;
  // the true state before chunk kf: the saved prefixes laid over each other in order
  for (int i = threadIdx.x; i < span; i += kThreads) {
    uint32_t v = 0;
    if (two_d) {
      const bool h = i >= nruns;
      const int off = h ? i - nruns : i;
      for (int j = kf - 1; j >= first; --j) {
        if (off < __ldcg(records + j * kRecordInts + (h ? kHigh1 : kHigh0))) {
          v = __ldcg(reinterpret_cast<const int*>(runs) + streams[j * kFaxInts + kRuns] + i);
          break;
        }
      }
    }
    work[i] = v;
  }
  bool carried = (__ldcg(records + (kf - 1) * kRecordInts + kFlags) & kNoEol) != 0;
  for (int j = kf; j < first + chunks; ++j) {
    zero_output(streams + j * kFaxInts, buffer);
    __syncthreads();
    e.s = streams + j * kFaxInts;
    carried = run_chunk(e, carried, hw, &foreign);
  }
}

}  // namespace

extern "C" {

// K11: the K11 streams (FAX_INTS ints each, at int fax_at of `buffer`'s descriptors) decode
// into `buffer` (their outputs zero before); tab: plain_image.fax_tables(); runs: the
// chunks' run scratch (codec.RawBatch.fax_runs ints, F_RUNS each's); records: FAX_RECORD_INTS
// ints a stream, zero (what each chunk's guess relied on, the image's counter and the chunk
// its repair started from, 1-based, on its first chunk's); max_area: the most run-array and
// row ints a chunk of the call takes (codec.fax_area).
int ssd_ccitt_decode(uint8_t* buffer, int fax_at, int faxes, const int* tab, uint32_t* runs, int* records,
                     int max_area, void* stream) {
  if (faxes < 1 || max_area < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long fixed = (static_cast<long long>(kTableInts) + kCtlInts + max_area) * 4;
  // the stage's halves: the largest from 32 KB down to 1 KB that lets two CTAs share an SM,
  // else the largest that fits one
  int half_log = 15;
  while (half_log >= 10 && fixed + (2LL << half_log) > kTwoPerSm) --half_log;
  if (half_log < 10) {
    half_log = 15;
    while (half_log >= 10 && fixed + (2LL << half_log) > kSharedBytes) --half_log;
  }
  if (half_log < 10) half_log = 0;  // walk each image serially, its arrays in global scratch
  const int bytes = static_cast<int>(half_log ? fixed + (2LL << half_log) : (kTableInts + kCtlInts) * 4);
  cudaError_t err = cudaFuncSetAttribute(ccitt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ccitt_kernel<<<faxes, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(buffer, fax_at, tab, runs, records,
                                                                             max_area, half_log);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

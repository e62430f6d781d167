"""Plain versions of the image kernels (csrc/jpeg_decode.cu, csrc/jpeg_progressive.cu,
csrc/jpeg_smooth.cu, csrc/resize.cu, csrc/png_unfilter.cu, csrc/raw_image.cu,
csrc/gif_lzw.cu, csrc/tiff_assemble.cu), in numpy (Python for the LZW walk) at the kernels' integer and float
arithmetic.

They are the CPU route of ops/cuda_image.py and the yardstick the kernels are held to
on the card; each takes and returns what its kernel does (numpy arrays in place of
tensors). None has a Pallas counterpart: the JAX package decodes and resizes with cv2
on the host (ssd_object_detection_tpu/data/pipeline.py:70-125, eval/serve.py:248-260).
What each reproduces, bit for bit:

  K1 `entropy_decode`: libjpeg's Huffman decoding (jdhuff.c) of each restart segment
     of a sequential scan, DC prediction reset at its start, coefficients in natural
     order (not dequantised). Here a 16-bit lookahead that also holds the extra bits
     resolves most symbols in one step; the kernel uses libjpeg's 9-bit lookahead and
     `maxcode` slow path. Both give the same coefficients.
     It also decodes the progressive scans that first send their coefficients
     (jdphuff.c's decode_mcu_DC_first and decode_mcu_AC_first).
  K6 `progressive_decode`: jdphuff.c's decode_mcu_DC_refine and decode_mcu_AC_refine
     over a progressive image's refinement scans in order, into the same coefficient
     layout; the EOB run resets at each restart segment.
  Both decode corrupt data as libjpeg does: a code longer than 16 bits is symbol 0
     after 17 bits, and where a segment's data runs out the MCU finishes on zero bits
     and the rest of the segment is left as it was.
  K7 `block_smooth`: libjpeg-turbo's block smoothing of progressive images whose scans
     leave coefficients unsent or unrefined (jdcoefct.c decompress_smooth_data).
  K2 `idct`: dequantisation and jpeg_idct_islow as the SIMD code of the libjpeg-turbo
     inside cv2 computes it (jidctint-avx2): CONST_BITS 13, PASS1_BITS 2, 16-bit
     dequantised coefficients and first sums, the pass outputs saturated to int16 and
     the samples to [0, 255]. For the coefficients of real images it equals the C
     code's range_limit; corrupt data (the zero bits libjpeg decodes past a cut) reaches
     the values where the two differ.
  K3 `color`: libjpeg-turbo's upsampling (jdsample.c: fancy h2v1, h1v2, h2v2, a box
     for h2v1 and h2v2 where the downsampled width is 2 or less and for every other
     integral ratio), context rows replicated from the first and the last real row,
     jdcolor.c's fixed-point YCbCr->RGB (SCALEBITS 16), gray replication, CMYK as cv2
     converts it (icvCvt_CMYK2BGR_8u_C4C3R: R = K - ((255 - C) * K >> 8), ...), YCCK
     through libjpeg's ycck_cmyk_convert (C = 255 - R of the YCbCr triple, K as is)
     first, and the Exif orientation as cv2 applies it.
  K4 `resize_*`: cv2.resize with INTER_LINEAR on uint8 (its fixed-point scheme: 11-bit
     coefficients from float32 coordinates and the SIMD vertical rounding
     `((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2`), INTER_LINEAR on
     float32 (the Intel IPP path cv2 takes: coordinates in double, `fma(b - a, t, a)`
     across then down; a source one pixel wide or high takes cv2's own float path), and
     INTER_AREA on uint8 (whole-number factors: the integer mean, `(s + 2) >> 2` at 2x;
     otherwise cv2's float area tables, accumulated in its order).
  K5 `png_unfilter` / `png_expand`: the five PNG row filters, then libpng's expansion
     as cv2 asks for it (gray 1/2/4 bits scaled to 8, palette to RGB, 16 bits >> 8,
     alpha dropped, gray to RGB), Adam7 passes scattered to their pixels.
  K8 `raw_expand`: BMP, PxM, PAM, Sun raster, PFM and HDR rows, GIF palette indices and
     TIFF samples (read through each TIFF's chunk table) to RGB as cv2's readers give them
     (grfmt_bmp.cpp, grfmt_pxm.cpp, grfmt_pam.cpp, grfmt_sunras.cpp, grfmt_pfm.cpp,
     grfmt_hdr.cpp with rgbe.cpp, grfmt_gif.cpp's code2pixel, libtiff 4.7's RGBA put
     routines with tif_color.c's YCbCr and CIELab conversions), every image of a decode
     call in one table.
  K9 `lzw_decode`: a GIF frame's LZW data to palette indices as cv2 5.0's
     GifDecoder::lzwDecode reads it, interlaced rows moved to their place.
  K10 `tiff_assemble`: libtiff's horizontal predictor and big-endian byte swap, in place
     in a decode call's TIFF chunks.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.data.codec import (
    SPACE_CMYK, SPACE_GRAY, SPACE_RGB, SPACE_YCC, SPACE_YCCK, T_MAXCODE, T_VALOFF, T_VALS, UP_BOX,
    UP_COPY, UP_H1V2, UP_H2V1, ZIGZAG,
)

# ---------------------------------------------------------------------------- K1
_FAST_BITS = 16


@functools.lru_cache(maxsize=64)
def _fast_table(blob: bytes, ac: bool) -> Tuple[int, ...]:
    """For every 16-bit window, the packed decode of the symbol it starts with (see
    `_pack`); 0 where the code and its extra bits do not fit in 16 bits."""
    table = np.frombuffer(blob, np.int32)
    w = np.arange(1 << _FAST_BITS, dtype=np.int64)
    length = np.zeros(w.size, np.int64)
    sym = np.zeros(w.size, np.int64)
    for n in range(16, 0, -1):  # the shortest code that matches wins
        code = w >> (_FAST_BITS - n)
        hit = code <= table[T_MAXCODE + n]
        idx = np.clip(code + table[T_VALOFF + n], 0, 255)
        length = np.where(hit, n, length)
        sym = np.where(hit, table[T_VALS + idx], sym)
    s = sym & 15
    adv = length + s
    ok = (length > 0) & (adv <= _FAST_BITS)
    bits = (w >> np.clip(_FAST_BITS - adv, 0, 16)) & ((1 << s) - 1)
    value = np.where(bits < (1 << np.maximum(s - 1, 0)), bits - (1 << s) + 1, bits)
    value = np.where(s == 0, 0, value)
    return tuple(np.where(ok, _pack(adv, sym, value, ac), 0).tolist())


def _pack(adv, sym, value, ac: bool):
    """A decoded symbol as one int. DC: adv | (value << 5). AC: adv | (step << 5) |
    ((value & 0xFFFF) << 12), where step is the run of a coefficient, 16 for ZRL and
    64 for EOB (value 0 for both)."""
    if not ac:
        return adv | (value << 5)
    run, s = sym >> 4, sym & 15
    step = np.where(s > 0, run, np.where(sym == 0xF0, 16, 64))
    return adv | (step << 5) | ((value & 0xFFFF) << 12)


NO_STOP = 2 ** 31 - 1  # a segment whose data did not run out
BAD_CODE_BITS = 17  # libjpeg reads a code longer than 16 bits as symbol 0 after 17 bits


def _slow_entry(data: bytes, p: int, table: np.ndarray, ac: bool) -> Tuple[int, int]:
    """(the packed decode at bit `p` by libjpeg's slow path, 1 where no code of the
    table starts there: then symbol 0 after 17 bits, as jpeg_huff_decode gives it)."""
    def bits(at: int, n: int) -> int:
        i = at >> 3
        chunk = int.from_bytes(data[i:i + 5].ljust(5, b"\0"), "big")
        return (chunk >> (40 - (at & 7) - n)) & ((1 << n) - 1)

    for n in range(1, 17):
        code = bits(p, n)
        if code <= table[T_MAXCODE + n]:
            sym = int(table[T_VALS + code + table[T_VALOFF + n]])
            s = sym & 15
            v = bits(p + n, s) if s else 0
            if s and v < (1 << (s - 1)):
                v -= (1 << s) - 1
            return int(_pack(n + s, sym, v, ac)), 0
    return int(_pack(BAD_CODE_BITS, 0, 0, ac)), 1


# Zero bytes after a segment: its last MCU decodes on zero bits past the data (libjpeg
# fills its bit buffer with zeros at a marker), up to 10 blocks of 64 codes and their
# extra bits.
_PAD = 2600


def _windows(raw: bytes, off: int, nbits: int) -> Tuple[bytes, memoryview]:
    """A segment's bytes and, for every bit position, the 16 bits from it. Past its end
    a segment reads zeros."""
    seg = raw[off:off + nbits // 8] + bytes(_PAD)
    d = np.frombuffer(seg + bytes(4), np.uint8).astype(np.uint32)
    w24 = (d[:-2] << 16) | (d[1:-1] << 8) | d[2:]
    pos = np.arange(8 * (len(d) - 2), dtype=np.uint32)
    return seg, memoryview(((w24[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF).astype(np.uint16))


def mcu_blocks(job: np.ndarray, first: int, count: int) -> Tuple[np.ndarray, List[int]]:
    """The coefficient blocks of MCUs first..first+count of a scan in decode order, and
    the scan component of each."""
    ncomp, per_row = int(job[0]), int(job[1])
    units = []  # (scan component, first block, blocks per row, h, v, by, bx) of an MCU's blocks
    for k in range(ncomp):
        _, _, h, v, fb, bw = (int(x) for x in job[2 + 6 * k:8 + 6 * k])
        units += [(k, fb, bw, h, v, by, bx) for by in range(v) for bx in range(h)]
    m = np.arange(first, first + count)
    my, mx = m // per_row, m % per_row
    order = np.stack([fb + (my * v + by) * bw + mx * h + bx for (_, fb, bw, h, v, by, bx) in units], 1)
    return order.reshape(-1), [u[0] for u in units] * count


def _segments_of(segments: np.ndarray, jobs: np.ndarray, routes, step: int):
    """(segment index, its row, its job) of the segments with MCUs of the scans of
    `routes` at `step`, in order."""
    for s, row in enumerate(segments.tolist()):
        jb = jobs[row[2]]
        if int(jb[33]) in routes and int(jb[34]) == step and row[4] > 0:
            yield s, row, jb


def _code(table: Tuple[int, ...], win, p: int) -> Tuple[int, int]:
    """((length << 8) | symbol, 1 for a code the table lacks) of the code at bit p."""
    e = table[win[p]]
    return (e, 0) if e else ((BAD_CODE_BITS << 8), 1)


def _first_scan(seg: bytes, win, nbits: int, jb: np.ndarray, first: int, count: int, tables: np.ndarray):
    """One segment of a scan that first sends its coefficients (sequential, progressive
    DC first or AC first) as libjpeg decodes it: every MCU until the one in which the
    data runs out, that one on zero bits past the data, none after it. Returns (writes:
    (coefficient index, value), DC values and their blocks, codes no table has, whether
    the local MCU in which the data ran out, or None)."""
    ss, se, _, al = (int(x) for x in jb[28:32])
    ncomp = int(jb[0])
    progressive = bool(jb[32])
    order, comp_of = mcu_blocks(jb, first, count)
    units = len(comp_of) // count
    zz = ZIGZAG.tolist()
    out: List[int] = []  # (coefficient index << 16) | (value & 0xFFFF)
    put = out.append
    bad = 0
    p = 0
    if progressive and ss > 0:  # decode_mcu_AC_first, one block an MCU
        ac = _code_table(tables[jb[3]].tobytes())
        eobrun = 0
        for m, base in enumerate((order * 64).tolist()):
            if eobrun:
                eobrun -= 1
                continue
            kk = ss
            while kk <= se:
                e, b = _code(ac, win, p)
                bad += b
                p += e >> 8
                r, size = (e >> 4) & 15, e & 15
                if size:
                    kk += r
                    v = win[p] >> (16 - size)
                    p += size
                    if v < (1 << (size - 1)):
                        v -= (1 << size) - 1
                    put(((base + zz[kk]) << 16) | (_short(v << al) & 0xFFFF))
                elif r == 15:
                    kk += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[p] >> (16 - r)
                        p += r
                    eobrun -= 1
                    break
                kk += 1
            if p > nbits:
                return out, bad, m
        return out, bad, None
    luts = []
    for k in range(ncomp):
        dc_t, ac_t = int(jb[2 + 6 * k]), int(jb[3 + 6 * k])
        luts.append((_fast_table(tables[dc_t].tobytes(), False), tables[dc_t],
                     None if progressive else _fast_table(tables[ac_t].tobytes(), True),
                     None if progressive else tables[ac_t]))
    pred = [0] * ncomp
    for i, (base, k) in enumerate(zip((order * 64).tolist(), comp_of)):
        dcl, dct, acl, act = luts[k]
        e = dcl[win[p]]
        if not e:
            e, b = _slow_entry(seg, p, dct, False)
            bad += b
        p += e & 31
        pred[k] += e >> 5
        value = _short(pred[k] << al) if progressive else pred[k]
        put((base << 16) | (value & 0xFFFF))  # a DC scan repeated after a refinement overwrites it
        kk = 1
        while acl is not None and kk < 64:
            e = acl[win[p]]
            if not e:
                e, b = _slow_entry(seg, p, act, True)
                bad += b
            p += e & 31
            kk += (e >> 5) & 127
            if e >> 12:
                put(((base + zz[kk]) << 16) | (e >> 12))
                kk += 1
        if (i + 1) % units == 0 and p > nbits:
            return out, bad, i // units
    return out, bad, None


def entropy_decode(data: np.ndarray, segments: np.ndarray, jobs: np.ndarray, tables: np.ndarray,
                   coef: np.ndarray, status: np.ndarray, stops: np.ndarray, step: int = 0) -> None:
    """K1, in place into int16 `coef` (total_blocks, 64) and int32 `status` (S,): the
    segments of the scans that first send their coefficients (sequential scans and
    progressive DC first and AC first ones) at `step`, coefficients in natural order
    (not dequantised). libjpeg's handling of corrupt data: a code no table has reads as
    symbol 0 after 17 bits; where a segment's data runs out (at the marker that ends
    it), the MCU being decoded finishes on zero bits and the rest of the segment is left
    as it was (zero, or what earlier scans wrote). A segment's status counts libjpeg's
    warnings: the codes no table has, and 1 where its data ran out; `stops` (S,) gets
    the MCU of the scan in which it ran out (NO_STOP where it did not; a missing interval
    skipped whole: its first MCU)."""
    raw = data.tobytes()
    flat = coef.reshape(-1)
    for s, (off, nbits, _, first, count, _, missing), jb in _segments_of(segments, jobs, (codec.ROUTE_K1,), step):
        if missing and stops[s - 1] != NO_STOP:
            stops[s] = first
            continue
        seg, win = _windows(raw, off, nbits)
        writes, bad, stop = _first_scan(seg, win, nbits, jb, first, count, tables)
        stops[s] = NO_STOP if stop is None else first + stop
        status[s] = bad + (stop is not None)
        if writes:
            packed = np.asarray(writes, np.int64)
            flat[packed >> 16] = (packed & 0xFFFF).astype(np.uint16).view(np.int16)


# ---------------------------------------------------------------------------- K6
@functools.lru_cache(maxsize=64)
def _code_table(blob: bytes) -> Tuple[int, ...]:
    """For every 16-bit window, (code length << 8) | symbol of the code it starts with;
    0 where no code of the table starts it."""
    table = np.frombuffer(blob, np.int32)
    w = np.arange(1 << 16, dtype=np.int64)
    length = np.zeros(w.size, np.int64)
    sym = np.zeros(w.size, np.int64)
    for n in range(16, 0, -1):  # the shortest code that matches wins
        code = w >> (16 - n)
        hit = code <= table[T_MAXCODE + n]
        length = np.where(hit, n, length)
        sym = np.where(hit, table[T_VALS + np.clip(code + table[T_VALOFF + n], 0, 255)], sym)
    return tuple(np.where(length > 0, (length << 8) | sym, 0).tolist())


def _short(v: int) -> int:
    """v as libjpeg's JCOEF (int16) holds it."""
    return ((v + 32768) & 0xFFFF) - 32768


def ac_refine_block(flat: np.ndarray, base: int, win, p: int, eob: bool, ac, ss: int, se: int, p1: int,
                    zz: List[int]) -> Tuple[int, int, int]:
    """decode_mcu_AC_refine on one block from bit p, in place: with `eob` the block lies
    in an EOB run and holds correction bits only. Returns (bit after it, the EOB run its
    EOB symbol starts (0 for none), codes no table has)."""
    m1 = -p1
    kk = ss
    eobrun = bad = 0
    if not eob:
        while kk <= se:
            e, b = _code(ac, win, p)
            bad += b
            p += e >> 8
            r, size = (e >> 4) & 15, e & 15
            val = 0
            if size:  # libjpeg warns where size is not 1, and reads one bit
                val = p1 if win[p] >> 15 else m1
                p += 1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += win[p] >> (16 - r)
                    p += r
                break
            while kk <= se:  # correction bits of the nonzero, r zeros skipped
                at = base + zz[kk]
                c = int(flat[at])
                if c:
                    if win[p] >> 15 and not c & p1:
                        flat[at] = _short(c + (p1 if c >= 0 else m1))
                    p += 1
                else:
                    r -= 1
                    if r < 0:
                        break
                kk += 1
            if val:
                flat[base + zz[kk]] = val
            kk += 1
    if eob or eobrun:
        while kk <= se:
            at = base + zz[kk]
            c = int(flat[at])
            if c:
                if win[p] >> 15 and not c & p1:
                    flat[at] = _short(c + (p1 if c >= 0 else m1))
                p += 1
            kk += 1
    return p, eobrun, bad


def progressive_decode(data: np.ndarray, segments: np.ndarray, jobs: np.ndarray, tables: np.ndarray,
                       coef: np.ndarray, status: np.ndarray, stops: np.ndarray, step: int = 0) -> None:
    """K6: the refinement scans of `step` (jdphuff.c's decode_mcu_DC_refine and
    decode_mcu_AC_refine), in order, into int16 `coef` (total_blocks, 64) and `status`
    (S,), in place; the EOB run resets at each restart segment. Corrupt data as in
    entropy_decode: where a segment's data runs out the MCU finishes on zero bits and
    the later ones keep what earlier scans wrote; `stops` as there."""
    raw = data.tobytes()
    flat = coef.reshape(-1)
    zz = ZIGZAG.tolist()
    routes = (codec.ROUTE_DC_REFINE, codec.ROUTE_AC_REFINE)
    for s, (off, nbits, _, first, count, _, missing), jb in _segments_of(segments, jobs, routes, step):
        if missing and stops[s - 1] != NO_STOP:
            stops[s] = first
            continue
        ss, se, _, al = (int(x) for x in jb[28:32])
        p1 = 1 << al
        order, _ = mcu_blocks(jb, first, count)
        if ss == 0:  # decode_mcu_DC_refine: a bit a block, no code
            seg = raw[off:off + nbits // 8]
            bits = np.unpackbits(np.frombuffer(seg, np.uint8))[:min(len(order), nbits)]
            hit = order[:len(bits)][bits == 1] * 64
            flat[hit] = (flat[hit] | p1).astype(np.int16)
            units = len(order) // count
            stops[s] = first + nbits // units if len(order) > nbits else NO_STOP
            status[s] = int(len(order) > nbits)
            continue
        seg, win = _windows(raw, off, nbits)
        ac = _code_table(tables[jb[3]].tobytes())
        p = eobrun = bad = 0
        stops[s] = NO_STOP
        for m, base in enumerate((order * 64).tolist()):
            p, run, b = ac_refine_block(flat, base, win, p, eobrun > 0, ac, ss, se, p1, zz)
            bad += b
            eobrun = (eobrun or run) - 1 if (eobrun or run) else 0
            if p > nbits:
                stops[s] = first + m
                break
        status[s] = bad + (stops[s] != NO_STOP)


# ---------------------------------------------------------------------------- K7
# jdcoefct.c's estimates: natural position, and the weights of the 5x5 DC neighbourhood
# (DC01..DC25, row by row, the block at DC13) with DC interpolation (change_dc: the
# component has no AC data) and without it (None: not estimated then).
_SMOOTH_TERMS = (
    (1, (-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1),
     (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    (8, (-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1),
     (0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0)),
    (16, (0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0),
     (0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0)),
    (9, (-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1),
     (0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0)),
    (2, (0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0),
     (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    (3, (0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0), None),
    (10, (0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0), None),
    (17, (0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0), None),
    (24, (0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0), None),
)
_SMOOTH_DC = (-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2)


def smooth_rows(by: np.ndarray, v: int, height_blocks: int, imcu_rows: int) -> np.ndarray:
    """(5, n) the block rows decompress_smooth_data reads for block rows `by` of a
    component (two above to two below), with its clamps: they compare the row with
    `block_rows * total_iMCU_rows`, where the last iMCU row's block_rows are only its
    real rows, and number that row's blocks by that count too."""
    imcu, b = by // v, by % v
    last = imcu == imcu_rows - 1
    rows = np.where(last, height_blocks % v, v)
    rows = np.where(rows == 0, v, rows)
    image_row = imcu * rows + b
    image_rows = rows * imcu_rows
    prev = np.where(image_row > 0, by - 1, by)
    prev2 = np.where(image_row > 1, by - 2, prev)
    nxt = np.where(image_row < image_rows - 1, by + 1, by)
    nxt2 = np.where(image_row < image_rows - 2, by + 2, nxt)
    return np.stack([prev2, prev, by, nxt, nxt2])


def _smooth_pred(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """jdcoefct.c's rounding of an estimate: ((Q << 7) + |num|) / (Q << 8), below 1 << Al
    where Al > 0, with num's sign."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def block_smooth(coef: np.ndarray, qtables: np.ndarray, smooth: np.ndarray, segments: np.ndarray,
                 jobs: np.ndarray, stops: np.ndarray) -> None:
    """K7, in place on int16 `coef` (total_blocks, 64): libjpeg-turbo's
    decompress_smooth_data for each component row of `smooth` (codec.SMOOTH_INTS). A
    coefficient of zig-zag 1-9 is estimated where it is still zero and its coef_bits
    are not 0 (5 of them, or all 9 and the DC where the component has no AC data); the
    DC values read are the unsmoothed ones; only the component's real blocks change.
    The iMCU rows after the image's last good one (`last_good_row`, from the segments'
    `stops`) take the coefficient bits from before the component's last scan."""
    dc = coef[:, 0].astype(np.int64)
    for first, bw, _, wb, hb, v, imcu_rows, q, *bits in smooth.tolist():
        bits, prev, (first_job, njobs) = bits[:10], bits[10:20], bits[20:22]
        good = last_good_row(segments, jobs, stops, first_job + njobs - 1, imcu_rows)
        by, bx = np.meshgrid(np.arange(hb), np.arange(wb), indexing="ij")
        by, bx = by.reshape(-1), bx.reshape(-1)
        rows = smooth_rows(by, v, hb, imcu_rows)  # (5, n)
        cols = np.clip(bx[None, :] + np.arange(-2, 3)[:, None], 0, wb - 1)  # (5, n)
        blocks = first + by * bw + bx
        grid = np.stack([dc[first + rows[r] * bw + cols[c]] for r in range(5) for c in range(5)])  # (25, n)
        qt = qtables[q].astype(np.int64)
        late = by // v > good
        new = {}
        for part, b in ((~late, bits), (late, prev)):
            if not part.any():
                continue
            change_dc = all(x == -1 for x in b[1:])
            at, g = blocks[part], grid[:, part]
            for i, (pos, w_dc, w_ac) in enumerate(_SMOOTH_TERMS):
                w = w_dc if change_dc else w_ac
                if w is None or b[1 + i] == 0:
                    continue
                pred = _smooth_pred(qt[0] * (np.asarray(w, np.int64) @ g), int(qt[pos]), b[1 + i])
                here = coef[at, pos]
                new.setdefault(pos, []).append((at, np.where(here == 0, pred, here)))
            if change_dc:
                new.setdefault(0, []).append((at, _smooth_pred(qt[0] * (np.asarray(_SMOOTH_DC, np.int64) @ g),
                                                               int(qt[0]), 0)))
        for pos, parts in new.items():
            for at, values in parts:
                coef[at, pos] = ((values + 32768) & 0xFFFF) - 32768


def smooth_plan(smooth: np.ndarray, tiles: int) -> np.ndarray:
    """K7's CTAs as the kernel finds them: int64 (tiles, 3) [component row, first block
    row, first block column] of each CTA's tile of codec.SMOOTH_TILE blocks. Its first warp
    finds the component by ballots over 32 rows at a time (the last row whose first CTA is
    at most the CTA's), here replayed group by group."""
    th, tw = codec.SMOOTH_TILE
    first = smooth[:, codec.S_TILE].astype(np.int64)
    out = np.zeros((tiles, 3), np.int64)
    for cta in range(tiles):
        found = -1
        for base in range(0, len(first), 32):
            ok = first[base:base + 32] <= cta
            if ok.any():
                found = base + int(np.flatnonzero(ok)[-1])
            if not ok.all():
                break
        t = cta - int(first[found])
        ty, tx = divmod(t, int(smooth[found, codec.S_TILES_X]))
        out[cta] = found, ty * th, tx * tw
    return out


def last_good_row_warp(segments: np.ndarray, jobs: np.ndarray, stops: np.ndarray, last_job: int,
                       imcu_rows: int) -> int:
    """last_good_row as K7's first warp works it out once a CTA: lanes test iMCU rows
    imcu_rows - 1 - lane, 32 at a time from the bottom, and the first group with a row
    whose MCU before it was decoded gives its highest such row (0 where none is)."""
    jb = jobs[last_job]
    s0, per_row, total, mrows, interval = int(jb[26]), int(jb[1]), int(jb[35]), int(jb[36]), int(jb[37])
    for base in range(imcu_rows - 1, 0, -32):
        r = base - np.arange(32)
        r = r[r > 0]
        m = np.minimum(r * mrows * per_row, total) - 1
        seg = s0 + m // interval
        ok = (segments[seg, 4] > 0) & (stops[seg] > m)
        if ok.any():
            return int(r[np.argmax(ok)])
    return 0


# ---------------------------------------------------------------------------- K2
_F = dict(
    F0298=2446, F0390=3196, F0541=4433, F0765=6270, F0899=7373, F1175=9633, F1501=12299,
    F1847=15137, F1961=16069, F2053=16819, F2562=20995, F3072=25172,
)


def _i16(x):
    """x wrapped to int16, as a 16-bit SIMD lane holds it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(c, shift: int):
    """One pass of libjpeg-turbo's SIMD jpeg_idct_islow (jidctint-avx2/sse2) over the
    last axis (8 int16 values, int64 arithmetic): in0 +- in4 and the odd part's in7 + in3
    and in5 + in1 are 16-bit sums (they wrap), every product a 32-bit multiply-add of
    16-bit inputs, and each output DESCALEd by `shift` and saturated to int16."""
    f = _F
    in0, in1, in2, in3, in4, in5, in6, in7 = (c[..., k] for k in range(8))
    tmp3 = in2 * (f["F0541"] + f["F0765"]) + in6 * f["F0541"]
    tmp2 = in2 * f["F0541"] + in6 * (f["F0541"] - f["F1847"])
    tmp0 = _i16(in0 + in4) << 13
    tmp1 = _i16(in0 - in4) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _i16(in7 + in3), _i16(in5 + in1)
    z3, z4 = (z3 * (f["F1175"] - f["F1961"]) + z4 * f["F1175"],
              z3 * f["F1175"] + z4 * (f["F1175"] - f["F0390"]))
    t0 = in7 * (f["F0298"] - f["F0899"]) - in1 * f["F0899"] + z3
    t3 = -in7 * f["F0899"] + in1 * (f["F1501"] - f["F0899"]) + z4
    t1 = in5 * (f["F2053"] - f["F2562"]) - in3 * f["F2562"] + z4
    t2 = -in5 * f["F2562"] + in3 * (f["F3072"] - f["F2562"]) + z3
    r = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([np.clip((o + r) >> shift, -32768, 32767) for o in out], -1)


def idct(coef: np.ndarray, qtables: np.ndarray, comps: np.ndarray) -> np.ndarray:
    """K2: int16 (B, 64) coefficients -> uint8 (B * 64,) component planes; component c's
    plane starts at comps[c, 0] * 64 and has rows of comps[c, 1] * 8 samples."""
    planes = np.zeros(coef.shape[0] * 64, np.uint8)
    for first, bw, bh, q in comps.tolist():
        n = bw * bh
        c = _i16(coef[first:first + n].astype(np.int64) * qtables[q].astype(np.int64)).reshape(n, 8, 8)
        cols = _idct_1d(np.swapaxes(c, 1, 2), 11)  # pass 1 over columns: (n, col, row)
        rows = _idct_1d(np.swapaxes(cols, 1, 2), 18)  # pass 2 over rows: (n, row, col)
        px = (np.clip(rows, -128, 127) + 128).astype(np.uint8)
        planes[first * 64:(first + n) * 64] = px.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(-1)
    return planes


# ---------------------------------------------------------------------------- K3
_FIX_1_402, _FIX_1_772, _FIX_0_71414, _FIX_0_34414 = 91881, 116130, 46802, 22554


def orientation_source(oh: int, ow: int, h: int, w: int, orientation: int):
    """For every pixel (oy, ox) of the oriented image, its (y, x) in the decoded one, as
    cv2's ExifTransform (flips and transposes) places it."""
    oy, ox = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    return {
        1: (oy, ox), 2: (oy, w - 1 - ox), 3: (h - 1 - oy, w - 1 - ox), 4: (h - 1 - oy, ox),
        5: (ox, oy), 6: (h - 1 - ox, oy), 7: (h - 1 - ox, w - 1 - oy), 8: (ox, w - 1 - oy),
    }[orientation]


def upsample(plane: np.ndarray, y: np.ndarray, x: np.ndarray, dw: int, dh: int, fh: int, fv: int,
             mode: int) -> np.ndarray:
    """Sample (y, x) of the full-size component from its downsampled plane (2-D)."""
    p = plane.astype(np.int32)
    if mode == UP_COPY:
        return p[y, x]
    if mode == UP_BOX:
        return p[y // fv, x // fh]
    if mode == UP_H1V2:
        i = y >> 1
        odd = (y & 1) == 1
        j = np.where(odd, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        return (3 * p[i, x] + p[j, x] + np.where(odd, 2, 1)) >> 2
    j = x >> 1
    xodd = (x & 1) == 1
    if mode == UP_H2V1:
        near = p[y, j]
        far = p[y, np.where(xodd, np.minimum(j + 1, dw - 1), np.maximum(j - 1, 0))]
        edge = np.where(xodd, j == dw - 1, j == 0)
        return np.where(edge, near, (3 * near + far + np.where(xodd, 2, 1)) >> 2)
    # UP_H2V2: column sums of the nearer and the further row, then across
    i = y >> 1
    yodd = (y & 1) == 1
    i1 = np.where(yodd, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))

    def colsum(col):
        return 3 * p[i, col] + p[i1, col]

    this = colsum(j)
    other = colsum(np.where(xodd, np.minimum(j + 1, dw - 1), np.maximum(j - 1, 0)))
    edge = np.where(xodd, j == dw - 1, j == 0)
    return np.where(edge, (4 * this + np.where(xodd, 7, 8)) >> 4,
                    (3 * this + other + np.where(xodd, 7, 8)) >> 4)


def color(planes: np.ndarray, images: np.ndarray, total_bytes: int) -> np.ndarray:
    """K3: planes -> uint8 (total_bytes,) RGB (or, SPACE_RAW, the components), each image
    at its byte offset."""
    out = np.zeros(total_bytes, np.uint8)
    for row in images.tolist():
        off, oh, ow, h, w, orient, ncomp, space = row[:8]
        y, x = orientation_source(oh, ow, h, w, orient)
        comp = []
        for c in range(ncomp):
            poff, stride, dw, dh, fh, fv, mode = row[8 + 8 * c:15 + 8 * c]
            rows = -(-dh // 8) * 8
            plane = planes[poff:poff + rows * stride].reshape(rows, stride)
            comp.append(upsample(plane, y, x, dw, dh, fh, fv, mode))
        px = to_rgb(comp, space).reshape(-1)
        out[off:off + px.size] = px
    return out


def to_rgb(comp: List[np.ndarray], space: int) -> np.ndarray:
    """uint8 (..., 3) RGB of the components' upsampled samples in colour space `space`
    (SPACE_RAW: (..., ncomp), the components as they are)."""
    if space == codec.SPACE_RAW:
        return np.stack(comp, -1).astype(np.uint8)
    if space == SPACE_GRAY:
        rgb = [comp[0]] * 3
    elif space == SPACE_RGB:
        rgb = comp
    else:
        if space in (SPACE_YCC, SPACE_YCCK):
            yy, cb, cr = comp[0], comp[1] - 128, comp[2] - 128
            r = yy + ((_FIX_1_402 * cr + 32768) >> 16)
            g = yy + ((-_FIX_0_34414 * cb + 32768 - _FIX_0_71414 * cr) >> 16)
            b = yy + ((_FIX_1_772 * cb + 32768) >> 16)
            rgb = [np.clip(ch, 0, 255) for ch in (r, g, b)]
        if space == SPACE_YCCK:  # ycck_cmyk_convert: C = 255 - R, M = 255 - G, Y = 255 - B
            comp = [255 - ch for ch in rgb] + [comp[3]]
        if space in (SPACE_CMYK, SPACE_YCCK):  # cv2: R = K - ((255 - C) * K >> 8), ...
            k = comp[3]
            rgb = [k - (((255 - ch) * k) >> 8) for ch in comp[:3]]
    return np.stack([np.clip(ch, 0, 255) for ch in rgb], -1).astype(np.uint8)


# ---------------------------------------------------------------------------- K4
def linear_table(n_src: int, n_dst: int, exact: bool, clamp: bool) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's source index and fraction of each output coordinate: float32 coordinates
    (its own path, `exact` False) or double ones (the IPP path); the horizontal table
    is clamped to the image, the vertical one not (its rows are, when read)."""
    scale = 1.0 / (n_dst / n_src)
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5
    if not exact:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    t = (f - s).astype(np.float32)
    if clamp:
        t[s < 0] = 0
        s[s < 0] = 0
        t[s >= n_src - 1] = 0
        s[s >= n_src - 1] = n_src - 1
    return s.astype(np.int32), t


def linear_u8_tables(src_hw, dst_hw):
    """(xofs, xcoef (w, 2) int32, yofs, ycoef (h, 2) int32) of the uint8 linear resize."""
    (H, W), (h, w) = src_hw, dst_hw
    sx, tx = linear_table(W, w, False, True)
    sy, ty = linear_table(H, h, False, False)

    def coef(t):
        return np.stack([np.rint((np.float32(1) - t) * np.float32(2048)),
                         np.rint(t * np.float32(2048))], 1).astype(np.int32)

    return sx, coef(tx), sy, coef(ty)


def resize_linear_u8(img: np.ndarray, dst_hw, tables=None) -> np.ndarray:
    """K4, uint8 INTER_LINEAR: (H, W, C) -> (h, w, C)."""
    H, W = img.shape[:2]
    sx, xc, sy, yc = tables if tables is not None else linear_u8_tables((H, W), dst_hw)
    im = img.astype(np.int32)
    x1 = np.minimum(sx + 1, W - 1)
    hor = im[:, sx] * xc[None, :, 0, None] + im[:, x1] * xc[None, :, 1, None]
    s0 = hor[np.clip(sy, 0, H - 1)] >> 4
    s1 = hor[np.clip(sy + 1, 0, H - 1)] >> 4
    out = (((yc[:, 0, None, None] * s0) >> 16) + ((yc[:, 1, None, None] * s1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (the float64 product of two float32 is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def linear_f32_tables(src_hw, dst_hw):
    """(xofs, xfrac, yofs, yfrac) of the float32 linear resize (IPP coordinates, or
    cv2's own where the source is one pixel wide or high)."""
    (H, W), (h, w) = src_hw, dst_hw
    exact = H > 1 and W > 1
    sx, tx = linear_table(W, w, exact, True)
    sy, ty = linear_table(H, h, exact, False)
    return sx, tx, sy, ty


def resize_linear_f32(img: np.ndarray, dst_hw, tables=None) -> np.ndarray:
    """K4, float32 INTER_LINEAR: (H, W, C) -> (h, w, C)."""
    H, W = img.shape[:2]
    sx, tx, sy, ty = tables if tables is not None else linear_f32_tables((H, W), dst_hw)
    x1 = np.minimum(sx + 1, W - 1)
    r0, r1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    TX, TY = tx[None, :, None], ty[:, None, None]
    if H > 1 and W > 1:  # IPP: a + (b - a) * t, fused, across then down
        a, b = img[:, sx], img[:, x1]
        hor = _fma(b - a, TX, a)
        a, b = hor[r0], hor[r1]
        return _fma(b - a, TY, a)
    one = np.float32(1)
    hor = img[:, sx] * (one - TX) + img[:, x1] * TX
    return hor[r0] * (one - TY) + hor[r1] * TY


def area_tables(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's INTER_AREA table (computeResizeAreaTab) as (n_dst, K) source indices and
    float32 weights, in cv2's order, padded with weight 0 (adding 0 changes no sum)."""
    scale = 1.0 / (n_dst / n_src)
    rows = []
    for dx in range(n_dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(row)
    k = max(len(r) for r in rows)
    idx = np.zeros((n_dst, k), np.int32)
    wt = np.zeros((n_dst, k), np.float32)
    for dx, row in enumerate(rows):
        for j, (s, a) in enumerate(row):
            idx[dx, j], wt[dx, j] = s, np.float32(a)
    return idx, wt


def area_is_integer(src_hw, dst_hw) -> bool:
    """cv2's is_area_fast: both scales whole numbers."""
    sx = 1.0 / (dst_hw[1] / src_hw[1])
    sy = 1.0 / (dst_hw[0] / src_hw[0])
    return abs(sx - round(sx)) < 2.220446049250313e-16 and abs(sy - round(sy)) < 2.220446049250313e-16


def resize_area_u8(img: np.ndarray, dst_hw, tables=None) -> np.ndarray:
    """K4, uint8 INTER_AREA for a downscale: (H, W, C) -> (h, w, C)."""
    H, W = img.shape[:2]
    h, w = dst_hw
    if area_is_integer((H, W), (h, w)):
        ky, kx = H // h, W // w
        s = img[:h * ky, :w * kx].reshape(h, ky, w, kx, -1).astype(np.int64).sum((1, 3))
        if (kx, ky) == (2, 2):
            return ((s + 2) >> 2).astype(np.uint8)
        scale = np.float32(1) / np.float32(kx * ky)  # cv2: float scale = 1.f / area
        return np.clip(np.rint(s.astype(np.float32) * scale), 0, 255).astype(np.uint8)
    xi, xw, yi, yw = tables if tables is not None else (*area_tables(W, w), *area_tables(H, h))
    f = img.astype(np.float32)
    total = None
    for j in range(yi.shape[1]):
        rows = f[yi[:, j]]  # (h, W, C)
        buf = np.zeros((h, w, f.shape[2]), np.float32)
        for k in range(xi.shape[1]):
            buf = buf + rows[:, xi[:, k]] * xw[None, :, k, None]
        part = yw[:, j, None, None] * buf
        total = part if total is None else total + part
    return np.clip(np.rint(total), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------- K5
def png_unfilter(inflated: np.ndarray, passes: np.ndarray) -> np.ndarray:
    """K5, first stage: undo each row's filter; uint8 rows without their filter bytes."""
    raw = np.zeros(int(sum(p[1] * p[2] for p in passes.tolist())), np.uint8)
    for at, rows, rb, bpp, out, *_ in passes.tolist():
        prev = np.zeros(rb, np.int32)
        for r in range(rows):
            start = at + r * (rb + 1)
            kind = int(inflated[start])
            line = inflated[start + 1:start + 1 + rb].astype(np.int32)
            if kind == 0:
                cur = line
            elif kind == 2:
                cur = (line + prev) & 255
            elif kind == 1:
                pad = (-rb) % bpp
                lanes = np.concatenate([line, np.zeros(pad, np.int32)]).reshape(-1, bpp)
                cur = (np.cumsum(lanes, 0) & 255).reshape(-1)[:rb]
            elif kind in (3, 4):
                cur_l = [0] * rb
                lv, pv = line.tolist(), prev.tolist()
                for i in range(rb):
                    a = cur_l[i - bpp] if i >= bpp else 0
                    b = pv[i]
                    if kind == 3:
                        cur_l[i] = (lv[i] + ((a + b) >> 1)) & 255
                    else:
                        c = pv[i - bpp] if i >= bpp else 0
                        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                        cur_l[i] = (lv[i] + pred) & 255
                cur = np.asarray(cur_l, np.int32)
            else:
                raise ValueError(f"corrupt PNG: filter type {kind}")
            raw[out + r * rb:out + (r + 1) * rb] = cur
            prev = cur
    return raw


def png_expand(raw: np.ndarray, passes: np.ndarray, info: Tuple[int, ...], palette: np.ndarray) -> np.ndarray:
    """K5, second stage: unfiltered rows -> uint8 (H, W, 3) RGB, oriented.
    info = (height, width, color type, bit depth, orientation)."""
    height, width, ctype, depth, orient = info
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = np.zeros((height, width, 3), np.uint8)
    for _, rows, rb, _, out, y0, x0, dy, dx, w, _ in passes.tolist():
        block = raw[out:out + rows * rb].reshape(rows, rb).astype(np.int32)
        col = np.arange(w)
        if depth < 8:
            bitpos = col * depth
            v = (block[:, bitpos >> 3] >> (8 - depth - (bitpos & 7))) & ((1 << depth) - 1)
            if ctype == 3:
                px = palette[v]
            else:
                g = (v * (255 // ((1 << depth) - 1))).astype(np.uint8)
                px = np.repeat(g[..., None], 3, -1)
        else:
            step = depth // 8
            samples = block[:, (col[:, None] * channels + np.arange(channels)) * step]  # high bytes
            if ctype == 3:
                px = palette[samples[..., 0]]
            elif ctype in (0, 4):
                px = np.repeat(samples[..., :1], 3, -1)
            else:
                px = samples[..., :3]
        img[y0::dy, x0::dx][:rows, :w] = px
    oh, ow = codec.oriented_hw(height, width, orient)
    y, x = orientation_source(oh, ow, height, width, orient)
    return img[y, x]


def png_decode(inflated: np.ndarray, passes: np.ndarray, images: np.ndarray, palettes: np.ndarray,
               total_pixels: int) -> np.ndarray:
    """K5 over a batch (codec.PngBatch): every pass unfiltered, then each image expanded
    to RGB at its pixel offset; uint8 (total_pixels * 3,)."""
    raw = png_unfilter(inflated, passes)
    out = np.zeros(total_pixels * 3, np.uint8)
    for (pixel, height, width, ctype, depth, orient, first, count), palette in zip(images.tolist(), palettes):
        rgb = png_expand(raw, passes[first:first + count], (height, width, ctype, depth, orient), palette)
        out[3 * pixel:3 * pixel + rgb.size] = rgb.reshape(-1)
    return out


def last_good_row(segments: np.ndarray, jobs: np.ndarray, stops: np.ndarray, last_job: int, imcu_rows: int) -> int:
    """libjpeg-turbo's last_good_iMCU_row after an image's last scan (`last_job`): the
    last iMCU row that scan began with its data not yet run out. K7 smooths the rows
    after it with the coefficient bits from before each component's last scan."""
    jb = jobs[last_job]
    s0, per_row, total, mrows, interval = int(jb[26]), int(jb[1]), int(jb[35]), int(jb[36]), int(jb[37])
    for r in range(imcu_rows - 1, 0, -1):
        m = min(r * mrows * per_row, total) - 1  # the last MCU of row r - 1
        seg = s0 + m // interval
        if segments[seg, 4] > 0 and stops[seg] > m:
            return r
    return 0


# ---------------------------------------------------------------------------- K8
def raw_expand(buffer: np.ndarray, images: int, chunk_at: int, jpeg: Optional[np.ndarray], out_bytes: int
               ) -> np.ndarray:
    """K8 over a decode call's images (codec.RawBatch: the image table at int 0 of
    `buffer`, TIFF chunks at int `chunk_at`; `jpeg`, the JPEG kernels' output, holds the
    TIFFs' JPEG chunks) -> uint8 (out_bytes,) RGB, each image at its byte offset, as cv2's
    BMP, PxM, PAM, Sun raster, PFM, HDR, GIF and TIFF readers give it (BGR there) with
    IMREAD_COLOR, turned by its orientation; pixels outside the rows' window take palette
    entry 256."""
    desc = buffer[:buffer.size // 4 * 4].view(np.int32)
    out = np.zeros(max(out_bytes, 1), np.uint8)
    for i in range(images):
        row = [int(v) for v in desc[i * codec.RAW_INTS:(i + 1) * codec.RAW_INTS]]
        rgb = _expand(buffer, desc, chunk_at, jpeg, row).reshape(-1)
        out[row[codec.R_OUT]:row[codec.R_OUT] + rgb.size] = rgb
    return out


def _expand(buffer, desc, chunk_at, jpeg, row) -> np.ndarray:
    """One image of K8's table -> uint8 (out h, out w, 3)."""
    height, width, fmt = row[codec.R_HEIGHT], row[codec.R_WIDTH], row[codec.R_FMT]
    y0, x0, wh, ww = row[codec.R_TOP:codec.R_WIN_W + 1]
    palette = buffer[row[codec.R_PALETTE]:row[codec.R_PALETTE] + 257 * 3].reshape(257, 3)
    img = np.empty((height, width, 3), np.uint8)
    img[:] = palette[256]
    if fmt >= codec.TIFF_LUT_FORMAT:
        y, x = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
        img[y0:y0 + wh, x0:x0 + ww] = _tiff_pixels(buffer, desc, chunk_at, jpeg, row, palette, y, x)
    else:
        img[y0:y0 + wh, x0:x0 + ww] = _window(
            buffer, fmt, row[codec.R_OFFSET], row[codec.R_STRIDE], row[codec.R_CHANNELS], row[codec.R_MAXVAL],
            row[codec.R_BIG_ENDIAN], wh, ww, palette, np.int32(row[codec.R_SCALE]).view(np.float32))
    if row[codec.R_MIRROR]:
        img = img[:, mirrored_columns(width, row[codec.R_MIRROR])]
    orientation = row[codec.R_ORIENTATION]
    oh, ow = codec.oriented_hw(height, width, orientation)
    return img[orientation_source(oh, ow, height, width, orientation)]


def mirrored_columns(width: int, tile: int) -> np.ndarray:
    """Each column's source where every tile `tile` pixels wide shows its columns in
    reverse order (the last tile cut at the image's edge)."""
    x = np.arange(width)
    x0 = x - x % tile
    return x0 + np.minimum(tile, width - x0) - 1 - (x - x0)


def _chunk_bytes(buffer, desc, chunk_at, jpeg, row, plane, y, x, rows_a_pitch: int = 1):
    """For pixels (y, x) of a TIFF: (each pixel's row and column in its chunk in `plane`,
    a function reading the byte `b` after the start of a pixel's row there, the rows a
    pitch apart `rows_a_pitch` to a pitch (a YCbCr data unit's height), as libtiff's put
    routine reads it: zero past what the chunk holds)."""
    rows_c, cw = row[codec.R_STRIDE], row[codec.R_CHUNK_W]
    cy, cx = y // rows_c, x // cw
    k = row[codec.R_OFFSET] + plane * row[codec.R_PER_PLANE] + cy * row[codec.R_ACROSS] + cx
    c = desc[chunk_at + k[..., None] * codec.TIFF_CHUNK_INTS + np.arange(codec.TIFF_CHUNK_INTS)].astype(np.int64)
    r, col = y - cy * rows_c, x - cx * cw
    base = c[..., codec.C_SRC] + r // rows_a_pitch * c[..., codec.C_PITCH]
    from_jpeg = c[..., codec.C_JPEG] == 1
    held_rows = r < c[..., codec.C_ROWS_HELD]

    def read(b, check=True):
        ok = held_rows & ((b < c[..., codec.C_BYTES_HELD]) if check else True)
        if jpeg is None:  # the JPEG chunks read as zero
            ok = ok & ~from_jpeg
        a = np.where(ok & ~from_jpeg, base + b, 0)
        v = buffer[np.minimum(a, buffer.size - 1)].astype(np.int64)
        if jpeg is not None and from_jpeg.any():
            j = np.where(ok & from_jpeg, base + b, 0)
            v = np.where(from_jpeg, jpeg[np.minimum(j, jpeg.size - 1)].astype(np.int64), v)
        return np.where(ok, v, 0)

    return r, col, read


def tiff_samples(buffer, desc, chunk_at, jpeg, row, y, x, sample: int, mode: str = "8") -> np.ndarray:
    """Sample `sample` of TIFF pixels (y, x), read through their chunks, as libtiff's put
    routines take it: a 1- or 4-bit value as is (MSB first), a 16-bit one (little-endian
    after K10) as its high byte ("8"), rounded to 8 bits where the routine maps it through
    Bitdepth16To8 ("rgb16": RGB, and gray planes), or whole ("16": CIELab's)."""
    planar, bits = row[codec.R_PLANAR], row[codec.R_MAXVAL]
    _, col, read = _chunk_bytes(buffer, desc, chunk_at, jpeg, row, sample if planar else 0, y, x)
    i = col * row[codec.R_CHANNELS] + (0 if planar else sample)  # the sample's index in its row
    if bits == 1:
        return (read(i >> 3) >> (7 - (i & 7))) & 1
    if bits == 4:
        return np.where(i & 1, read(i >> 1) & 15, read(i >> 1) >> 4)
    if bits == 8:
        return read(i)
    v = read(2 * i) | read(2 * i + 1) << 8
    return v if mode == "16" else (v + 128) // 257 if mode == "rgb16" else v >> 8


def _tiff_pixels(buffer, desc, chunk_at, jpeg, row, palette, y, x) -> np.ndarray:
    """RGB of TIFF pixels (y, x) by libtiff's put routine for the image's format."""
    fmt, colour, alpha = row[codec.R_FMT], row[codec.R_COLOUR], row[codec.R_ALPHA]

    def s(c, mode="rgb16"):
        return tiff_samples(buffer, desc, chunk_at, jpeg, row, y, x, c, mode)

    if fmt == codec.TIFF_LUT_FORMAT:  # BWmap / PALmap
        return palette[s(0, "8")]
    if fmt == codec.TIFF_CMYK_FORMAT:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        k = 255 - s(3)
        return np.stack([k * (255 - s(c)) // 255 for c in range(3)], -1).astype(np.uint8)
    if fmt == codec.TIFF_YCBCR_FORMAT:
        table = desc[row[codec.R_TABLE]:row[codec.R_TABLE] + codec.YCBCR_TABLE_INTS].astype(np.int64).reshape(5, 256)
        if row[codec.R_PLANAR]:  # putseparate8bitYCbCr11tile
            return ycbcr_rgb(table, s(0), s(1), s(2))
        hs, vs = row[codec.R_HS], row[codec.R_VS]  # putcontig8bitYCbCr<hs><vs>tile: a data unit's Y, then Cb, Cr
        r, col, read = _chunk_bytes(buffer, desc, chunk_at, jpeg, row, 0, y, x, vs)
        unit = (col // hs) * (hs * vs + 2)
        return ycbcr_rgb(table, read(unit + (r % vs) * hs + col % hs, False), read(unit + hs * vs, False),
                         read(unit + hs * vs + 1, False))
    if fmt == codec.TIFF_LAB_FORMAT:
        table = desc[row[codec.R_TABLE]:row[codec.R_TABLE] + codec.LAB_TABLE_INTS].view(np.float32)
        if row[codec.R_MAXVAL] == 16:  # putcontig8bitCIELab16: TIFFCIELab16ToXYZ
            l, a, b = s(0, "16"), s(1, "16"), s(2, "16")
            return lab_rgb(table, l.astype(np.float32) * np.float32(100) / np.float32(65535),
                           (a - ((a & 0x8000) << 1)).astype(np.float32) / np.float32(256) / np.float32(500),
                           (b - ((b & 0x8000) << 1)).astype(np.float32) / np.float32(256) / np.float32(200))
        l, a, b = s(0), s(1), s(2)  # putcontig8bitCIELab8: TIFFCIELabToXYZ, the 8-bit values scaled to 16
        return lab_rgb(table, (l * 257).astype(np.float32) * np.float32(100) / np.float32(65535),
                       ((a - ((a & 0x80) << 1)) * 256).astype(np.float32) / np.float32(256) / np.float32(500),
                       ((b - ((b & 0x80) << 1)) * 256).astype(np.float32) / np.float32(256) / np.float32(200))
    if fmt in codec.SGILOG_WORD:
        word = codec.SGILOG_WORD[fmt]
        _, col, read = _chunk_bytes(buffer, desc, chunk_at, jpeg, row, 0, y, x)
        b = [read(col * word + i) for i in range(word)]
        table = desc[row[codec.R_TABLE]:row[codec.R_TABLE] + codec.SGILOG_TABLE_INTS]
        if fmt == codec.TIFF_LOGL_FORMAT:
            return np.repeat(logl_gray(table, b[0] | b[1] << 8)[..., None], 3, -1)
        if fmt == codec.TIFF_LOGLUV_FORMAT:
            return logluv_rgb(table, b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24, False)
        return logluv_rgb(table, b[0] << 16 | b[1] << 8 | b[2], True)
    rgb = [s(c if colour == 3 else 0) for c in range(3)]
    if alpha >= 0:  # unassociated alpha: libtiff's UaToAa premultiplies
        a = s(alpha)
        rgb = [(v * a + 127) // 255 for v in rgb]
    return np.stack(rgb, -1).astype(np.uint8)


def ycbcr_rgb(table: np.ndarray, yy: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """tif_color.c TIFFYCbCrtoRGB through TIFFYCbCrToRGBInit's tables (codec.ycbcr_tables:
    Cr_r, Cb_b, Cr_g, Cb_g, Y), clamped to [0, 255]."""
    cr_r, cb_b, cr_g, cb_g, y_tab = table
    r = y_tab[yy] + cr_r[cr]
    g = y_tab[yy] + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y_tab[yy] + cb_b[cb]
    return np.stack([np.clip(v, 0, 255) for v in (r, g, b)], -1).astype(np.uint8)


def lab_rgb(table: np.ndarray, lum: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """tif_color.c TIFFCIELab16ToXYZ from L (0-100), a* / 500 and b* / 200 (float32, as
    the caller's put routine scales them), then TIFFXYZToRGB through
    TIFFCIELabToRGBInit's tables (codec.lab_tables), every step in float32 as the C
    evaluates it."""
    f = np.float32
    x0, y0, z0 = table[0], table[1], table[2]
    lum = lum.astype(f)
    low = lum < f(8.856)
    y_low = (lum * y0).astype(f) / f(903.292)
    cby_low = f(7.787) * (y_low / y0).astype(f) + f(f(16) / f(116))
    cby_high = ((lum + f(16)).astype(f) / f(116)).astype(f)
    y_high = ((y0 * cby_high).astype(f) * cby_high).astype(f) * cby_high
    yy = np.where(low, y_low, y_high).astype(f)
    cby = np.where(low, cby_low, cby_high).astype(f)

    def xz(t, w):
        t = t.astype(f)
        lin = (w * (t - f(0.13793)).astype(f)).astype(f) / f(7.787)
        cube = ((w * t).astype(f) * t).astype(f) * t
        return np.where(t < f(0.2069), lin, cube).astype(f)

    xx, zz = xz(a.astype(f) + cby, x0), xz(cby - b.astype(f), z0)
    out = []
    for gun in range(3):
        m0, m1, m2, black, white, step, vrw = table[3 + 7 * gun:10 + 7 * gun]
        v = ((m0 * xx).astype(f) + (m1 * yy).astype(f)).astype(f) + (m2 * zz).astype(f)
        v = np.minimum(np.maximum(v.astype(f), black), white)
        i = np.minimum(codec.LAB_RANGE, ((v - black).astype(f) / step).astype(f).astype(np.int64))
        level = table[codec.LAB_HEADER + gun * (codec.LAB_RANGE + 1) + i].astype(np.float64)
        out.append(np.minimum(np.where(level > 0, level + 0.5, level - 0.5).astype(np.int64), int(vrw)))
    return np.stack(out, -1).astype(np.uint8)


def _sgilog_y(table: np.ndarray, p16: np.ndarray) -> np.ndarray:
    """tif_luv.c LogL16toY of 16-bit LogL values (through codec.sgilog_tables' exp)."""
    y = table[:2 * 32768].view(np.float64)[p16 & 0x7fff]
    return np.where(p16 & 0x8000, -y, y)


def _gamma_byte(v: np.ndarray) -> np.ndarray:
    """tif_luv.c's 8-bit output of a linear value: 0 at or below 0, 255 at or above 1,
    else (int)(256. * sqrt(v))."""
    with np.errstate(invalid="ignore"):
        inside = (256.0 * np.sqrt(np.where((v > 0) & (v < 1), v, 0.0))).astype(np.int64)
    return np.where(v <= 0, 0, np.where(v >= 1, 255, inside)).astype(np.uint8)


def logl_gray(table: np.ndarray, p16: np.ndarray) -> np.ndarray:
    """tif_luv.c L16toGry: LogL -> 8-bit gray."""
    return _gamma_byte(_sgilog_y(table, p16))


def logluv_rgb(table: np.ndarray, p: np.ndarray, packed24: bool) -> np.ndarray:
    """tif_luv.c Luv32toRGB (LogLuv32toXYZ) or Luv24toRGB (LogLuv24toXYZ, uv_decode), then
    XYZtoRGB24, every step in double as the C evaluates it, X, Y and Z rounded to float
    first; a pixel of L at or below 0 is black. -> uint8 (..., 3)."""
    p = np.asarray(p, np.int64)
    if packed24:
        big = table[2 * 32768:2 * (32768 + 1024)].view(np.float64)[(p >> 14) & 0x3ff]
        lum = big
        ce = p & 0x3fff
        uv = table[2 * (32768 + 1024):].reshape(-1, 2)
        ustart, ncum = uv[:, 0].view(np.float32).astype(np.float64), uv[:, 1].astype(np.int64)
        vi = np.searchsorted(ncum, np.minimum(ce, codec.SGILOG_UV_NDIVS - 1), "right") - 1
        sq = np.float64(codec.SGILOG_UV_SQSIZ)
        u = ustart[vi] + ((ce - ncum[vi]) + .5) * sq
        v = np.float64(codec.SGILOG_UV_VSTART) + (vi + .5) * sq
        out = ce >= codec.SGILOG_UV_NDIVS  # uv_decode fails: the neutral colour
        u, v = np.where(out, codec.SGILOG_U_NEU, u), np.where(out, codec.SGILOG_V_NEU, v)
    else:
        lum = _sgilog_y(table, (p >> 16) & 0xffff)
        u = 1. / codec.SGILOG_UVSCALE * (((p >> 8) & 0xff) + .5)
        v = 1. / codec.SGILOG_UVSCALE * ((p & 0xff) + .5)
    with np.errstate(all="ignore"):
        s = 1. / (6. * u - 16. * v + 12.)
        x, y = 9. * u * s, 4. * v * s
        xyz = [(x / y * lum).astype(np.float32), lum.astype(np.float32), ((1. - x - y) / y * lum).astype(np.float32)]
    xyz = [np.where(lum > 0, c, np.float32(0)).astype(np.float64) for c in xyz]
    r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2]
    g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2]
    b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2]
    return np.stack([_gamma_byte(c) for c in (r, g, b)], -1)


def _window(data, fmt, offset, stride, channels, maxval, big_endian, height, width, palette, scale):
    x = np.arange(width)
    rows = offset + np.arange(height)[:, None] * stride  # (H, 1) first byte of each row
    d = data.astype(np.int64)

    def at(col):
        return d[rows + col]

    if fmt in (codec.RAW_PAL1, codec.RAW_PAL4, codec.RAW_PAL8):
        if fmt == codec.RAW_PAL1:
            idx = (at(x >> 3) >> (7 - (x & 7))) & 1
        elif fmt == codec.RAW_PAL4:
            idx = np.where(x & 1, at(x >> 1) & 15, at(x >> 1) >> 4)
        else:
            idx = at(x)
        return palette[idx]
    if fmt in (codec.RAW_BGR555, codec.RAW_BGR565):
        t = at(2 * x) | (at(2 * x + 1) << 8)
        b = (t << 3) & 255
        g = ((t >> 2) & 0xF8) if fmt == codec.RAW_BGR555 else ((t >> 3) & 0xFC)
        r = ((t >> 7) & 0xF8) if fmt == codec.RAW_BGR555 else ((t >> 8) & 0xF8)
        return np.stack([r, g, b], -1).astype(np.uint8)
    if fmt in (codec.RAW_BGR, codec.RAW_BGRX):
        n = 3 if fmt == codec.RAW_BGR else 4
        return np.stack([at(n * x + 2), at(n * x + 1), at(n * x)], -1).astype(np.uint8)
    if fmt == codec.RAW_RGB:
        return np.stack([at(3 * x), at(3 * x + 1), at(3 * x + 2)], -1).astype(np.uint8)
    if fmt == codec.RAW_GRAY:
        return np.repeat(at(x)[..., None], 3, -1).astype(np.uint8)
    if fmt in (codec.RAW_RGB16, codec.RAW_BGR16):  # big-endian samples: the high byte
        c = (0, 2, 4) if fmt == codec.RAW_RGB16 else (4, 2, 0)
        return np.stack([at(6 * x + i) for i in c], -1).astype(np.uint8)
    if fmt == codec.RAW_GRAY16:
        return np.repeat(at(2 * x)[..., None], 3, -1).astype(np.uint8)
    if fmt == codec.RAW_TEXT:
        c = np.arange(3) if channels == 3 else np.zeros(3, np.int64)
        col = 2 * (channels * x[:, None] + c[None, :])  # (W, 3) byte of each sample
        v = np.minimum(d[rows[..., None] + col] | (d[rows[..., None] + col + 1] << 8), maxval)
        return (v * 255 // maxval if maxval < 256 else v >> 8).astype(np.uint8)
    if fmt == codec.RAW_FLOAT:
        c = np.arange(3) if channels == 3 else np.zeros(3, np.int64)
        col = 4 * (channels * x[:, None] + c[None, :])
        b = [d[rows[..., None] + col + i] for i in range(4)]
        bits = ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]) if big_endian else (
            (b[3] << 24) | (b[2] << 16) | (b[1] << 8) | b[0])
        return _saturate(bits.astype(np.uint32).view(np.float32) * np.float32(scale))
    if fmt == codec.RAW_RGBE:  # rgbe2float, then convertTo(CV_8U, 255)
        col = 4 * x[:, None] + np.arange(3)[None, :]  # R, G, B mantissas
        e = at(4 * x + 3)[..., None]
        f = np.ldexp(1.0, e - 136).astype(np.float32)  # exact: a power of two, subnormal from e < 10
        with np.errstate(over="ignore"):  # past float32: infinity, which saturates to 0
            v = d[rows[..., None] + col].astype(np.float32) * f * np.float32(255)
        return np.where(e == 0, 0, _saturate(v)).astype(np.uint8)
    raise ValueError(f"unknown raw format {fmt}")


def _saturate(v: np.ndarray) -> np.ndarray:
    """cv2's saturate_cast<uchar> of float32: rounded half to even; NaN, infinities and
    values past int32 (cvRound's INT_MIN) give 0."""
    ok = np.abs(v) < np.float32(2 ** 31)
    return np.where(ok, np.clip(np.rint(np.where(ok, v, 0)), 0, 255), 0).astype(np.uint8)


# ---------------------------------------------------------------------------- K9
def interlaced_rows(height: int) -> np.ndarray:
    """The frame row of each row of a GIF's interlaced data: rows 0, 8, ..., then 4, 12,
    ..., then 2, 6, ..., then 1, 3, ..."""
    return np.concatenate([np.arange(start, height, step) for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def lzw_frame(data: bytes, min_code_size: int, pixels: int) -> Tuple[bytes, int]:
    """cv2's GifDecoder::lzwDecode over a frame's joined LZW data: (the frame's palette
    indices in data order, zero past what decoded; its status, codec.GIF_*). Clear and
    EOI both reset the table and the code width, and decoding goes on after an EOI. A
    code that writes pixels once the frame is full ends the walk: it is accepted only
    when it came with the data's last byte and the frame has exactly its pixels. A code
    past the table fails, as does data that runs out short of the frame; a string past
    the frame is an overflow. A literal of a code size past 8 keeps its low byte."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray(pixels)
    size, table_size, idx = min_code_size + 1, eoi, 0
    strings: dict = {}
    pending = {eoi: b""}  # the prefix of the entry the next code completes, by its number
    acc = bits = pos = 0
    n = len(data)
    while True:
        while bits < size:
            if pos >= n:
                return bytes(out), codec.GIF_OK if idx == pixels else codec.GIF_LZW_FAILED
            acc |= data[pos] << bits
            pos += 1
            bits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        bits -= size
        if code == clear or code == eoi:
            size, table_size, strings, pending = min_code_size + 1, eoi, {}, {eoi: b""}
            continue
        if idx >= pixels:
            return bytes(out), codec.GIF_OK if idx == pixels and pos == n else codec.GIF_LZW_FAILED
        if table_size < 4096:
            if code < clear:
                string = bytes((code & 255,))
            elif code > table_size:
                return bytes(out), codec.GIF_LZW_FAILED
            else:
                string = strings[code] if code < table_size else pending[table_size] + pending[table_size][:1]
            strings[table_size] = pending[table_size] + string[:1]
            table_size += 1
            pending[table_size] = string
        else:  # the table is full: no entry is added until a Clear
            string = bytes((code & 255,)) if code < clear else strings[code]
        if idx + len(string) > pixels:
            return bytes(out), codec.GIF_OVERFLOW
        out[idx:idx + len(string)] = string
        idx += len(string)
        if table_size == 1 << size and size <= 11:
            size += 1


def lzw_tiff(data: bytes, size: int, old: bool = False) -> Tuple[bytes, int]:
    """libtiff 4.7's LZWDecode of one TIFF chunk into `size` bytes: (the bytes, zero past
    what decoded; codec.GIF_OK where it filled them, else GIF_LZW_FAILED). MSB-first codes,
    9 bits after a Clear (256), one bit more once the table's next entry reaches 511, 1023
    and 2047 (the "early change"), 12 at most; the data must start with a Clear; EOI (257)
    ends it; a code past the table fails, as does data that runs out; the string that
    fills the chunk is cut there, and later codes are not read. The table goes on growing
    past 4096 entries (libtiff's compatible CSIZE of 5119) with no code to reach them, and
    once 5119 entries exist any code but a Clear or EOI fails. `old`: LZWDecodeCompat, the
    old-style (LSB-first) codes, one bit more once the next entry reaches 512, 1024 and
    2048 (a GIF's schedule); everything else as LZWDecode."""
    out = bytearray(size)
    idx = acc = bits = pos = 0
    n = len(data)
    free = None  # the next entry: None before the first Clear
    strings: dict = {}
    prev = None  # the previous code's string; None right after a Clear
    while True:
        width = 9 if free is None else min(12, (free + (not old)).bit_length())
        while bits < width:
            if pos >= n:
                return bytes(out), codec.GIF_LZW_FAILED
            acc = acc | data[pos] << bits if old else acc << 8 | data[pos]
            pos += 1
            bits += 8
        if old:
            code, acc = acc & ((1 << width) - 1), acc >> width
        else:
            code = (acc >> (bits - width)) & ((1 << width) - 1)
        bits -= width
        if code == codec.TIFF_LZW_CLEAR:
            free, strings, prev = 258, {}, None
            continue
        if free is None or code == codec.TIFF_LZW_EOI:
            return bytes(out), codec.GIF_LZW_FAILED
        if prev is None:
            if code > codec.TIFF_LZW_EOI:
                return bytes(out), codec.GIF_LZW_FAILED
            string = bytes((code,))
        else:
            if free >= 5119 or code > free:
                return bytes(out), codec.GIF_LZW_FAILED
            string = bytes((code,)) if code < 256 else strings[code] if code < free else prev + prev[:1]
            if free < 4096:
                strings[free] = prev + string[:1]
            free += 1
        take = min(len(string), size - idx)
        out[idx:idx + take] = string[:take]
        idx += take
        prev = string
        if idx == size:
            return bytes(out), codec.GIF_OK


def gif_valid(gif_row) -> np.ndarray:
    """(256,) bool: the indices a pixel may take, from a codec.GIF_INTS row's 8 words."""
    words = np.asarray(gif_row[8:16], np.int64) & 0xFFFFFFFF
    return ((words[:, None] >> np.arange(32)) & 1).reshape(256).astype(bool)


def lzw_decode(data: np.ndarray, gifs: np.ndarray, total: int, out: np.ndarray = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """K9: every GIF's first frame and TIFF LZW chunk (codec.GIF_INTS rows) -> (uint8
    (total,) output, `out` where given: each frame's palette indices at its offset in row
    order, interlaced rows moved to their place, each TIFF chunk's bytes at its offset;
    int32 (G,) status, codec.GIF_*: the LZW walk's, else GIF_BAD_INDEX where a pixel takes
    an index no colour table has). A failed frame's indices are unspecified; a failed
    TIFF chunk keeps what decoded, zero after it."""
    out = np.zeros(total, np.uint8) if out is None else out
    status = np.zeros(len(gifs), np.int32)
    for g, row in enumerate(gifs.tolist()):
        at, nbytes, min_code_size, w, h, interlaced, offset = row[:7]
        if row[16] != codec.LZW_GIF:
            chunk, status[g] = lzw_tiff(bytes(data[at:at + nbytes]), w, row[16] == codec.LZW_TIFF_OLD)
            out[offset:offset + w] = np.frombuffer(chunk, np.uint8)
            continue
        indices, st = lzw_frame(bytes(data[at:at + nbytes]), min_code_size, w * h)
        frame = np.frombuffer(indices, np.uint8).reshape(h, w)
        if st == codec.GIF_OK and not gif_valid(row)[frame].all():
            st = codec.GIF_BAD_INDEX
        if interlaced:
            placed = np.empty_like(frame)
            placed[interlaced_rows(h)] = frame
            frame = placed
        out[offset:offset + w * h] = frame.reshape(-1)
        status[g] = st
    return out, status


# ---------------------------------------------------------------------------- K10
def tiff_assemble(buffer: np.ndarray, chunk_at: int, work_at: int, works: int, status: np.ndarray) -> np.ndarray:
    """K10, in place in `buffer` (a codec.RawBatch's): each chunk of K10's list (at int
    `work_at`, `works` of them; the kernel finds a row's chunk through the rows' entries
    after the list) has the horizontal predictor undone a row at a time (each
    sample plus the one a pixel before, mod 2^8 or 2^16) and 16-bit samples of a
    big-endian file swapped to little-endian; a chunk whose K9 stream failed (`status`)
    stays as it decoded, as libtiff leaves it. Returns `buffer`."""
    desc = buffer[:buffer.size // 4 * 4].view(np.int32)
    for k in desc[work_at:work_at + works * codec.K10_WORK_INTS:codec.K10_WORK_INTS].tolist():
        c = desc[chunk_at + k * codec.TIFF_CHUNK_INTS:chunk_at + (k + 1) * codec.TIFF_CHUNK_INTS].tolist()
        src, rows, row_bytes, width, samples, predictor, swab, stream = (
            c[codec.C_SRC], c[codec.C_ROWS], c[codec.C_ROW_BYTES], c[codec.C_WIDTH], c[codec.C_SAMPLES],
            c[codec.C_PREDICTOR], c[codec.C_SWAB], c[codec.C_STREAM])
        if stream >= 0 and status[stream] != codec.GIF_OK:
            continue
        block = buffer[src:src + rows * row_bytes].reshape(rows, row_bytes)
        n = width * samples
        if predictor == 8:
            v = block[:, :n].reshape(rows, width, samples).astype(np.int64)
            block[:, :n] = (np.cumsum(v, 1) & 255).astype(np.uint8).reshape(rows, n)
        elif predictor == 16 or swab:
            pairs = block[:, :2 * n].reshape(rows, n, 2).astype(np.int64)
            v = pairs[..., 0] << 8 | pairs[..., 1] if swab else pairs[..., 0] | pairs[..., 1] << 8
            if predictor == 16:
                v = np.cumsum(v.reshape(rows, width, samples), 1).reshape(rows, n) & 0xFFFF
            block[:, :2 * n] = np.stack([v & 255, v >> 8], -1).astype(np.uint8).reshape(rows, 2 * n)
    return buffer


# ---------------------------------------------------------------------------- K11
# The T.4 / T.6 code words (ITU-T T.4 tables 1-4 and the 2-D mode codes of table 4/T.4),
# first bit first, as libtiff's mkg3states builds its state tables from them.
_WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100", "00111", "01000",
    "001000", "000011", "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011",
    "00011010", "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100")
_WHITE_MAKEUP = (  # 64, 128, ..., 1728
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101", "01101000", "01100111",
    "011001100", "011001101", "011010010", "011010011", "011010100", "011010101", "011010110", "011010111",
    "011011000", "011011001", "011011010", "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011")
_BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100", "0000100", "0000101",
    "0000111", "00000100", "00000111", "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
    "00001101000", "00001101100", "00000110111", "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000", "000000100111", "000000101000",
    "000001011000", "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
_BLACK_MAKEUP = (  # 64, 128, ..., 1728
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110",
    "0000001110111", "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101")
_EXT_MAKEUP = (  # 1792, 1856, ..., 2560, both colours
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111")
# tif_fax3.h's states
(FAX_NULL, FAX_PASS, FAX_HORIZ, FAX_V0, FAX_VR, FAX_VL, FAX_EXT, FAX_TERMW, FAX_TERMB, FAX_MAKEUPW, FAX_MAKEUPB,
 FAX_MAKEUP, FAX_EOL) = range(13)
FAX_MAIN_BITS, FAX_WHITE_BITS, FAX_BLACK_BITS = 7, 12, 13


@functools.lru_cache(maxsize=None)
def fax_tables() -> np.ndarray:
    """libtiff's TIFFFaxMainTable, TIFFFaxWhiteTable and TIFFFaxBlackTable (tif_fax3sm.c)
    built as mkg3states builds them, one after another: int32 entries indexed by the next
    7, 12 or 13 bits read LSB first (a code's first bit at bit 0), each state | width << 4
    | param << 8 (state FAX_NULL, width 0 where no code matches)."""
    main = np.zeros(1 << FAX_MAIN_BITS, np.int32)
    white = np.zeros(1 << FAX_WHITE_BITS, np.int32)
    black = np.zeros(1 << FAX_BLACK_BITS, np.int32)

    def fill(table, codes, state, params):
        for code, param in zip(codes, params):
            width = len(code)
            for at in range(int(code[::-1], 2), table.size, 1 << width):
                table[at] = state | width << 4 | param << 8

    for codes, state, params in ((("0001",), FAX_PASS, (0,)), (("001",), FAX_HORIZ, (0,)), (("1",), FAX_V0, (0,)),
                                 (("011", "000011", "0000011"), FAX_VR, (1, 2, 3)),
                                 (("010", "000010", "0000010"), FAX_VL, (1, 2, 3)),
                                 (("0000001",), FAX_EXT, (0,)), (("0000000",), FAX_EOL, (0,))):
        fill(main, codes, state, params)
    makeups = range(64, 1729, 64)
    ext = range(1792, 2561, 64)
    for table, term, makeup, tstate, mstate in ((white, _WHITE_TERM, _WHITE_MAKEUP, FAX_TERMW, FAX_MAKEUPW),
                                                (black, _BLACK_TERM, _BLACK_MAKEUP, FAX_TERMB, FAX_MAKEUPB)):
        fill(table, makeup, mstate, makeups)
        fill(table, _EXT_MAKEUP, FAX_MAKEUP, ext)
        fill(table, term, tstate, range(64))
        fill(table, ("0" * 11,), FAX_EOL, (0,))
    return np.concatenate([main, white, black])


FAX_WHITE_AT, FAX_BLACK_AT = 1 << FAX_MAIN_BITS, (1 << FAX_MAIN_BITS) + (1 << FAX_WHITE_BITS)
_REV = codec._BIT_REVERSED


class _FaxEOF(Exception):
    """The data ran out with no bit left (a NeedBits macro's `eoflab`)."""


class _FaxRetry(Exception):
    """SYNC_EOL found no EOL: `retrywithouteol`."""


class _FaxAbort(Exception):
    """libtiff's decoder returned -1 before filling the row (a run array overflow)."""


def _u32(x: int) -> int:
    return x & 0xFFFFFFFF


def _i32(x: int) -> int:
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def fill_runs(row: np.ndarray, runs: List[int], at: int, end: int, lastx: int) -> None:
    """tif_fax3.c _TIFFFax3fillruns: runs[at:end] alternately white (bits cleared) and
    black (bits set) from pixel 0 of `row` (uint8 bytes, zero before: each of its bits is
    written once), each cut at `lastx` and written back cut, as the next row's reference
    line reads them; an odd count gets a zero run."""
    if (end - at) & 1:
        runs[end] = 0
        end += 1
    x, lengths = 0, []
    for k in range(at, end):
        run = runs[k]
        if _u32(x + run) > lastx or run > lastx:
            run = runs[k] = _u32(lastx - x)
        lengths.append(run)
        x += run
    bits = np.repeat(np.arange(len(lengths), dtype=np.uint8) & 1, lengths)
    packed = np.packbits(bits)
    row[:packed.size] |= packed


def fax_decode(raw: bytes, mode: int, rows: int, width: int, row_bytes: int, odd: int, out: np.ndarray,
               noeol: bool = False, runs: Optional[List[int]] = None, fill=None) -> bool:
    """K11's CCITT flavours: libtiff 4.7's tif_fax3.c decoders of one chunk into `out`
    (uint8, rows x row_bytes, zero where nothing decodes): Fax3DecodeRLE (modified Huffman,
    each row byte-aligned; RLEW word-aligned, `odd` the parity of the chunk's first byte's
    address, which its alignment test reads), Fax3Decode1D, Fax3Decode2D and Fax4Decode, a
    step of the C at a time (tif_fax3.h's macros: the LSB-first bit buffer, the zero bits
    padded where the data runs out, SYNC_EOL, EXPAND1D, EXPAND2D, CLEANUP_RUNS) on the
    bytes as stored (the decoder reverses each byte; FillOrder 2's are reversed before).
    A decoding error fills the row as far as it got and ends the chunk. Group 3 rows
    start at an EOL; where the data runs out after an EOL's zeros, libtiff takes the file
    for one without EOLs (FAXMODE_NOEOL, kept for the image's later chunks: `noeol` in,
    the mode after out) and reads again from the chunk's first bit into the same row.
    `fill(row, runs, at, end, lastx)` fills a row (fill_runs; the replay of K11's schedule
    passes its own, and run arrays with `start_row` and `use` methods that watch what the
    reference line's position b1 reads: ops/fax_schedule_model.Tracked)."""
    fill = fill or fill_runs
    use = getattr(runs, "use", None)  # b1's value decides something (K11's replay)
    main, white, black = (fax_tables()[a:b] for a, b in ((0, FAX_WHITE_AT), (FAX_WHITE_AT, FAX_BLACK_AT),
                                                          (FAX_BLACK_AT, None)))
    lastx = width
    two_d = mode in (codec.FAX_G3_2D, codec.FAX_G4)
    R = [0] * codec.fax_scratch(mode, width) if runs is None else runs  # curruns, then refruns (2-D)
    nruns = (len(R) - 8) // 2
    cur, ref = 0, nruns
    if two_d:
        R[ref], R[ref + 1] = lastx, 0  # Fax3PreDecode: the reference line is white
    n = len(raw)
    st = dict(acc=0, avail=0, cp=0, eol=0)

    def need(k, two):
        if st["avail"] < k:
            if st["cp"] >= n:
                if st["avail"] == 0:
                    raise _FaxEOF
                st["avail"] = k
                return
            st["acc"] |= _REV[raw[st["cp"]]] << st["avail"]
            st["cp"] += 1
            st["avail"] += 8
            if two and st["avail"] < k:
                if st["cp"] >= n:
                    st["avail"] = k
                else:
                    st["acc"] |= _REV[raw[st["cp"]]] << st["avail"]
                    st["cp"] += 1
                    st["avail"] += 8

    def get(k):
        return st["acc"] & ((1 << k) - 1)

    def clr(k):
        st["avail"] -= k
        st["acc"] >>= k

    def lookup(table, bits, two):
        need(bits, two)
        e = int(table[get(bits)])
        clr((e >> 4) & 15)
        return e & 15, e >> 8

    line = 0
    while line < rows:
        row = out[line * row_bytes:(line + 1) * row_bytes]
        thisrun = cur
        s = dict(a0=0, rl=0, pa=thisrun, pb=0, b1=0)
        if use:
            R.start_row(thisrun)

        def put(v):
            if s["pa"] >= len(R) - 1:  # past the run arrays (libtiff writes on; not pinned)
                raise _FaxAbort
            R[s["pa"]] = _u32(v)
            s["pa"] += 1

        def setvalue(x):
            put(s["rl"] + x)
            s["a0"] = _i32(s["a0"] + x)
            s["rl"] = 0

        def cleanup():
            if s["rl"]:
                setvalue(0)
            if s["a0"] != lastx:
                while s["a0"] > lastx and s["pa"] > thisrun:
                    s["pa"] -= 1
                    s["a0"] = _i32(s["a0"] - R[s["pa"]])
                if s["a0"] < lastx:
                    if s["a0"] < 0:
                        s["a0"] = 0
                    if (s["pa"] - thisrun) & 1:
                        setvalue(0)
                    setvalue(lastx - s["a0"])
                elif s["a0"] > lastx:
                    setvalue(lastx)
                    setvalue(0)

        def run_colour(table, bits, term):
            """A white or black run's codes: 'done' at its terminating code, else the state
            that ended it (an EOL, or no code)."""
            while True:
                state, param = lookup(table, bits, True)
                if state == term:
                    setvalue(param)
                    return "done"
                if state in (FAX_MAKEUPW, FAX_MAKEUPB, FAX_MAKEUP):
                    s["a0"] = _i32(s["a0"] + param)
                    s["rl"] = _i32(s["rl"] + param)
                    continue
                return state

        def expand1d():
            """EXPAND1D: True at its end (done1d), after CLEANUP_RUNS; _FaxEOF after it."""
            try:
                while True:
                    r = run_colour(white, FAX_WHITE_BITS, FAX_TERMW)
                    if r != "done":
                        if r == FAX_EOL:
                            st["eol"] = 1
                        break
                    if s["a0"] >= lastx:
                        break
                    r = run_colour(black, FAX_BLACK_BITS, FAX_TERMB)
                    if r != "done":
                        if r == FAX_EOL:
                            st["eol"] = 1
                        break
                    if s["a0"] >= lastx:
                        break
                    if R[s["pa"] - 1] == 0 and R[s["pa"] - 2] == 0:
                        s["pa"] -= 2
            except _FaxEOF:
                cleanup()
                raise
            cleanup()

        def check_b1():
            if use:
                use()
            if s["pa"] != thisrun:
                while s["b1"] <= s["a0"] and s["b1"] < lastx:
                    if s["pb"] + 1 >= ref_end:
                        raise _FaxAbort
                    s["b1"] = _i32(s["b1"] + _u32(R[s["pb"]] + R[s["pb"] + 1]))
                    s["pb"] += 2
                    if use:
                        use()

        def expand2d():
            """EXPAND2D, ending in CLEANUP_RUNS (eol2d); _FaxEOF after it on eof2d."""
            try:
                while s["a0"] < lastx:
                    if s["pa"] >= thisrun + nruns:
                        raise _FaxAbort
                    state, param = lookup(main, FAX_MAIN_BITS, False)
                    if state == FAX_PASS:
                        check_b1()
                        if s["pb"] + 1 >= ref_end:
                            raise _FaxAbort
                        s["b1"] = _i32(s["b1"] + R[s["pb"]])
                        s["pb"] += 1
                        if use:
                            use()
                        s["rl"] = _i32(s["rl"] + s["b1"] - s["a0"])
                        s["a0"] = s["b1"]
                        s["b1"] = _i32(s["b1"] + R[s["pb"]])
                        s["pb"] += 1
                    elif state == FAX_HORIZ:
                        first, second = ((black, FAX_BLACK_BITS, FAX_TERMB), (white, FAX_WHITE_BITS, FAX_TERMW))
                        if not (s["pa"] - thisrun) & 1:
                            first, second = second, first
                        if run_colour(*first) != "done" or run_colour(*second) != "done":
                            break  # badBlack2d / badWhite2d: unexpected, eol2d
                        check_b1()
                    elif state in (FAX_V0, FAX_VR):
                        check_b1()
                        setvalue(s["b1"] - s["a0"] + (param if state == FAX_VR else 0))
                        if s["pb"] >= ref_end:
                            raise _FaxAbort
                        s["b1"] = _i32(s["b1"] + R[s["pb"]])
                        s["pb"] += 1
                    elif state == FAX_VL:
                        check_b1()
                        if s["b1"] < s["a0"] + param:
                            break  # unexpected, eol2d
                        setvalue(s["b1"] - s["a0"] - param)
                        if s["pb"] <= 0:  # before the run arrays (not pinned)
                            raise _FaxAbort
                        s["pb"] -= 1
                        s["b1"] = _i32(s["b1"] - R[s["pb"]])
                    elif state == FAX_EXT:
                        put(lastx - s["a0"])
                        break  # extension, eol2d
                    elif state == FAX_EOL:
                        put(lastx - s["a0"])
                        need(4, False)
                        clr(4)
                        st["eol"] = 1
                        break
                    else:
                        break  # badMain2d
                else:
                    if s["rl"]:
                        if s["rl"] + s["a0"] < lastx:
                            need(1, False)
                            if get(1):
                                clr(1)
                                setvalue(0)
                            # else badMain2d: unexpected, eol2d
                        else:
                            setvalue(0)
            except _FaxEOF:
                cleanup()
                raise
            cleanup()

        ref_end = ref + nruns
        try:
            try:
                if mode in (codec.FAX_RLE, codec.FAX_RLEW):
                    expand1d()
                elif mode == codec.FAX_G4:
                    s["pb"], s["b1"] = ref + 1, R[ref]
                    expand2d()
                    if st["eol"]:
                        raise _FaxEOF
                else:
                    try:  # SYNC_EOL
                        if not noeol:
                            if st["eol"] == 0:
                                while True:
                                    need(11, True)
                                    if get(11) == 0:
                                        break
                                    clr(1)
                            while True:
                                try:
                                    need(8, False)
                                except _FaxEOF:  # noEOLFound: again from the chunk's start, without EOLs
                                    noeol = True
                                    st.update(acc=0, avail=0, cp=0, eol=0)
                                    raise _FaxRetry from None
                                if get(8):
                                    break
                                clr(8)
                            while get(1) == 0:
                                clr(1)
                            clr(1)
                            st["eol"] = 0
                        is1d = True
                        if mode == codec.FAX_G3_2D:
                            need(1, False)
                            is1d = bool(get(1))
                            clr(1)
                    except _FaxEOF:
                        cleanup()
                        raise
                    s["pb"], s["b1"] = ref + 1, R[ref]
                    if is1d:
                        expand1d()
                    else:
                        expand2d()
            except _FaxEOF:
                if mode == codec.FAX_G4:  # EOFG4: the 13 bits of EOFB (or what is left), then the row
                    try:
                        need(13, True)
                    except _FaxEOF:
                        pass
                    clr(13)
                fill(row, R, thisrun, s["pa"], lastx)
                return noeol
        except _FaxAbort:
            return noeol
        except _FaxRetry:
            continue
        fill(row, R, thisrun, s["pa"], lastx)
        if mode == codec.FAX_RLE:
            clr(st["avail"] - (st["avail"] & ~7))
        elif mode == codec.FAX_RLEW:
            clr(st["avail"] - (st["avail"] & ~15))
            if st["avail"] == 0 and (st["cp"] + odd) & 1:
                st["cp"] += 1
        elif two_d:
            if mode == codec.FAX_G4 or s["pa"] < thisrun + nruns:
                setvalue(0)  # the imaginary change the next row's reference reads
            cur, ref = ref, cur
        line += 1
    return noeol


def thunder_decode(raw: bytes, rows: int, width: int, row_bytes: int, out: np.ndarray) -> None:
    """K11's ThunderScan flavour: tif_thunder.c's ThunderDecodeRow of one chunk into `out`
    (uint8, rows x row_bytes of 4-bit pixels, zero where nothing decodes), a row at a time
    from where the last one stopped, the last pixel 0 at each row's start: runs of it, two
    and three deltas a byte (their skip codes), raw nibbles; a run past the row's end writes
    none of its bytes; a row given too few or too many pixels is zero from the byte where
    it stopped and ends the chunk (cv2 reads the rest of the chunk as zero samples)."""
    two, three = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    cp, n = 0, len(raw)
    for line in range(rows):
        base = line * row_bytes
        op, last, npixels = base, 0, 0

        def setpixel(v):
            nonlocal last, npixels, op
            last = v & 0xF
            if npixels < width:
                if npixels & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npixels += 1

        while cp < n and npixels < width:
            b = raw[cp]
            cp += 1
            code = b & 0xC0
            if code == 0x00:  # a run of the last pixel, b & 63 long
                k = b & 0x3F
                if npixels & 1:
                    out[op] |= last
                    last = int(out[op])
                    op += 1
                    npixels += 1
                    k -= 1
                else:
                    last |= last << 4
                npixels += k
                if npixels <= width:
                    while k > 0:
                        out[op] = last
                        op += 1
                        k -= 2
                if k == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:
                for d in ((b >> 4) & 3, (b >> 2) & 3, b & 3):
                    if d != 2:
                        setpixel(last + two[d])
            elif code == 0x80:
                for d in ((b >> 3) & 7, b & 7):
                    if d != 4:
                        setpixel(last + three[d])
            else:
                setpixel(b)
        if npixels != width:
            out[op:base + (width + 1) // 2] = 0
            return


def ccitt_decode(data: np.ndarray, streams: np.ndarray, out: np.ndarray) -> np.ndarray:
    """K11 over a decode call's streams (codec.FAX_INTS rows: the coded bytes at their
    offset in `data`, each decoded into `out` at its byte, which is zero before): the
    CCITT flavours through fax_decode, an image's chunks in turn (the run arrays and the
    Group 3 decoder's FAXMODE_NOEOL carry from one to the next), ThunderScan through
    thunder_decode. Returns `out`."""
    noeol, runs = False, None  # an image's: libtiff keeps them from chunk to chunk
    for k, row in enumerate(streams.tolist()):
        src, nbytes, mode, rows, width, row_bytes, at, odd, first = (row[f] for f in (
            codec.F_SRC, codec.F_BYTES, codec.F_MODE, codec.F_ROWS, codec.F_WIDTH, codec.F_ROW_BYTES, codec.F_OUT,
            codec.F_ODD, codec.F_FIRST))
        if k == first:
            noeol, runs = False, None
        raw = bytes(data[src:src + nbytes])
        chunk = out[at:at + rows * row_bytes]
        if mode == codec.FAX_THUNDER:
            thunder_decode(raw, rows, width, row_bytes, chunk)
        else:
            runs = runs or [0] * codec.fax_scratch(mode, width)
            noeol = fax_decode(raw, mode, rows, width, row_bytes, odd, chunk, noeol, runs)
    return out


# ---------------------------------------------------------------------------- K12
def sgilog_rows(raw: bytes, rows: int, width: int, word: int) -> Tuple[np.ndarray, int]:
    """K12 on one SGILog chunk: tif_luv.c's LogL16Decode (word 2) or LogLuvDecode32
    (word 4), a row at a time from where the last one stopped: each row's byte planes, the
    highest first, each a run of control bytes (128 + n - 2: the next byte n times; n below
    128: the next n bytes; 0 a no-op), every pixel's word ORed from zero. -> (uint32 words
    (rows, width), the rows decoded): a row whose data runs out before a plane is whole
    fails, and it and the rest of the chunk stay zero (libtiff skips its conversion and
    decodes no more of the chunk)."""
    words = np.zeros((rows, width), np.uint32)
    bp, cc = 0, len(raw)
    for line in range(rows):
        tp = [0] * width
        for shft in range(8 * (word - 1), -1, -8):
            i = 0
            while i < width and cc > 0:
                if raw[bp] >= 128:  # a run
                    if cc < 2:
                        break
                    rc, b = raw[bp] + 2 - 128, raw[bp + 1] << shft
                    bp, cc = bp + 2, cc - 2
                    while rc and i < width:
                        tp[i] |= b
                        i, rc = i + 1, rc - 1
                else:  # bytes as they are: `while (--cc && rc-- && i < npixels)`
                    rc = raw[bp]
                    bp += 1
                    while True:
                        cc -= 1
                        if not cc or not rc:
                            break
                        rc -= 1
                        if i >= width:
                            break
                        tp[i] |= raw[bp] << shft
                        bp, i = bp + 1, i + 1
            if i != width:
                return words, line
        words[line] = tp
    return words, rows


def sgilog_decode(data: np.ndarray, streams: np.ndarray, out: np.ndarray) -> np.ndarray:
    """K12 over a decode call's streams (codec.SGI_INTS rows: the coded bytes at their
    offset in `data`, each chunk's words, little-endian, into `out` at its byte, which is
    zero before). Returns `out`."""
    for src, nbytes, word, rows, width, at in streams.tolist():
        words, _ = sgilog_rows(bytes(data[src:src + nbytes]), rows, width, word)
        out[at:at + rows * width * word] = words.astype("<u4").view(np.uint8).reshape(rows, width, 4)[
            ..., :word].reshape(-1)
    return out

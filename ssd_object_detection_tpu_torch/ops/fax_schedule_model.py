"""The numpy replay of K11's schedule (csrc/ccitt_decode.cu), held equal to
plain_image.ccitt_decode by tests/test_torch_image_schedules.py. No GPU.

libtiff's CCITT decoder keeps its two run arrays and FAXMODE_NOEOL from one chunk of an
image to the next, so a chunk's rows may depend on the chunks before it (a corrupt row
reading its reference line past the white line Fax3PreDecode sets, a Group 3 strip
without EOLs turning EOL-less decoding on for the rest). K11 decodes every chunk at once
from the state Fax3PreDecode gives a chunk (zero arrays, the reference line [lastx, 0],
FAXMODE_NOEOL off) and records what that guess relied on:

  - the entries of each array the chunk wrote (a row writes its array from the start, so
    this is a prefix of each: a high-water mark), and whether a value it read past them
    decided anything (`Tracked`);
  - the FAXMODE_NOEOL it leaves.

A chunk's guess failed where an entry it had not written decided something, or where its
predecessor leaves FAXMODE_NOEOL on; the chunks before the first such one are final
(their own state is exact: the first chunk's guess is the true state). From there the
image's chunks are decoded again in order from the true carried state: the prefixes the
chunks before it saved, laid over zero arrays in order, and the mode the last of them
left. ThunderScan chunks carry no state.

The rows are filled as K11's fill warps fill them (`kernel_fill`): an odd count padded
with a zero run; the runs cut at the row's width only where they do not sum to it;
their end positions by a prefix sum; each black run's bits ORed into a row of 32-bit
words; the row stored a 16-byte unit of the buffer's grid at a time (the first and last
may be partial, stored byte by byte).

`python -m ssd_object_detection_tpu_torch.ops.fax_schedule_model` prints, for each CCITT
fixture, its chunks and where its repair started.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import plain_image

UNIT = 16  # bytes a fill lane stores


class Tracked(list):
    """libtiff's run arrays (curruns at 0, refruns at `nruns`) recording the prefix of
    each that a chunk writes and whether a value read past what it had written decided
    something: a read of the reference array past the prefix written when the row
    started (or of the other array) taints the reference line's position b1 for the rest
    of its row, and plain_image.fax_decode calls `use` where b1's value is compared or
    kept (a row's last code may read one entry past its reference line, which then
    decides nothing)."""

    def __init__(self, size: int, nruns: int):
        super().__init__([0] * size)
        self.nruns = nruns
        self.high = [0, 0]
        self.foreign = False
        self.taint = False
        self.ref, self.ref_high = nruns, 0

    def start_row(self, thisrun: int):
        self.taint = False
        self.ref = self.nruns if thisrun == 0 else 0
        self.ref_high = self.high[1 if self.ref else 0]

    def use(self):
        self.foreign |= self.taint

    def _half(self, i: int):
        return (1, i - self.nruns) if i >= self.nruns else (0, i)

    def __setitem__(self, i, v):
        list.__setitem__(self, i, v)
        h, off = self._half(i)
        self.high[h] = max(self.high[h], off + 1)

    def __getitem__(self, i):
        if not 0 <= i - self.ref < self.ref_high:
            self.taint = True
        return list.__getitem__(self, i)


def kernel_fill(row: np.ndarray, runs: List[int], at: int, end: int, lastx: int, phase: Optional[int] = None
                ) -> None:
    """K11's fill of one row (plain_image.fill_runs' result, K11's way): `phase` the
    row's first byte's offset in the 16-byte grid (its address mod 16 by default)."""
    if (end - at) & 1:
        runs[end] = 0
        end += 1
    values = [list.__getitem__(runs, k) for k in range(at, end)]
    if sum(values) != lastx:  # the walker's cut, written back (the next row reads it)
        x = 0
        for j, run in enumerate(values):
            if plain_image._u32(x + run) > lastx or run > lastx:
                run = plain_image._u32(lastx - x)
                list.__setitem__(runs, at + j, run)
                values[j] = run
            x += run
    ends = np.cumsum(np.asarray(values, np.int64))  # each run's end pixel
    n = row.size
    words = np.zeros(-(-n // 4), np.uint32)  # the warp's row, pixel 32j at bit 31 of word j
    for k in range(1, len(values), 2):  # the black runs
        x0, x1 = int(ends[k - 1]), int(ends[k])
        for j in range(x0 >> 5, ((x1 - 1) >> 5) + 1 if x1 > x0 else x0 >> 5):
            l0, l1 = max(x0, 32 * j) - 32 * j, min(x1, 32 * j + 32) - 32 * j
            words[j] |= np.uint32(((0xFFFFFFFF >> l0) & ~(0xFFFFFFFF >> l1 if l1 < 32 else 0)) & 0xFFFFFFFF)
    staged = words.astype(">u4").view(np.uint8)[:n]  # memory order: pixel 0 the first byte's top bit
    phase = row.__array_interface__["data"][0] % UNIT if phase is None else phase
    for u0 in range(-phase, n, UNIT):  # the unit's first byte in the row (the first may start before it)
        lo, hi = max(u0, 0), min(n, u0 + UNIT)
        row[lo:hi] = staged[lo:hi]


def _chunk(data, s, out, noeol: bool, runs, fill) -> bool:
    src, nbytes, mode, rows, width, row_bytes, at, odd = (int(s[f]) for f in (
        codec.F_SRC, codec.F_BYTES, codec.F_MODE, codec.F_ROWS, codec.F_WIDTH, codec.F_ROW_BYTES, codec.F_OUT,
        codec.F_ODD))
    chunk = out[at:at + rows * row_bytes]
    return plain_image.fax_decode(bytes(data[src:src + nbytes]), mode, rows, width, row_bytes, odd, chunk, noeol,
                                  runs, fill)


def ccitt_schedule(data: np.ndarray, streams: np.ndarray, out: np.ndarray, fill=kernel_fill) -> Dict[int, dict]:
    """K11's schedule over a decode call's streams (plain_image.ccitt_decode's arguments):
    `out` as ccitt_decode leaves it. Returns, for each CCITT image (by its first stream),
    {"chunks", "repair_from": the chunk (0-based in the image) the repair started from or
    None, "foreign": the chunks whose guess read an entry it had not written, "noeol": the
    chunks that leave FAXMODE_NOEOL on}."""
    report = {}
    streams = np.asarray(streams)
    for first in sorted(set(streams[:, codec.F_FIRST].tolist())):
        group = streams[first:first + int(streams[first, codec.F_CHUNKS])]
        mode, width = int(group[0, codec.F_MODE]), int(group[0, codec.F_WIDTH])
        if mode == codec.FAX_THUNDER:
            for s in group:
                src, nbytes, rows, row_bytes, at = (int(s[f]) for f in (codec.F_SRC, codec.F_BYTES, codec.F_ROWS,
                                                                         codec.F_ROW_BYTES, codec.F_OUT))
                plain_image.thunder_decode(bytes(data[src:src + nbytes]), rows, width, row_bytes,
                                           out[at:at + rows * row_bytes])
            continue
        size = codec.fax_scratch(mode, width)
        nruns = (size - 8) // 2
        guesses = []
        for s in group:  # every chunk from the state Fax3PreDecode gives a chunk
            R = Tracked(size, nruns)
            noeol = _chunk(data, s, out, False, R, fill)
            foreign = R.foreign and mode in (codec.FAX_G3_2D, codec.FAX_G4)  # a 1-D row reads no reference line
            guesses.append((foreign, noeol, list(R.high), list.__getitem__(R, slice(None))))
        kf = next((j for j in range(1, len(group)) if guesses[j][0] or guesses[j - 1][1]), None)
        report[first] = {"chunks": len(group), "repair_from": kf,
                         "foreign": [j for j, g in enumerate(guesses) if g[0]],
                         "noeol": [j for j, g in enumerate(guesses) if g[1]]}
        if kf is None:
            continue
        R = [0] * size  # the true state before chunk kf: the saved prefixes in order
        if mode in (codec.FAX_G3_2D, codec.FAX_G4):
            for _, _, (h0, h1), saved in guesses[:kf]:
                R[:h0] = saved[:h0]
                R[nruns:nruns + h1] = saved[nruns:nruns + h1]
        noeol = guesses[kf - 1][1]
        for s in group[kf:]:
            at, rows, row_bytes = int(s[codec.F_OUT]), int(s[codec.F_ROWS]), int(s[codec.F_ROW_BYTES])
            out[at:at + rows * row_bytes] = 0
            noeol = _chunk(data, s, out, noeol, R, fill)
    return report


def _main(argv=None) -> None:
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES

    for name in sorted(os.listdir(FIXTURES)):
        if not name.startswith("tiff_ccitt_"):
            continue
        try:
            tiff = codec.parse_tiff(open(os.path.join(FIXTURES, name), "rb").read())
        except ValueError:
            continue
        batch = codec.raw_batch([], [tiff], [])
        buf = batch.host.copy()
        buf.resize(batch.total, refcheck=False)
        for first, r in ccitt_schedule(buf, batch.fax_streams, buf).items():
            print(f"{name}: {r['chunks']} chunks, repair from {r['repair_from']} (guesses that read past their own "
                  f"runs: {r['foreign']}; chunks leaving FAXMODE_NOEOL on: {r['noeol']})")


if __name__ == "__main__":
    _main(sys.argv[1:])

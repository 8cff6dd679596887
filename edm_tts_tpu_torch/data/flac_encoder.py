"""A minimal lossless FLAC encoder, numpy only (a copy of
tests/flac_encoder.py, pinned equal to it in tests/test_torch_closed_loop.py).

The closed-loop rehearsal writes its LibriSpeech-layout set with it, and
``chip_smoke.py`` its seeded audio. Covers every subframe type (constant,
verbatim, fixed-predictor, LPC), Rice/Rice2 residual partitions incl. the
escape path, and all stereo decorrelation modes."""

from __future__ import annotations

import numpy as np


class BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        assert bits >= 0
        value &= (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.bytes)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _utf8_number(bw: BitWriter, n: int):
    if n < 0x80:
        bw.write(n, 8)
    elif n < 0x800:
        bw.write(0xC0 | (n >> 6), 8)
        bw.write(0x80 | (n & 0x3F), 8)
    else:
        bw.write(0xE0 | (n >> 12), 8)
        bw.write(0x80 | ((n >> 6) & 0x3F), 8)
        bw.write(0x80 | (n & 0x3F), 8)


def _rice_encode(bw: BitWriter, residual: np.ndarray, param: int,
                 use_rice2: bool = False, escape: bool = False):
    """One partition-order-0 residual section."""
    bw.write(1 if use_rice2 else 0, 2)  # method
    bw.write(0, 4)  # partition order 0
    pbits = 5 if use_rice2 else 4
    if escape:
        bw.write((1 << pbits) - 1, pbits)
        raw = int(np.abs(residual).max()).bit_length() + 1 if len(residual) else 1
        raw = max(raw, 1)
        bw.write(raw, 5)
        for v in residual:
            bw.write_signed(int(v), raw)
    else:
        bw.write(param, pbits)
        for v in residual:
            v = int(v)
            u = (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1
            bw.write_unary(u >> param)
            bw.write(u & ((1 << param) - 1), param)


FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int, kind: str,
                     **kw):
    bw.write(0, 1)  # padding
    if kind == "constant":
        bw.write(0, 6)
        bw.write(0, 1)  # no wasted bits
        bw.write_signed(int(x[0]), bps)
    elif kind == "verbatim":
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x:
            bw.write_signed(int(v), bps)
    elif kind == "fixed":
        order = kw.get("order", 2)
        bw.write(8 | order, 6)
        bw.write(0, 1)
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        coefs = FIXED_COEFS[order]
        res = np.array(
            [
                int(x[i]) - sum(c * int(x[i - 1 - j]) for j, c in enumerate(coefs))
                for i in range(order, len(x))
            ],
            dtype=np.int64,
        )
        _rice_encode(bw, res, kw.get("param", 10), kw.get("rice2", False),
                     kw.get("escape", False))
    elif kind == "lpc":
        order = kw.get("order", 2)
        coefs = kw["coefs"]  # list of ints
        shift = kw.get("shift", 5)
        precision = kw.get("precision", 12)
        bw.write(32 | (order - 1), 6)
        bw.write(0, 1)
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in coefs:
            bw.write_signed(int(c), precision)
        res = np.array(
            [
                int(x[i])
                - (sum(int(c) * int(x[i - 1 - j]) for j, c in enumerate(coefs))
                   >> shift)
                for i in range(order, len(x))
            ],
            dtype=np.int64,
        )
        _rice_encode(bw, res, kw.get("param", 10), kw.get("rice2", False),
                     kw.get("escape", False))
    else:
        raise ValueError(kind)


def encode_flac(
    channels: np.ndarray,
    sample_rate: int = 16000,
    bps: int = 16,
    blocksize: int = 1024,
    subframe_kind: str = "fixed",
    stereo_mode: str = "independent",
    seek_every_frames: int | None = None,
    **kw,
) -> bytes:
    """``channels``: (C, T) int array. Returns a complete FLAC stream.

    ``seek_every_frames``: write a SEEKTABLE metadata block with one seek
    point every N frames (as the stock flac encoder does every 10 s) —
    exercises the native decoder's seektable fast path.
    """
    channels = np.asarray(channels, dtype=np.int64)
    nch, total = channels.shape

    n_points = 0
    if seek_every_frames:
        n_frames_total = -(-total // blocksize)
        n_points = -(-n_frames_total // seek_every_frames)

    bw = BitWriter()
    bw.bytes += b"fLaC"
    # STREAMINFO (last metadata block unless a SEEKTABLE follows)
    bw.write((0x00 if n_points else 0x80) | 0, 8)
    bw.write(34, 24)
    bw.write(blocksize, 16)
    bw.write(blocksize, 16)
    bw.write(0, 24)
    bw.write(0, 24)
    bw.write(sample_rate, 20)
    bw.write(nch - 1, 3)
    bw.write(bps - 1, 5)
    bw.write(total, 36)
    for _ in range(16):
        bw.write(0, 8)

    entries_off = None
    if n_points:
        bw.write(0x80 | 3, 8)  # SEEKTABLE, last metadata block
        bw.write(n_points * 18, 24)
        entries_off = len(bw.bytes)
        for _ in range(n_points):  # placeholder points (sample = all ones)
            bw.bytes += b"\xff" * 8 + b"\x00" * 10

    audio_offset = len(bw.bytes)
    seek_entries: list[tuple[int, int, int]] = []

    chan_code = {"independent": nch - 1, "left_side": 8, "right_side": 9,
                 "mid_side": 10}[stereo_mode]

    frame_no = 0
    pos = 0
    while pos < total:
        n = min(blocksize, total - pos)
        block = channels[:, pos : pos + n]
        if (seek_every_frames and frame_no % seek_every_frames == 0
                and len(seek_entries) < n_points):
            seek_entries.append((pos, len(bw.bytes) - audio_offset, n))
        hstart = len(bw.bytes)
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocksize strategy
        bw.write(7, 4)  # 16-bit blocksize-1 follows
        bw.write(0, 4)  # sample rate from STREAMINFO
        bw.write(chan_code, 4)
        bw.write(4, 3)  # 16-bit samples
        bw.write(0, 1)
        _utf8_number(bw, frame_no)
        bw.write(n - 1, 16)
        bw.write(_crc8(bytes(bw.bytes[hstart:])), 8)  # real header CRC-8

        if stereo_mode == "independent":
            subs = [(block[c], bps) for c in range(nch)]
        elif stereo_mode == "left_side":
            subs = [(block[0], bps), (block[0] - block[1], bps + 1)]
        elif stereo_mode == "right_side":
            subs = [(block[0] - block[1], bps + 1), (block[1], bps)]
        else:  # mid_side
            mid = (block[0] + block[1]) >> 1
            side = block[0] - block[1]
            subs = [(mid, bps), (side, bps + 1)]

        for x, ch_bps in subs:
            _encode_subframe(bw, x, ch_bps, subframe_kind, **kw)
        bw.align()
        bw.write(0, 16)  # CRC-16 (decoder does not verify)
        pos += n
        frame_no += 1

    data = bytearray(bw.getvalue())
    if entries_off is not None:
        for i, (sample, off, bsz) in enumerate(seek_entries):
            e = entries_off + i * 18
            data[e : e + 8] = sample.to_bytes(8, "big")
            data[e + 8 : e + 16] = off.to_bytes(8, "big")
            data[e + 16 : e + 18] = bsz.to_bytes(2, "big")
    return bytes(data)

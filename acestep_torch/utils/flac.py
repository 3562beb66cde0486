"""Native FLAC codec (encoder + decoder), no external dependencies.

The reference's default export format is FLAC, produced there through
ffmpeg/soundfile. This implements the format directly so lossless export
works without ffmpeg: 16-bit PCM, fixed-prediction subframes (orders
0-4, chosen per subframe by residual magnitude), rice-coded residuals
(partition order 0), CONSTANT subframes for silence, CRC-8/CRC-16 frame
integrity, and the STREAMINFO MD5 of the unencoded signal.

A small C kernel (native/flacenc.c, compiled on demand with the system
compiler and loaded via ctypes) accelerates the bit-level hot loops (rice
pack/unpack + CRC); a pure-numpy/Python path produces identical bytes when
no compiler is available.

The decoder exists for loading .flac inputs back (utils/audio.load_audio)
and as the encoder's adversarial check: it re-derives everything from the
bitstream and verifies both CRCs and the MD5, so encoder/decoder bugs
cannot cancel out silently unless they are exactly symmetric; golden-byte
tests pin the emitted format against regressions. The decoder covers the
full 16-bit feature surface real-world encoders emit (libFLAC/ffmpeg):
LPC subframes up to order 32 (C kernel for the sequential IIR), FIXED,
CONSTANT, VERBATIM, wasted bits, all rice partition orders, and
left/side / right/side / mid/side stereo decorrelation.

Format reference: https://xiph.org/flac/format.html (RFC 9639).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

BLOCK_SIZE = 4096

# ---------------------------------------------------------------------------
# CRCs (FLAC frame integrity): CRC-8 poly 0x07, CRC-16 poly 0x8005, init 0
# ---------------------------------------------------------------------------


def _make_crc8_table() -> np.ndarray:
    table = np.zeros(256, np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07 if c & 0x80 else c << 1) & 0xFF
        table[i] = c
    return table


def _make_crc16_table() -> np.ndarray:
    table = np.zeros(256, np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005 if c & 0x8000 else c << 1) & 0xFFFF
        table[i] = c
    return table


_CRC8_TABLE = _make_crc8_table()
_CRC16_TABLE = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8_TABLE[c ^ b])
    return c


def crc16(data: bytes) -> int:
    from acestep_torch.utils.flac_native import native_crc16

    if native_crc16 is not None:
        return native_crc16(data)
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16_TABLE[((c >> 8) ^ b) & 0xFF])
    return c


# ---------------------------------------------------------------------------
# Bit IO (FLAC packs bits MSB-first)
# ---------------------------------------------------------------------------


class BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0          # pending bits, MSB side
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        # FLAC unary: q zero bits then a single 1 bit
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0, "unaligned"
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.bitpos = pos * 8

    def read(self, bits: int) -> int:
        out = 0
        for _ in range(bits):
            byte = self.data[self.bitpos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.bitpos & 7))) & 1)
            self.bitpos += 1
        return out

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7


# ---------------------------------------------------------------------------
# Fixed predictors
# ---------------------------------------------------------------------------


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _best_fixed_order(x: np.ndarray) -> Tuple[int, np.ndarray]:
    best_order, best_res, best_cost = 0, x.astype(np.int64), None
    max_order = min(4, len(x) - 1)
    r = x.astype(np.int64)
    for order in range(0, max_order + 1):
        if order > 0:
            r = np.diff(r)
        cost = int(np.abs(r).sum())
        if best_cost is None or cost < best_cost:
            best_order, best_res, best_cost = order, r, cost
    return best_order, best_res


def _best_rice_param(u: np.ndarray) -> int:
    n = len(u)
    if n == 0:
        return 0
    best_p, best_cost = 0, None
    total = int(u.sum())
    for p in range(15):
        # bits = sum(u >> p) + n * (p + 1)
        cost = int((u >> p).sum()) + n * (p + 1)
        if best_cost is None or cost < best_cost:
            best_p, best_cost = p, cost
        if total >> p == 0:
            break
    return best_p


def _write_residual(bw: BitWriter, res: np.ndarray) -> None:
    """Rice-coded residual, partition order 0, 4-bit params."""
    u = (res << 1) ^ (res >> 63)            # zigzag (int64 arithmetic shift)
    u = u.astype(np.uint64)
    param = _best_rice_param(u)
    bw.write(0, 2)                          # method: rice, 4-bit params
    bw.write(0, 4)                          # partition order 0
    bw.write(param, 4)

    from acestep_torch.utils.flac_native import native_rice_encode

    if native_rice_encode is not None and len(u):
        native_rice_encode(bw, u, param)
        return
    mask = (1 << param) - 1
    for v in u.tolist():
        bw.write_unary(v >> param)
        if param:
            bw.write(v & mask, param)


def _read_residual(br: BitReader, n: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError(f"unsupported residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    parts = 1 << part_order
    out = np.empty(n, np.int64)
    idx = 0
    total = n + order                       # samples incl. warmup
    for p in range(parts):
        count = total // parts - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            width = br.read(5)
            for i in range(count):
                out[idx + i] = br.read_signed(width) if width else 0
        else:
            from acestep_torch.utils.flac_native import native_rice_decode

            if native_rice_decode is not None and count:
                vals, bitpos = native_rice_decode(
                    br.data, br.bitpos, count, param)
                br.bitpos = bitpos
                u = vals
            else:
                u = np.empty(count, np.uint64)
                for i in range(count):
                    q = br.read_unary()
                    u[i] = (q << param) | br.read(param)
            s = u.astype(np.int64)
            out[idx: idx + count] = (s >> 1) ^ -(s & 1)   # un-zigzag
        idx += count
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _utf8_number(bw: BitWriter, val: int) -> None:
    """FLAC's UTF-8-style frame-number coding."""
    if val < 0x80:
        bw.write(val, 8)
        return
    # count how many continuation bytes are needed
    for nbytes, cap in ((2, 1 << 11), (3, 1 << 16), (4, 1 << 21),
                        (5, 1 << 26), (6, 1 << 31), (7, 1 << 36)):
        if val < cap:
            break
    lead_bits = 7 - nbytes
    bw.write((0xFF >> (lead_bits + 1) << (lead_bits + 1)) >> 0 |
             (val >> (6 * (nbytes - 1))), 8)
    for i in range(nbytes - 2, -1, -1):
        bw.write(0x80 | ((val >> (6 * i)) & 0x3F), 8)


def _read_utf8_number(br: BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    val = first & (mask - 1)
    for _ in range(nbytes - 1):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int) -> None:
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0b000000, 6)               # CONSTANT
        bw.write(0, 1)
        bw.write(int(x[0]) & ((1 << bps) - 1), bps)
        return
    order, res = _best_fixed_order(x)
    bw.write(0, 1)
    bw.write(0b001000 | order, 6)           # FIXED, order 0-4
    bw.write(0, 1)                          # no wasted bits
    for w in x[:order].tolist():            # warmup, raw signed
        bw.write(int(w) & ((1 << bps) - 1), bps)
    _write_residual(bw, res)


def encode_flac(samples: np.ndarray, sample_rate: int,
                block_size: int = BLOCK_SIZE) -> bytes:
    """samples: (n,) or (n, channels) int16 -> FLAC stream bytes."""
    x = np.asarray(samples)
    if x.dtype != np.int16:
        raise TypeError("encode_flac expects int16 samples")
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    if n == 0:
        raise ValueError("encode_flac requires at least one sample")
    if not 1 <= ch <= 8:
        raise ValueError(f"unsupported channel count {ch}")
    bps = 16

    md5 = hashlib.md5(x.astype("<i2").tobytes()).digest()

    # ---- stream header ----
    out = bytearray(b"fLaC")
    info = BitWriter()
    info.write(block_size, 16)              # min block size
    info.write(block_size, 16)              # max block size
    info.write(0, 24)                       # min frame size (unknown)
    info.write(0, 24)                       # max frame size (unknown)
    info.write(sample_rate, 20)
    info.write(ch - 1, 3)
    info.write(bps - 1, 5)
    info.write(n, 36)
    streaminfo = info.getvalue() + md5
    out += bytes([0x80, 0, 0, len(streaminfo)])   # last-block, type 0
    out += streaminfo

    # ---- frames ----
    for frame_idx in range(max(1, -(-n // block_size))):
        block = x[frame_idx * block_size: (frame_idx + 1) * block_size]
        nb = len(block)
        bw = BitWriter()
        bw.write(0b11111111111110, 14)      # sync
        bw.write(0, 1)                      # reserved
        bw.write(0, 1)                      # fixed blocksize strategy
        bw.write(0b0111, 4)                 # blocksize: 16-bit at end
        bw.write(0b0000, 4)                 # sample rate: from STREAMINFO
        bw.write(ch - 1, 4)                 # independent channels
        bw.write(0b100, 3)                  # 16 bps
        bw.write(0, 1)                      # reserved
        _utf8_number(bw, frame_idx)
        bw.write(nb - 1, 16)
        assert bw.nbits == 0                # header fields are byte-aligned
        bw.write(crc8(bytes(bw.buf)), 8)

        for c in range(ch):
            _encode_subframe(bw, block[:, c].astype(np.int64), bps)
        bw.align()
        frame = bytes(bw.buf)
        out += frame + struct.pack(">H", crc16(frame))

    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24}


def _lpc_reconstruct(warmup: np.ndarray, res: np.ndarray,
                     coefs: np.ndarray, shift: int) -> np.ndarray:
    """Invert an LPC subframe: s[i] = res[i] + (sum c[j]*s[i-1-j]) >> shift.

    Inherently sequential (IIR with integer truncation each step, so no
    float shortcut is bit-exact); the C kernel runs it at memory speed,
    the Python loop is the no-compiler fallback."""
    order = len(warmup)
    s = np.concatenate([warmup, res]).astype(np.int64)
    from acestep_torch.utils.flac_native import native_lpc_reconstruct

    if native_lpc_reconstruct is not None and len(s) > order:
        native_lpc_reconstruct(s, coefs, order, shift)
        return s
    c = [int(v) for v in coefs]
    buf = [int(v) for v in s]
    for i in range(order, len(buf)):
        pred = 0
        for j in range(order):
            pred += c[j] * buf[i - 1 - j]
        buf[i] += pred >> shift
    return np.asarray(buf, np.int64)


def _fixed_reconstruct(warmup: np.ndarray, res: np.ndarray,
                       order: int) -> np.ndarray:
    """Invert the order-k fixed predictor: the residual of a FIXED subframe
    is exactly the k-th finite difference of the signal, so reconstruction
    is k rounds of cumulative summation seeded from the warmup samples."""
    seq = res.astype(np.int64)
    warm = warmup.astype(np.int64)
    for k in range(order, 0, -1):
        first = np.diff(warm, n=k - 1)[0]
        seq = np.cumsum(np.concatenate([np.array([first], np.int64), seq]))
    return seq


def _decode_subframe(br: BitReader, nb: int, sf_bps: int) -> np.ndarray:
    """One subframe -> (nb,) int64. Supports CONSTANT/VERBATIM/FIXED/LPC
    plus wasted bits (RFC 9639 §9.2.1-9.2.5) — everything a spec-conforming
    encoder (libFLAC, ffmpeg) emits for 16-bit streams."""
    if br.read(1):
        raise ValueError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):                           # wasted-bits flag: k-1 unary
        wasted = br.read_unary() + 1
        sf_bps -= wasted
    if stype == 0:                           # CONSTANT
        out = np.full(nb, br.read_signed(sf_bps), np.int64)
    elif stype == 1:                         # VERBATIM
        out = np.array([br.read_signed(sf_bps) for _ in range(nb)],
                       np.int64)
    elif 8 <= stype <= 12:                   # FIXED, order 0-4
        order = stype - 8
        warm = np.array([br.read_signed(sf_bps) for _ in range(order)],
                        np.int64)
        res = _read_residual(br, nb - order, order)
        out = _fixed_reconstruct(warm, res, order)
    elif stype >= 32:                        # LPC, order 1-32
        order = (stype & 0x1F) + 1
        warm = np.array([br.read_signed(sf_bps) for _ in range(order)],
                        np.int64)
        precision = br.read(4)
        if precision == 0b1111:
            raise ValueError("invalid LPC coefficient precision")
        precision += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = np.array([br.read_signed(precision) for _ in range(order)],
                         np.int64)
        res = _read_residual(br, nb - order, order)
        out = _lpc_reconstruct(warm, res, coefs, shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    return out << wasted if wasted else out


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC stream -> ((n, channels) int16, sample_rate). Verifies frame
    CRCs and the STREAMINFO MD5; raises ValueError on any mismatch
    (including truncated streams)."""
    try:
        return _decode_flac(data)
    except IndexError as e:
        # BitReader / header slicing run past EOF on truncated input —
        # surface it as the same error class as every other corruption
        # (load_audio's ffmpeg fallback and callers catch ValueError)
        raise ValueError("truncated FLAC stream") from e
    except KeyError as e:
        # reserved table codes (e.g. frame blocksize code 0) index dict
        # tables — same contract: corrupt stream == ValueError
        raise ValueError(f"invalid FLAC stream (reserved code {e})") from e


def _decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = total = None
    md5_expect = None
    while True:
        header = data[pos: pos + 4]
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:
            br = BitReader(body)
            br.read(16)
            br.read(16)
            br.read(24)
            br.read(24)
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5_expect = body[18:34]
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")
    if bps != 16:
        raise ValueError(f"decoder supports 16-bit only, got {bps}")

    frames: List[np.ndarray] = []
    got = 0
    while got < total:
        frame_start = pos
        br = BitReader(data, pos)
        if br.read(14) != 0b11111111111110:
            raise ValueError(f"lost frame sync at byte {pos}")
        br.read(1)
        br.read(1)                           # blocking strategy
        bs_code = br.read(4)
        rate_code = br.read(4)
        chan_code = br.read(4)
        bps_code = br.read(3)
        br.read(1)
        _frame_no = _read_utf8_number(br)
        if bs_code == 6:
            nb = br.read(8) + 1
        elif bs_code == 7:
            nb = br.read(16) + 1
        else:
            nb = _BLOCKSIZE_TABLE[bs_code]
        if rate_code == 12:
            br.read(8)
        elif rate_code in (13, 14):
            br.read(16)
        header_len = br.bitpos // 8 - frame_start
        expect_crc8 = br.read(8)
        if crc8(data[frame_start: frame_start + header_len]) != expect_crc8:
            raise ValueError("frame header CRC-8 mismatch")
        if chan_code > 10:
            raise ValueError(f"reserved channel assignment {chan_code}")
        decorr = chan_code if chan_code >= 8 else None
        nch = 2 if decorr is not None else chan_code + 1
        frame_bps = _BPS_TABLE.get(bps_code, bps)

        chans = []
        for c in range(nch):
            # the side channel of a decorrelated pair carries one extra bit
            # (left/side: ch1 is side; right/side: ch0; mid/side: ch1)
            side = decorr is not None and c == {8: 1, 9: 0, 10: 1}[decorr]
            chans.append(_decode_subframe(br, nb, frame_bps + (1 if side
                                                               else 0)))
        if decorr == 8:                      # left/side: R = L - side
            chans = [chans[0], chans[0] - chans[1]]
        elif decorr == 9:                    # right/side: L = R + side
            chans = [chans[1] + chans[0], chans[1]]
        elif decorr == 10:                   # mid/side
            m2 = (chans[0] << 1) | (chans[1] & 1)
            chans = [(m2 + chans[1]) >> 1, (m2 - chans[1]) >> 1]
        br.align()
        body_len = br.bitpos // 8 - frame_start
        expect_crc16 = int.from_bytes(
            data[frame_start + body_len: frame_start + body_len + 2], "big")
        if crc16(data[frame_start: frame_start + body_len]) != expect_crc16:
            raise ValueError("frame CRC-16 mismatch")
        pos = frame_start + body_len + 2
        frames.append(np.stack(chans, axis=1))
        got += nb

    audio = np.concatenate(frames, axis=0)[:total]
    if md5_expect and md5_expect != b"\0" * 16:
        if hashlib.md5(audio.astype("<i2").tobytes()).digest() != md5_expect:
            raise ValueError("decoded audio MD5 mismatch")
    return audio.astype(np.int16), sample_rate

"""FLAC decoding and encoding.

Own copy of the JAX package's ``silent_speech_tpu/utils/flac.py``. The
reference dataset stores audio as ``{i}_audio_clean.flac`` read through
libsndfile (``data_utils.py:64-65``); the port carries its own decoders.
``read_flac`` decodes through the port's native library
(``native/flac_codec.cc``, built at first use by ``utils/native.py``);
``read_flac_bytes`` is the same decoder in pure Python, the plain version
the tests hold the native one to. Both cover what standard encoders write:
constant, verbatim, fixed and LPC subframes, Rice and Rice2 residual
partitions, left/right/mid-side stereo, 8 to 24 bits. Samples come back as
float64 in [-1, 1), (frames,) for mono and (frames, channels) otherwise.
``write_flac`` encodes with fixed order-2 prediction and one Rice
partition (verbatim for blocks of 4 samples or fewer), byte for byte as
the JAX package's encoder does; the synthetic corpus writes its audio
with it. A stream cut short raises ``ValueError`` in both decoders.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import native


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte_pos = pos
        self.bit_pos = 0  # bits consumed within current byte

    def read_bits(self, n: int) -> int:
        """Read n bits MSB-first as an unsigned int."""
        result = 0
        while n > 0:
            byte = self.data[self.byte_pos]
            avail = 8 - self.bit_pos
            take = min(n, avail)
            shift = avail - take
            bits = (byte >> shift) & ((1 << take) - 1)
            result = (result << take) | bits
            self.bit_pos += take
            if self.bit_pos == 8:
                self.bit_pos = 0
                self.byte_pos += 1
            n -= take
        return result

    def read_signed(self, n: int) -> int:
        v = self.read_bits(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count zero bits until (and consuming) the first 1 bit."""
        count = 0
        while True:
            byte = self.data[self.byte_pos]
            remaining = byte & ((1 << (8 - self.bit_pos)) - 1)
            if remaining == 0:
                count += 8 - self.bit_pos
                self.bit_pos = 0
                self.byte_pos += 1
                continue
            msb = remaining.bit_length()  # position of highest set bit
            zeros = (8 - self.bit_pos) - msb
            count += zeros
            self.bit_pos += zeros + 1
            if self.bit_pos >= 8:
                self.bit_pos -= 8
                self.byte_pos += 1
            return count

    def align_to_byte(self) -> None:
        if self.bit_pos:
            self.bit_pos = 0
            self.byte_pos += 1

    def read_utf8_number(self) -> int:
        first = self.read_bits(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        value = first & (mask - 1)
        for _ in range(n_extra):
            value = (value << 6) | (self.read_bits(8) & 0x3F)
        return value


_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
    15: 32768,
}
_SAMPLE_RATE_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
    8: 32000, 9: 44100, 10: 48000, 11: 96000,
}


def _decode_residual(br: BitReader, blocksize: int, predictor_order: int
                     ) -> List[int]:
    method = br.read_bits(2)
    if not (method in (0, 1)):
        raise ValueError(f"bad residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_bits(4)
    n_partitions = 1 << partition_order
    residual: List[int] = []
    samples_per_partition = blocksize >> partition_order
    for p in range(n_partitions):
        count = samples_per_partition - (predictor_order if p == 0 else 0)
        param = br.read_bits(param_bits)
        if param == escape:
            raw_bits = br.read_bits(5)
            if raw_bits == 0:
                residual.extend([0] * count)
            else:
                residual.extend(br.read_signed(raw_bits) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read_bits(param) if param else 0
                v = (q << param) | r
                residual.append((v >> 1) ^ -(v & 1))  # un-zigzag
    return residual


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_subframe(br: BitReader, blocksize: int, bps: int) -> np.ndarray:
    pad = br.read_bits(1)
    if not (pad == 0):
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read_bits(6)
    wasted = 0
    if br.read_bits(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        value = br.read_signed(bps)
        out = np.full(blocksize, value, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(blocksize)],
                       dtype=np.int64)
    elif 8 <= sf_type <= 12:  # FIXED, order = type - 8
        order = sf_type - 8
        warmup = [br.read_signed(bps) for _ in range(order)]
        residual = _decode_residual(br, blocksize, order)
        coeffs = _FIXED_COEFFS[order]
        samples = list(warmup)
        for res in residual:
            pred = 0
            for c, co in enumerate(coeffs):
                pred += co * samples[-1 - c]
            samples.append(pred + res)
        out = np.array(samples, dtype=np.int64)
    elif sf_type >= 32:  # LPC, order = type - 31
        order = sf_type - 31
        warmup = [br.read_signed(bps) for _ in range(order)]
        precision = br.read_bits(4) + 1
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, blocksize, order)
        samples = list(warmup)
        for res in residual:
            pred = 0
            for c in range(order):
                pred += coeffs[c] * samples[-1 - c]
            samples.append((pred >> shift) + res)
        out = np.array(samples, dtype=np.int64)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        out = out << wasted
    return out


def _decode_frame(data: bytes, pos: int, stream_bps: int,
                  stream_channels: int, stream_rate: int
                  ) -> Tuple[np.ndarray, int]:
    br = BitReader(data, pos)
    sync = br.read_bits(14)
    if not (sync == 0b11111111111110):
        raise ValueError(f"bad frame sync at byte {pos}")
    br.read_bits(1)  # reserved
    br.read_bits(1)  # blocking strategy
    bs_code = br.read_bits(4)
    sr_code = br.read_bits(4)
    ch_assign = br.read_bits(4)
    ss_code = br.read_bits(3)
    br.read_bits(1)  # reserved
    br.read_utf8_number()  # frame or sample number

    if bs_code == 6:
        blocksize = br.read_bits(8) + 1
    elif bs_code == 7:
        blocksize = br.read_bits(16) + 1
    else:
        blocksize = _BLOCKSIZE_TABLE[bs_code]

    if sr_code == 12:
        br.read_bits(8)
    elif sr_code in (13, 14):
        br.read_bits(16)

    bps_table = {0: stream_bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24}
    bps = bps_table[ss_code]
    br.read_bits(8)  # CRC-8 (not verified)

    if ch_assign < 8:
        n_channels = ch_assign + 1
        chans = [_decode_subframe(br, blocksize, bps)
                 for _ in range(n_channels)]
    elif ch_assign == 8:  # left/side
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, left - side]
    elif ch_assign == 9:  # right/side
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [right + side, right]
    elif ch_assign == 10:  # mid/side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        left = ((mid << 1) | (side & 1)) + side
        chans = [left >> 1, (left - (side << 1)) >> 1]
        chans = [chans[0], chans[1]]
    else:
        raise ValueError(f"reserved channel assignment {ch_assign}")

    br.align_to_byte()
    br.byte_pos += 2  # CRC-16
    block = np.stack(chans, axis=1)
    return block, br.byte_pos


def read_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes → (samples, sample rate), in Python. A stream that ends
    inside a block, or before STREAMINFO's sample count, raises
    ``ValueError("truncated FLAC stream")``."""
    try:
        return _read_flac_bytes(data)
    except IndexError as e:
        raise ValueError("truncated FLAC stream") from e


def _read_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    if not (data[:4] == b"fLaC"):
        raise ValueError("not a FLAC file")
    pos = 4
    sample_rate = bps = n_channels = total_samples = None
    while True:
        header = data[pos]
        last = bool(header & 0x80)
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = BitReader(body)
            br.read_bits(16)  # min blocksize
            br.read_bits(16)  # max blocksize
            br.read_bits(24)  # min framesize
            br.read_bits(24)  # max framesize
            sample_rate = br.read_bits(20)
            n_channels = br.read_bits(3) + 1
            bps = br.read_bits(5) + 1
            total_samples = br.read_bits(36)
        pos += 4 + length
        if last:
            break

    if not (sample_rate is not None):
        raise ValueError("missing STREAMINFO")
    blocks = []
    decoded = 0
    while pos < len(data) - 2:
        block, pos = _decode_frame(data, pos, bps, n_channels, sample_rate)
        if pos > len(data):  # the frame's CRC-16 lies past the end
            raise ValueError("truncated FLAC stream")
        blocks.append(block)
        decoded += block.shape[0]
        if total_samples and decoded >= total_samples:
            break
    if total_samples and decoded < total_samples:
        raise ValueError("truncated FLAC stream")
    samples = np.concatenate(blocks, axis=0)
    if total_samples:
        samples = samples[:total_samples]
    scale = float(1 << (bps - 1))
    audio = samples.astype(np.float64) / scale
    if audio.shape[1] == 1:
        audio = audio[:, 0]
    return audio, sample_rate


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC file → (samples, sample rate), through the native decoder. A
    file that is not FLAC, or ends inside a block or before its last
    sample, raises ``ValueError``; a failed build of the native library
    raises ``RuntimeError``."""
    return native.read_flac(path)


# ---------------------------------------------------------------------------
# Encoder (verbatim / fixed-order-2 subframes)
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, value: int) -> None:
        while value >= 32:
            self.write_bits(0, 32)
            value -= 32
        self.write_bits(1, value + 1)

    def align(self) -> None:
        if self.nbits:
            self.write_bits(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        if self.nbits:
            raise ValueError(f"{self.nbits} bits left over: align() first")
        return bytes(self.bytes)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(value: int) -> bytes:
    """UTF-8-style number coding used in FLAC frame headers.

    A k-byte coding (k >= 2) holds 7-k lead bits + 6 bits per continuation
    byte = 1 + 5k value bits.
    """
    if value < 0x80:
        return bytes([value])
    k = 2
    while value >= (1 << (1 + 5 * k)) and k < 7:
        k += 1
    out = [((0xFF << (8 - k)) & 0xFF) | (value >> (6 * (k - 1)))]
    for i in range(k - 2, -1, -1):
        out.append(0x80 | ((value >> (6 * i)) & 0x3F))
    return bytes(out)


def _write_rice(bw: BitWriter, residual: np.ndarray) -> None:
    """Single-partition Rice coding with a simple parameter estimate."""
    zz = np.where(residual >= 0, residual.astype(np.int64) * 2,
                  -2 * residual.astype(np.int64) - 1)
    mean = max(float(zz.mean()), 0.0)
    param = 0
    while (1 << (param + 1)) < mean + 1 and param < 14:
        param += 1
    bw.write_bits(0, 2)   # rice method 0
    bw.write_bits(0, 4)   # partition order 0
    bw.write_bits(param, 4)
    for v in zz.tolist():
        bw.write_unary(v >> param)
        if param:
            bw.write_bits(v & ((1 << param) - 1), param)


def write_flac(path: str, audio: np.ndarray, sample_rate: int,
               bps: int = 16, blocksize: int = 4096) -> None:
    """Encode float or int16 audio to FLAC (fixed order-2 prediction)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.dtype.kind == "f":
        pcm = np.clip(audio, -1.0, 1.0)
        pcm = np.round(pcm * ((1 << (bps - 1)) - 1)).astype(np.int64)
    else:
        pcm = audio.astype(np.int64)
    n_samples, n_channels = pcm.shape

    out = bytearray(b"fLaC")
    # STREAMINFO
    si = BitWriter()
    si.write_bits(blocksize, 16)
    si.write_bits(blocksize, 16)
    si.write_bits(0, 24)
    si.write_bits(0, 24)
    si.write_bits(sample_rate, 20)
    si.write_bits(n_channels - 1, 3)
    si.write_bits(bps - 1, 5)
    si.write_bits(n_samples, 36)
    body = si.getvalue() + b"\x00" * 16  # MD5 unset
    out.append(0x80 | 0x00)  # last block, STREAMINFO
    out += len(body).to_bytes(3, "big")
    out += body

    frame_no = 0
    for start in range(0, n_samples, blocksize):
        block = pcm[start: start + blocksize]
        bs = block.shape[0]
        bw = BitWriter()
        bw.write_bits(0b11111111111110, 14)
        bw.write_bits(0, 1)
        bw.write_bits(0, 1)  # fixed blocksize stream
        bw.write_bits(7, 4)  # blocksize: 16-bit value follows
        bw.write_bits(0, 4)  # sample rate: from STREAMINFO
        bw.write_bits(n_channels - 1, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bps]
        bw.write_bits(ss_code, 3)
        bw.write_bits(0, 1)
        for b in _utf8_number(frame_no):
            bw.write_bits(b, 8)
        bw.write_bits(bs - 1, 16)
        bw.align()
        header = bw.getvalue()
        header += bytes([_crc8(header)])

        body_bw = BitWriter()
        for ch in range(n_channels):
            sig = block[:, ch]
            if bs > 4:
                body_bw.write_bits(0, 1)
                body_bw.write_bits(8 + 2, 6)  # FIXED order 2
                body_bw.write_bits(0, 1)      # no wasted bits
                for w in sig[:2].tolist():
                    body_bw.write_bits(int(w), bps)
                residual = sig[2:] - (2 * sig[1:-1] - sig[:-2])
                _write_rice(body_bw, residual)
            else:
                body_bw.write_bits(0, 1)
                body_bw.write_bits(1, 6)  # VERBATIM
                body_bw.write_bits(0, 1)
                for v in sig.tolist():
                    body_bw.write_bits(int(v), bps)
        body_bw.align()
        frame = header + body_bw.getvalue()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
        frame_no += 1

    with open(path, "wb") as f:
        f.write(bytes(out))

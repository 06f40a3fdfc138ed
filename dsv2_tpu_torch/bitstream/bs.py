"""Host bitstream primitives for the DSV2 v2.8 wire format.

MSB-first bit I/O plus the four entropy code families of the format:
interleaved exp-Golomb (UEG / SEG signed / NEG nonzero), adaptive Rice with
damped k adaptation, and zero-bit RLE (ZBRLE) for binary block masks.
Wire-compatible with the reference (ref: src/bs.c).

These Python classes handle the *small* serial payloads (packet headers,
motion subsections, block masks). The per-coefficient scan — megabits per
frame — lives in the native C runtime (dsv2_tpu_torch/native) with identical
semantics.
"""


class BitWriter:
    """MSB-first bit writer over a growable zero-initialized buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, initial=4096):
        self.buf = bytearray(initial)
        self.pos = 0  # bit position

    def _ensure(self, nbits):
        need = (self.pos + nbits + 7) // 8
        if need > len(self.buf):
            self.buf.extend(b"\0" * max(need - len(self.buf), len(self.buf)))

    @property
    def byte_pos(self):
        return self.pos // 8

    def aligned(self):
        return (self.pos & 7) == 0

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def put_bit(self, v):
        self._ensure(1)
        if v:
            self.buf[self.pos >> 3] |= 1 << (7 - (self.pos & 7))
        self.pos += 1

    def put_bits(self, n, v):
        self._ensure(n)
        pos, buf = self.pos, self.buf
        while n > 0:
            rem = 8 - (pos & 7)
            if n < rem:
                rem = n
            bit = (7 - (pos & 7)) - rem + 1
            buf[pos >> 3] |= ((v >> (n - rem)) & ((1 << rem) - 1)) << bit
            n -= rem
            pos += rem
        self.pos = pos

    def skip_zero_bits(self, n):
        """Advance assuming buffer is zeroed (writing n zero bits)."""
        self._ensure(n)
        self.pos += n

    def put_ueg(self, v):
        """Unsigned interleaved exp-Golomb (ref: bs.c:130-147)."""
        v = int(v) + 1
        nb = v.bit_length() - 1
        self._ensure(2 * nb + 1)
        for i in range(nb):
            self.pos += 1  # zero bit
            self.put_bit(v & (1 << (nb - 1 - i)))
        self.put_bit(1)

    def put_seg(self, v):
        """Signed interleaved exp-Golomb (ref: bs.c:173-189)."""
        v = int(v)
        s = 1 if v < 0 else 0
        if s:
            v = -v
        self.put_ueg(v)
        if v:
            self.put_bit(s)

    def put_neg(self, v):
        """Nonzero signed interleaved exp-Golomb (ref: bs.c:204-220)."""
        v = int(v)
        s = 1 if v < 0 else 0
        if s:
            v = -v
        self.put_ueg(v - 1)
        if v:
            self.put_bit(s)

    def put_rice(self, v, rk, damp):
        """Adaptive Rice; returns updated k state (ref: bs.c:235-251)."""
        k = rk >> damp
        q = v >> k
        if q:
            rk += 1
        elif rk > 0:
            rk -= 1
        self._ensure(q + 1 + k)
        self.pos += q
        self.put_bit(1)
        if k:
            self.put_bits(k, v)
        return rk

    def put_nrice(self, v, rk, damp):
        """Nonzero signed adaptive Rice (ref: bs.c:270-275)."""
        u = 2 * v if v >= 0 else -2 * v - 1
        return self.put_rice(u - 1, rk, damp)

    def concat_bytes(self, data):
        assert self.aligned()
        n = len(data)
        self._ensure(n * 8)
        self.buf[self.pos >> 3:(self.pos >> 3) + n] = data
        self.pos += n * 8

    def patch_bits(self, bitpos, n, v):
        """Overwrite n bits at bitpos (slot must have been zeros)."""
        save = self.pos
        self.pos = bitpos
        self.put_bits(n, v)
        self.pos = save

    def data(self):
        self.align()
        return bytes(self.buf[:self.pos >> 3])


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, bitpos=0):
        self.buf = buf
        self.pos = bitpos

    @property
    def byte_pos(self):
        return self.pos // 8

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def skip_bytes(self, n):
        self.pos += n * 8

    def seek_byte(self, b):
        self.pos = b * 8

    def get_bit(self):
        out = (self.buf[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return out

    def get_bits(self, n):
        out = 0
        pos, buf = self.pos, self.buf
        while n > 0:
            rem = 8 - (pos & 7)
            if n < rem:
                rem = n
            bit = (7 - (pos & 7)) - rem + 1
            out = (out << rem) | ((buf[pos >> 3] >> bit) & ((1 << rem) - 1))
            n -= rem
            pos += rem
        self.pos = pos
        return out

    def get_ueg(self):
        v = 1
        while not self.get_bit():
            v = (v << 1) | self.get_bit()
        return v - 1

    def get_seg(self):
        v = self.get_ueg()
        if v and self.get_bit():
            return -v
        return v

    def get_neg(self):
        v = self.get_ueg() + 1
        if v and self.get_bit():
            return -v
        return v

    def get_rice(self, rk, damp):
        """Returns (value, updated k state) (ref: bs.c:253-268)."""
        k = rk >> damp
        q = 0
        while not self.get_bit():
            q += 1
        if q:
            rk += 1
        elif rk > 0:
            rk -= 1
        v = (q << k) | (self.get_bits(k) if k else 0)
        return v, rk

    def get_nrice(self, rk, damp):
        v, rk = self.get_rice(rk, damp)
        u = v + 1
        return (u >> 1) ^ -(u & 1), rk


class ZBRLEWriter:
    """Zero-bit run-length encoder (ref: bs.c:284-318)."""

    def __init__(self):
        self.bs = BitWriter(256)
        self.nz = 0

    def put(self, b):
        if b:
            self.bs.put_ueg(self.nz)
            self.nz = 0
        else:
            self.nz += 1

    def end(self):
        """Flush; returns the encoded bytes."""
        self.bs.put_ueg(self.nz)
        self.nz = 0
        self.bs.align()
        return self.bs.data()


class ZBRLEReader:
    """Zero-bit run-length decoder (ref: bs.c:284-330)."""

    def __init__(self, buf, bitpos=0):
        self.bs = BitReader(buf, bitpos)
        self.nz = 0

    def get(self):
        if self.nz == 0:
            self.nz = self.bs.get_ueg()
            return 1 if self.nz == 0 else 0
        self.nz -= 1
        return 1 if self.nz == 0 else 0

    def end(self):
        return self.nz > 1  # True = early termination anomaly

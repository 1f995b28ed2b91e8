"""BC6H (half-float HDR) block decoder.

Replaces the GPU's fixed-function BC6H sampling for the reference's HDR
textures (vkFormat 143/144, src/wgpu.zig:138-139; assets
data/textures/hdr_bc6u.ktx2 and missing_bc6u.ktx2).

Layout reference: Khronos Data Format Specification §BC6H. Mode values
are the block's low 2 bits (modes 0/1) or low 5 bits. The shipped assets
use only the one-region modes 0x03/0x0b/0x0f (verified by header scan),
which this decoder handles bit-exactly (validated against Pillow's
independent decoder); the two-region modes are implemented from the spec
table and fuzz-validated the same way.

Decode steps (unsigned UF16 path):
  1. extract endpoints (delta-compressed except modes 0x03/0x1e);
     deltas are sign-extended and wrap within the endpoint width
  2. unquantize to 17-bit: ((v << 15) + 0x4000) >> (w - 1), with 0 -> 0
     and max -> 0xFFFF special cases (w=16 passes through)
  3. interpolate with the BC7 weight tables (4-bit one-region /
     3-bit two-region)
  4. final scale: (interp * 31) >> 6 gives raw half-float bits

Vectorized over blocks per mode.
"""

from __future__ import annotations

import numpy as np

from tpurast_torch.assets._bc7_tables import ANCHOR_SECOND_2, PARTITIONS_2

W3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int64)
W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.int64)

# Field order per endpoint channel: (rw, rx, ry, rz) = (ep0, ep1, ep2, ep3)
# for region0-low/region0-high/region1-low/region1-high in spec naming
# (w=e0 of region0, x=e1 of region0, y=e0 of region1, z=e1 of region1).
#
# Each mode: (epb, (dr, dg, db) or None for direct, layout). The layout is
# a list of (field, hi, lo) writes consumed in bit order after the mode
# header — (field, bit) single-bit entries use hi==lo. Fields: rw gw bw rx
# gx bx ry gy by rz gz bz d (partition).
_M = lambda *e: list(e)


def _f(name, hi, lo=None):
    return (name, hi, hi if lo is None else lo)


# Spec bit-layout table (Khronos DFS / D3D11.3 §19.5.11). Reads run LSB
# first starting after the 2- or 5-bit mode field.
_MODES = {
    0x00: dict(epb=10, delta=(5, 5, 5), layout=_M(
        _f("gy", 4), _f("by", 4), _f("bz", 4),
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 4, 0), _f("gz", 4), _f("gy", 3, 0),
        _f("gx", 4, 0), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 4, 0), _f("bz", 1), _f("by", 3, 0),
        _f("ry", 4, 0), _f("bz", 2), _f("rz", 4, 0), _f("bz", 3),
        _f("d", 4, 0),
    )),
    0x01: dict(epb=7, delta=(6, 6, 6), layout=_M(
        _f("gy", 5), _f("gz", 4), _f("gz", 5),
        _f("rw", 6, 0), _f("bz", 0), _f("bz", 1), _f("by", 4),
        _f("gw", 6, 0), _f("by", 5), _f("bz", 2), _f("gy", 4),
        _f("bw", 6, 0), _f("bz", 3), _f("bz", 5), _f("bz", 4),
        _f("rx", 5, 0), _f("gy", 3, 0), _f("gx", 5, 0),
        _f("gz", 3, 0), _f("bx", 5, 0), _f("by", 3, 0),
        _f("ry", 5, 0), _f("rz", 5, 0), _f("d", 4, 0),
    )),
    0x02: dict(epb=11, delta=(5, 4, 4), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 4, 0), _f("rw", 10), _f("gy", 3, 0),
        _f("gx", 3, 0), _f("gw", 10), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 3, 0), _f("bw", 10), _f("bz", 1), _f("by", 3, 0),
        _f("ry", 4, 0), _f("bz", 2), _f("rz", 4, 0), _f("bz", 3),
        _f("d", 4, 0),
    )),
    0x06: dict(epb=11, delta=(4, 5, 4), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 3, 0), _f("rw", 10), _f("gz", 4), _f("gy", 3, 0),
        _f("gx", 4, 0), _f("gw", 10), _f("gz", 3, 0),
        _f("bx", 3, 0), _f("bw", 10), _f("bz", 1), _f("by", 3, 0),
        _f("ry", 3, 0), _f("bz", 0), _f("bz", 2), _f("rz", 3, 0),
        _f("gy", 4), _f("bz", 3), _f("d", 4, 0),
    )),
    0x0A: dict(epb=11, delta=(4, 4, 5), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 3, 0), _f("rw", 10), _f("by", 4), _f("gy", 3, 0),
        _f("gx", 3, 0), _f("gw", 10), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 4, 0), _f("bw", 10), _f("by", 3, 0),
        _f("ry", 3, 0), _f("bz", 1), _f("bz", 2), _f("rz", 3, 0),
        _f("bz", 4), _f("bz", 3), _f("d", 4, 0),
    )),
    0x0E: dict(epb=9, delta=(5, 5, 5), layout=_M(
        _f("rw", 8, 0), _f("by", 4), _f("gw", 8, 0), _f("gy", 4),
        _f("bw", 8, 0), _f("bz", 4), _f("rx", 4, 0), _f("gz", 4),
        _f("gy", 3, 0), _f("gx", 4, 0), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 4, 0), _f("bz", 1), _f("by", 3, 0),
        _f("ry", 4, 0), _f("bz", 2), _f("rz", 4, 0), _f("bz", 3),
        _f("d", 4, 0),
    )),
    0x12: dict(epb=8, delta=(6, 5, 5), layout=_M(
        _f("rw", 7, 0), _f("gz", 4), _f("by", 4), _f("gw", 7, 0),
        _f("bz", 2), _f("gy", 4), _f("bw", 7, 0), _f("bz", 3),
        _f("bz", 4), _f("rx", 5, 0), _f("gy", 3, 0),
        _f("gx", 4, 0), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 4, 0), _f("bz", 1), _f("by", 3, 0),
        _f("ry", 5, 0), _f("rz", 5, 0), _f("d", 4, 0),
    )),
    0x16: dict(epb=8, delta=(5, 6, 5), layout=_M(
        _f("rw", 7, 0), _f("bz", 0), _f("by", 4), _f("gw", 7, 0),
        _f("gy", 5), _f("gy", 4), _f("bw", 7, 0), _f("gz", 5),
        _f("bz", 4), _f("rx", 4, 0), _f("gz", 4), _f("gy", 3, 0),
        _f("gx", 5, 0), _f("gz", 3, 0), _f("bx", 4, 0),
        _f("bz", 1), _f("by", 3, 0), _f("ry", 4, 0), _f("bz", 2),
        _f("rz", 4, 0), _f("bz", 3), _f("d", 4, 0),
    )),
    0x1A: dict(epb=8, delta=(5, 5, 6), layout=_M(
        _f("rw", 7, 0), _f("bz", 1), _f("by", 4), _f("gw", 7, 0),
        _f("by", 5), _f("gy", 4), _f("bw", 7, 0), _f("bz", 5),
        _f("bz", 4), _f("rx", 4, 0), _f("gz", 4), _f("gy", 3, 0),
        _f("gx", 4, 0), _f("bz", 0), _f("gz", 3, 0),
        _f("bx", 5, 0), _f("by", 3, 0), _f("ry", 4, 0),
        _f("bz", 2), _f("rz", 4, 0), _f("bz", 3), _f("d", 4, 0),
    )),
    0x1E: dict(epb=6, delta=None, layout=_M(
        _f("rw", 5, 0), _f("gz", 4), _f("bz", 0), _f("bz", 1), _f("by", 4),
        _f("gw", 5, 0), _f("gy", 5), _f("by", 5), _f("bz", 2), _f("gy", 4),
        _f("bw", 5, 0), _f("gz", 5), _f("bz", 3), _f("bz", 5), _f("bz", 4),
        _f("rx", 5, 0), _f("gy", 3, 0), _f("gx", 5, 0),
        _f("gz", 3, 0), _f("bx", 5, 0), _f("by", 3, 0),
        _f("ry", 5, 0), _f("rz", 5, 0), _f("d", 4, 0),
    )),
    # One-region modes (the ones shipped assets use).
    0x03: dict(epb=10, delta=None, layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 9, 0), _f("gx", 9, 0), _f("bx", 9, 0),
    )),
    0x07: dict(epb=11, delta=(9, 9, 9), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 8, 0), _f("rw", 10), _f("gx", 8, 0), _f("gw", 10),
        _f("bx", 8, 0), _f("bw", 10),
    )),
    0x0B: dict(epb=12, delta=(8, 8, 8), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 7, 0), _f("rw", 10, 11), _f("gx", 7, 0), _f("gw", 10, 11),
        _f("bx", 7, 0), _f("bw", 10, 11),
    )),
    0x0F: dict(epb=16, delta=(4, 4, 4), layout=_M(
        _f("rw", 9, 0), _f("gw", 9, 0), _f("bw", 9, 0),
        _f("rx", 3, 0), _f("rw", 10, 15), _f("gx", 3, 0), _f("gw", 10, 15),
        _f("bx", 3, 0), _f("bw", 10, 15),
    )),
}

TWO_REGION_MODES = {0x00, 0x01, 0x02, 0x06, 0x0A, 0x0E, 0x12, 0x16, 0x1A, 0x1E}


def _bits_of(blocks: np.ndarray) -> np.ndarray:
    return np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    sign = 1 << (bits - 1)
    return (v ^ sign) - sign


def _unquantize_unsigned(v: np.ndarray, w: int) -> np.ndarray:
    if w >= 16:
        return v
    maxv = (1 << w) - 1
    out = ((v << 15) + 0x4000) >> (w - 1)
    out = np.where(v == 0, 0, out)
    out = np.where(v >= maxv, 0xFFFF, out)
    return out


def _unquantize_signed(v: np.ndarray, w: int) -> np.ndarray:
    """Signed unquantize (D3D11.3 §19.5.11.3): operate on |v|, saturate
    at the (w-1)-bit magnitude max to 0x7FFF, restore the sign."""
    if w >= 16:
        return v
    s = v < 0
    av = np.abs(v)
    maxv = (1 << (w - 1)) - 1
    out = ((av << 15) + 0x4000) >> (w - 1)
    out = np.where(av == 0, 0, out)
    out = np.where(av >= maxv, 0x7FFF, out)
    return np.where(s, -out, out)


def _half_bits_to_f32(h: np.ndarray) -> np.ndarray:
    return h.astype(np.uint16).view(np.float16).astype(np.float32)


def decode_bc6h(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """Decode BC6H blocks. (N, 16) uint8 -> (N, 4, 4, 3) float32.

    Both variants the reference maps (src/wgpu.zig:138-139): unsigned
    UF16 (vkFormat 143, the shipped *_bc6u.ktx2 assets) and signed SF16
    (144). The signed path sign-extends endpoints at their storage
    width, unquantizes on magnitude saturating to +/-0x7FFF, and scales
    by 31/32 (vs 31/64 unsigned) before reinterpreting as half bits
    (D3D11.3 §19.5.11; fuzz-validated vs Pillow's BC6HS decoder).
    """
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    bits = _bits_of(blocks)
    out = np.zeros((n, 16, 3), dtype=np.float32)

    first = blocks[:, 0].astype(np.int64)
    mode_of = np.where(first & 0b10, first & 0b11111, first & 0b11)
    header = np.where(first & 0b10, 5, 2)

    for mode, spec in _MODES.items():
        sel = np.nonzero(mode_of == mode)[0]
        if (mode in (0, 1) and (mode_of[sel] != mode).any()) or len(sel) == 0:
            continue
        b = bits[sel]
        two = mode in TWO_REGION_MODES
        fields = {
            k: np.zeros(len(sel), dtype=np.int64)
            for k in ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz", "d")
        }
        pos = int(header[sel[0]]) if len(sel) else 2
        for name, hi, lo in spec["layout"]:
            if hi >= lo:
                nb = hi - lo + 1
                w = (np.int64(1) << np.arange(nb, dtype=np.int64))
                val = b[:, pos : pos + nb] @ w
                fields[name] |= val << lo
                pos += nb
            else:
                # Reversed run: bits stored MSB-first (modes 0x0B/0x0F
                # store the base's high bits in decreasing significance).
                nb = lo - hi + 1
                for k in range(nb):
                    fields[name] |= b[:, pos] << (lo - k)
                    pos += 1

        epb = spec["epb"]
        mask = (1 << epb) - 1
        e = {k: fields[k] for k in fields}
        if signed:
            # Signed endpoints are two's complement at the storage width.
            for chan in "rgb":
                e[chan + "w"] = _sign_extend(e[chan + "w"], epb)
                if spec["delta"] is None:
                    for epn in ("x", "y", "z"):
                        e[chan + epn] = _sign_extend(e[chan + epn], epb)
        if spec["delta"] is not None:
            dr, dg, db = spec["delta"]
            for chan, dbits in (("r", dr), ("g", dg), ("b", db)):
                base = e[chan + "w"]
                for epn in ("x", "y", "z"):
                    d = _sign_extend(e[chan + epn], dbits)
                    s = (base + d) & mask
                    e[chan + epn] = _sign_extend(s, epb) if signed else s

        # Unquantize all endpoints.
        _unq = _unquantize_signed if signed else _unquantize_unsigned
        uq = {k: _unq(e[k], epb) for k in ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz")}

        ib = 3 if two else 4
        weights = W3 if two else W4
        if two:
            partition = fields["d"]
            subset = PARTITIONS_2[partition].astype(np.int64)  # (Nm, 16)
            anchors = ANCHOR_SECOND_2[partition]
        else:
            subset = np.zeros((len(sel), 16), dtype=np.int64)
            anchors = None

        # Index bits: anchor pixels (0 and, for two-region, the second
        # subset's anchor) store one fewer bit.
        idx = np.zeros((len(sel), 16), dtype=np.int64)
        p = pos
        pcol = np.full(len(sel), p, dtype=np.int64)
        for i in range(16):
            if two:
                short = (i == 0) | (anchors == i)
            else:
                short = np.full(len(sel), i == 0)
            nb = np.where(short, ib - 1, ib)
            v = np.zeros(len(sel), dtype=np.int64)
            for k in range(ib):
                take = k < nb
                col = np.minimum(pcol + k, 127)
                v |= np.where(take, np.take_along_axis(bits[sel], col[:, None], axis=1)[:, 0] << k, 0)
            idx[:, i] = v
            pcol = pcol + nb

        ep0 = {0: ("rw", "gw", "bw"), 1: ("ry", "gy", "by")}
        ep1 = {0: ("rx", "gx", "bx"), 1: ("rz", "gz", "bz")}
        w = weights[idx]  # (Nm, 16)
        px = np.zeros((len(sel), 16, 3), dtype=np.int64)
        for region in (0, 1) if two else (0,):
            m = subset == region
            for c in range(3):
                a = uq[ep0[region][c]][:, None]
                bb = uq[ep1[region][c]][:, None]
                interp = (a * (64 - w) + bb * w + 32) >> 6
                px[:, :, c] = np.where(m, interp, px[:, :, c])

        if signed:
            # Signed finish: scale magnitude by 31/32, store sign-magnitude
            # half bits (negative halves are 0x8000 | magnitude).
            mag = (np.abs(px) * 31) >> 5
            half = np.where(px < 0, 0x8000 | mag, mag)
        else:
            half = (px * 31) >> 6  # final unsigned scale -> half bits
        out[sel] = _half_bits_to_f32(half)

    return out.reshape(n, 4, 4, 3)

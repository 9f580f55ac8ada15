"""QR payload decoding (round 5, VERDICT r4 #9).

Extends the finder-pattern detector (vision/qr.py) with a full
host-side decode chain so ``VisionResult.barcodes`` carries TEXT the
cortex can speak, not just "there is a QR code": affine grid sampling
from the three finder centers, format-info BCH recovery (both copies,
nearest-valid-code), data-mask removal, zigzag codeword extraction,
per-block Reed-Solomon error correction over GF(256), and mode-segment
parsing (numeric / alphanumeric / byte).

Scope: versions 1-6 (21x21 .. 41x41 modules) — the sizes a hand-held
assistive camera resolves at decodable module widths; version derives
from finder-center geometry, so the v7+ version-info blocks are not
needed. Sampling is affine (three-point), which handles the frontal /
mildly-oblique frames the product sees; strong perspective needs the
fourth (alignment-pattern) point and is detected-but-undecoded, same
as before this module existed.

An :func:`encode_qr` twin lives here too — it shares every table with
the decoder (GF arithmetic, block structure, mask predicates, format
placement), serving as the self-test fixture generator
(tests/test_qr_decode.py round-trips rendered codes through the full
camera-frame path) and a debugging aid on first contact with real
codes.

Reference parity: the reference's OCR engine exposes QR/barcode
DETECTION hooks only (src/vision/tk_text_recognition.cpp:103-104);
payload decode is beyond-parity user value (an assistant that says
"there is a QR code" but cannot read it leaves the user stranded).
Pure host-side numpy: bit twiddling on a ~41x41 grid, no device work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# GF(256) arithmetic (QR polynomial x^8 + x^4 + x^3 + x^2 + 1 = 0x11D)
# ---------------------------------------------------------------------------

_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _poly_eval(poly: List[int], x: int) -> int:
    """poly[0] is the highest-degree coefficient."""
    y = 0
    for c in poly:
        y = _gf_mul(y, x) ^ c
    return y


def rs_generator(n_ecc: int) -> List[int]:
    g = [1]
    for i in range(n_ecc):
        nxt = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            nxt[j] ^= _gf_mul(c, _EXP[i])
            nxt[j + 1] ^= c
        g = nxt
    return g[::-1]  # highest degree first


def rs_encode(data: List[int], n_ecc: int) -> List[int]:
    """Return the n_ecc Reed-Solomon check codewords for ``data``."""
    gen = rs_generator(n_ecc)
    rem = list(data) + [0] * n_ecc
    for i in range(len(data)):
        lead = rem[i]
        if lead == 0:
            continue
        for j in range(len(gen)):
            rem[i + j] ^= _gf_mul(gen[j], lead)
    return rem[len(data):]


def _gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_EXP[255 - _LOG[a]])


def _gf_solve(a: List[List[int]], b: List[int]) -> Optional[List[int]]:
    """Gaussian elimination over GF(256). Returns x with A x = b, or
    None when A is singular."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col]), None)
        if piv is None:
            return None
        m[col], m[piv] = m[piv], m[col]
        inv = _gf_inv(m[col][col])
        m[col] = [_gf_mul(v, inv) for v in m[col]]
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [m[r][k] ^ _gf_mul(f, m[col][k])
                        for k in range(n + 1)]
    return [m[r][n] for r in range(n)]


def rs_correct(block: List[int], n_ecc: int) -> List[int]:
    """Correct up to n_ecc//2 codeword errors in-place; returns the
    data part. Raises ValueError when uncorrectable.

    Peterson-Gorenstein-Zierler: at QR block sizes (<= 14 correctable
    errors) the locator solve is a tiny GF(256) linear system — easier
    to verify than Berlekamp-Massey and plenty fast host-side."""
    n = len(block)
    synd = [_poly_eval(block, int(_EXP[i])) for i in range(n_ecc)]
    if not any(synd):
        return block[: n - n_ecc]
    t = n_ecc // 2
    for v in range(t, 0, -1):
        # Solve S_{v+i} = sum_j L_{j+1} * S_{v+i-1-j} for L_1..L_v.
        A = [[synd[v + i - 1 - j] for j in range(v)] for i in range(v)]
        rhs = [synd[v + i] for i in range(v)]
        L = _gf_solve(A, rhs)
        if L is None:
            continue
        # Lambda(x) = 1 + L_1 x + ... + L_v x^v; roots at X_k^{-1}
        # where X_k = alpha^{n-1-p_k} locates error position p_k.
        err_pos = []
        for p in range(n):
            e = n - 1 - p
            xinv = int(_EXP[(255 - e) % 255])
            s = 1
            xp = 1
            for j in range(v):
                xp = _gf_mul(xp, xinv)
                s ^= _gf_mul(L[j], xp)
            if s == 0:
                err_pos.append(p)
        if len(err_pos) != v:
            continue
        # Magnitudes: S_i = sum_k Y_k X_k^i, i = 0..v-1.
        xs = [int(_EXP[(n - 1 - p) % 255]) for p in err_pos]
        V = [[int(_EXP[(_LOG[x] * i) % 255]) for x in xs]
             for i in range(v)]
        Y = _gf_solve(V, synd[:v])
        if Y is None:
            continue
        fixed = list(block)
        for p, y in zip(err_pos, Y):
            fixed[p] ^= y
        if not any(_poly_eval(fixed, int(_EXP[i]))
                   for i in range(n_ecc)):
            block[:] = fixed
            return block[: n - n_ecc]
    raise ValueError("RS: uncorrectable block")


# ---------------------------------------------------------------------------
# QR tables (versions 1-6)
# ---------------------------------------------------------------------------

# (version, ec_level) -> list of (n_data, n_ecc) blocks, in interleave
# order. ec_level: 0=L 1=M 2=Q 3=H (the two-bit format values are
# L=01 M=00 Q=11 H=10 — mapped below).
_BLOCKS: Dict[Tuple[int, int], List[Tuple[int, int]]] = {
    (1, 0): [(19, 7)], (1, 1): [(16, 10)],
    (1, 2): [(13, 13)], (1, 3): [(9, 17)],
    (2, 0): [(34, 10)], (2, 1): [(28, 16)],
    (2, 2): [(22, 22)], (2, 3): [(16, 28)],
    (3, 0): [(55, 15)], (3, 1): [(44, 26)],
    (3, 2): [(17, 18)] * 2, (3, 3): [(13, 22)] * 2,
    (4, 0): [(80, 20)], (4, 1): [(32, 18)] * 2,
    (4, 2): [(24, 26)] * 2, (4, 3): [(9, 16)] * 4,
    (5, 0): [(108, 26)], (5, 1): [(43, 24)] * 2,
    (5, 2): [(15, 18)] * 2 + [(16, 18)] * 2,
    (5, 3): [(11, 22)] * 2 + [(12, 22)] * 2,
    (6, 0): [(68, 18)] * 2, (6, 1): [(27, 16)] * 4,
    (6, 2): [(19, 24)] * 4, (6, 3): [(15, 28)] * 4,
}

_ALIGN = {1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
          6: [6, 34]}

# format two-bit field -> internal level index (L=01 M=00 Q=11 H=10).
_FMT_TO_LEVEL = {0b01: 0, 0b00: 1, 0b11: 2, 0b10: 3}
_LEVEL_TO_FMT = {v: k for k, v in _FMT_TO_LEVEL.items()}

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"


def _bch_format(value5: int) -> int:
    """5 data bits -> 15-bit BCH(15,5) code, XOR-masked 0x5412."""
    v = value5 << 10
    g = 0x537
    rem = v
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= g << (i - 10)
    return ((value5 << 10) | rem) ^ 0x5412


_VALID_FORMATS = [_bch_format(v) for v in range(32)]


def _mask_predicate(mask: int):
    return [
        lambda r, c: (r + c) % 2 == 0,
        lambda r, c: r % 2 == 0,
        lambda r, c: c % 3 == 0,
        lambda r, c: (r + c) % 3 == 0,
        lambda r, c: (r // 2 + c // 3) % 2 == 0,
        lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
        lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
        lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
    ][mask]


def _function_mask(version: int) -> np.ndarray:
    """True where a module is a FUNCTION module (not data)."""
    size = 17 + 4 * version
    f = np.zeros((size, size), bool)
    # Finders + separators + format areas.
    f[:9, :9] = True
    f[:9, size - 8:] = True
    f[size - 8:, :9] = True
    # Timing.
    f[6, :] = True
    f[:, 6] = True
    # Alignment patterns (skip any overlapping a finder).
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c >= size - 8) \
                    or (r >= size - 8 and c < 9):
                continue
            f[r - 2:r + 3, c - 2:c + 3] = True
    return f


def _format_positions(size: int):
    """The two 15-bit format-info copies, MSB first (zxing order)."""
    copy_a = ([(8, c) for c in range(6)] + [(8, 7), (8, 8), (7, 8)]
              + [(r, 8) for r in range(5, -1, -1)])
    copy_b = ([(size - 1 - r, 8) for r in range(7)]
              + [(8, size - 8 + c) for c in range(8)])
    return copy_a, copy_b


# ---------------------------------------------------------------------------
# Bit placement (shared by encoder + decoder)
# ---------------------------------------------------------------------------

def _data_coords(version: int) -> List[Tuple[int, int]]:
    """Module coordinates in zigzag placement order."""
    size = 17 + 4 * version
    func = _function_mask(version)
    coords = []
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:  # timing column is skipped entirely
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if not func[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _read_format(mods: np.ndarray) -> Tuple[int, int]:
    """-> (ec_level_idx, mask). Tries both copies, nearest valid code
    within Hamming distance 3."""
    size = mods.shape[0]
    copy_a, copy_b = _format_positions(size)
    best = None
    for copy in (copy_a, copy_b):
        bits = 0
        for r, c in copy:
            bits = (bits << 1) | int(mods[r, c])
        for code in _VALID_FORMATS:
            d = bin(bits ^ code).count("1")
            if best is None or d < best[0]:
                best = (d, code)
    if best is None or best[0] > 3:
        raise ValueError("QR: format info unreadable")
    value5 = (best[1] ^ 0x5412) >> 10
    return _FMT_TO_LEVEL[(value5 >> 3) & 0b11], value5 & 0b111


def decode_modules(mods: np.ndarray) -> str:
    """Decode a sampled True=dark module grid -> payload text."""
    size = mods.shape[0]
    version = (size - 17) // 4
    if version not in _BLOCKS_VERSIONS:
        raise ValueError(f"QR: unsupported size {size}")
    level, mask = _read_format(mods)
    pred = _mask_predicate(mask)
    coords = _data_coords(version)
    bits = []
    for r, c in coords:
        v = int(mods[r, c]) ^ (1 if pred(r, c) else 0)
        bits.append(v)
    codewords = []
    for i in range(0, len(bits) - 7, 8):
        b = 0
        for j in range(8):
            b = (b << 1) | bits[i + j]
        codewords.append(b)
    blocks = _BLOCKS[(version, level)]
    n_data_total = sum(d for d, _ in blocks)
    # De-interleave: data codewords round-robin (short blocks first),
    # then ecc codewords round-robin.
    data_blocks = [[] for _ in blocks]
    idx = 0
    max_d = max(d for d, _ in blocks)
    for j in range(max_d):
        for bi, (d, _) in enumerate(blocks):
            if j < d:
                data_blocks[bi].append(codewords[idx])
                idx += 1
    ecc_blocks = [[] for _ in blocks]
    max_e = max(e for _, e in blocks)
    for j in range(max_e):
        for bi, (_, e) in enumerate(blocks):
            if j < e:
                ecc_blocks[bi].append(codewords[idx])
                idx += 1
    data = []
    for bi, (d, e) in enumerate(blocks):
        corrected = rs_correct(data_blocks[bi] + ecc_blocks[bi], e)
        data.extend(corrected)
    assert len(data) == n_data_total
    return _parse_segments(data, version)


_BLOCKS_VERSIONS = {v for v, _ in _BLOCKS}


def _parse_segments(data: List[int], version: int) -> str:
    stream = _BitReader(data)
    out = []
    while stream.remaining() >= 4:
        mode = stream.take(4)
        if mode == 0:  # terminator
            break
        if mode == 0b0001:  # numeric
            n = stream.take(10)
            while n >= 3:
                v = stream.take(10)
                out.append(f"{v:03d}")
                n -= 3
            if n == 2:
                out.append(f"{stream.take(7):02d}")
            elif n == 1:
                out.append(f"{stream.take(4):d}")
        elif mode == 0b0010:  # alphanumeric
            n = stream.take(9)
            while n >= 2:
                v = stream.take(11)
                out.append(_ALNUM[v // 45] + _ALNUM[v % 45])
                n -= 2
            if n == 1:
                out.append(_ALNUM[stream.take(6)])
        elif mode == 0b0100:  # byte
            n = stream.take(8)
            raw = bytes(stream.take(8) for _ in range(n))
            out.append(raw.decode("utf-8", errors="replace"))
        elif mode == 0b0111:  # ECI: skip designator, keep parsing
            stream.take(8)
        else:
            raise ValueError(f"QR: unsupported mode {mode:04b}")
    return "".join(out)


class _BitReader:
    def __init__(self, codewords: List[int]):
        self.bits = []
        for c in codewords:
            for j in range(7, -1, -1):
                self.bits.append((c >> j) & 1)
        self.pos = 0

    def remaining(self) -> int:
        return len(self.bits) - self.pos

    def take(self, n: int) -> int:
        if self.remaining() < n:
            raise ValueError("QR: bit stream underrun")
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bits[self.pos]
            self.pos += 1
        return v


# ---------------------------------------------------------------------------
# Grid sampling from a camera frame
# ---------------------------------------------------------------------------

def _order_finders(centers, module: float):
    """Identify (top-left, top-right, bottom-left) among the three
    finder centers: TL is the corner whose vectors to the other two
    are most orthogonal; TR/BL disambiguate by cross-product sign
    (right-handed image coords: x right, y down)."""
    pts = [np.asarray(c, np.float64) for c in centers]
    best, tl_i = None, 0
    for i in range(3):
        a, b = pts[(i + 1) % 3] - pts[i], pts[(i + 2) % 3] - pts[i]
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            raise ValueError("QR: degenerate finder layout")
        cosang = abs(float(np.dot(a, b)) / (na * nb))
        if best is None or cosang < best:
            best, tl_i = cosang, i
    tl = pts[tl_i]
    p1, p2 = pts[(tl_i + 1) % 3], pts[(tl_i + 2) % 3]
    # cross > 0 (x right, y down) => p1 is TR.
    v1, v2 = p1 - tl, p2 - tl
    if v1[0] * v2[1] - v1[1] * v2[0] > 0:
        tr, bl = p1, p2
    else:
        tr, bl = p2, p1
    return tl, tr, bl


def sample_grid(gray: np.ndarray, centers,
                module: float) -> Optional[np.ndarray]:
    """Sample the module grid via the affine frame defined by the three
    finder centers. Returns a bool (size, size) grid or None when the
    geometry doesn't resolve to a supported version."""
    g = np.asarray(gray, np.float64)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    if g.max() > 1.5:
        g = g / 255.0
    tl, tr, bl = _order_finders(centers, module)
    dist = (np.linalg.norm(tr - tl) + np.linalg.norm(bl - tl)) / 2.0
    # Centers sit 3.5 modules inside: center distance = size - 7.
    size_f = dist / max(module, 1e-9) + 7.0
    version = int(round((size_f - 17.0) / 4.0))
    if version < 1 or version > 6:
        return None
    size = 17 + 4 * version
    n_span = size - 7.0
    ex = (tr - tl) / n_span          # +1 module in x (grid cols)
    ey = (bl - tl) / n_span          # +1 module in y (grid rows)
    # Module (r, c) center = tl + (c - 3)*ex + (r - 3)*ey shifted to
    # cell centers: finder centers sit at grid (3.5, 3.5) in px terms,
    # i.e. module index (3, 3)'s center.
    origin = tl - 3.0 * ex - 3.0 * ey
    # Vectorized sample positions: pos = origin + c*ex + r*ey.
    cc, rr = np.meshgrid(np.arange(size), np.arange(size))
    xs = origin[0] + cc * ex[0] + rr * ey[0]
    ys = origin[1] + cc * ex[1] + rr * ey[1]
    h, w = g.shape
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    vals = g[yi, xi]
    thresh = (vals.min() + vals.max()) / 2.0
    return vals < thresh


def decode_qr_payload(gray: np.ndarray, qr: Dict) -> Optional[str]:
    """Decode one vision/qr.py candidate. None on any failure — the
    caller falls back to detection-only reporting.

    The detector may group a spurious extra pattern with the three
    real finders; every 3-subset is tried (bounded: <= C(6,3) = 20
    cheap attempts) and the first successful decode wins — RS
    verification makes a false positive from a wrong subset
    effectively impossible."""
    from itertools import combinations

    centers = list(qr.get("centers", ()))
    if len(centers) < 3 or len(centers) > 6:
        return None
    for sub in combinations(centers, 3):
        try:
            mods = sample_grid(gray, sub, qr["module"])
            if mods is None:
                continue
            return decode_modules(mods)
        except (ValueError, KeyError, IndexError,
                ZeroDivisionError):
            continue
    return None


# ---------------------------------------------------------------------------
# Encoder (self-test fixture generator / first-contact debugging aid)
# ---------------------------------------------------------------------------

def _encode_payload_bits(text: str, version: int,
                         level: int) -> List[int]:
    n_data = sum(d for d, _ in _BLOCKS[(version, level)])
    bits: List[int] = []

    def put(v: int, n: int):
        for j in range(n - 1, -1, -1):
            bits.append((v >> j) & 1)

    if text.isdigit():
        put(0b0001, 4)
        put(len(text), 10)
        i = 0
        while i + 3 <= len(text):
            put(int(text[i:i + 3]), 10)
            i += 3
        if len(text) - i == 2:
            put(int(text[i:]), 7)
        elif len(text) - i == 1:
            put(int(text[i:]), 4)
    elif all(ch in _ALNUM for ch in text):
        put(0b0010, 4)
        put(len(text), 9)
        i = 0
        while i + 2 <= len(text):
            put(_ALNUM.index(text[i]) * 45 + _ALNUM.index(text[i + 1]),
                11)
            i += 2
        if i < len(text):
            put(_ALNUM.index(text[i]), 6)
    else:
        raw = text.encode("utf-8")
        put(0b0100, 4)
        put(len(raw), 8)
        for byte in raw:
            put(byte, 8)
    cap = n_data * 8
    if len(bits) > cap:
        raise ValueError("payload too long for version/level")
    bits += [0] * min(4, cap - len(bits))          # terminator
    while len(bits) % 8:
        bits.append(0)
    cw = []
    for i in range(0, len(bits), 8):
        b = 0
        for j in range(8):
            b = (b << 1) | bits[i + j]
        cw.append(b)
    pad = (0xEC, 0x11)
    k = 0
    while len(cw) < n_data:
        cw.append(pad[k % 2])
        k += 1
    return cw


def encode_qr(text: str, version: int = 2, level: int = 0,
              mask: int = 0) -> np.ndarray:
    """Render ``text`` as a bool (size, size) module grid (True=dark).
    Shares every table with the decoder; the roundtrip is the
    decoder's primary self-test."""
    blocks = _BLOCKS[(version, level)]
    data_cw = _encode_payload_bits(text, version, level)
    # Split into blocks, RS-encode each, interleave.
    db, eb = [], []
    idx = 0
    for d, e in blocks:
        blk = data_cw[idx: idx + d]
        idx += d
        db.append(blk)
        eb.append(rs_encode(blk, e))
    seq = []
    for j in range(max(d for d, _ in blocks)):
        for bi, (d, _) in enumerate(blocks):
            if j < d:
                seq.append(db[bi][j])
    for j in range(max(e for _, e in blocks)):
        for bi, (_, e) in enumerate(blocks):
            if j < e:
                seq.append(eb[bi][j])

    size = 17 + 4 * version
    mods = np.zeros((size, size), bool)
    # Finders.
    for r0, c0 in ((0, 0), (0, size - 7), (size - 7, 0)):
        mods[r0:r0 + 7, c0:c0 + 7] = True
        mods[r0 + 1:r0 + 6, c0 + 1:c0 + 6] = False
        mods[r0 + 2:r0 + 5, c0 + 2:c0 + 5] = True
    # Timing.
    for i in range(8, size - 8):
        mods[6, i] = (i % 2 == 0)
        mods[i, 6] = (i % 2 == 0)
    # Alignment (v>=2).
    for r in _ALIGN[version]:
        for c in _ALIGN[version]:
            if (r < 9 and c < 9) or (r < 9 and c >= size - 8) \
                    or (r >= size - 8 and c < 9):
                continue
            mods[r - 2:r + 3, c - 2:c + 3] = True
            mods[r - 1:r + 2, c - 1:c + 2] = False
            mods[r, c] = True
    # Dark module.
    mods[size - 8, 8] = True
    # Format info (both copies).
    fmt = _bch_format((_LEVEL_TO_FMT[level] << 3) | mask)
    copy_a, copy_b = _format_positions(size)
    for k, (r, c) in enumerate(copy_a):
        mods[r, c] = bool((fmt >> (14 - k)) & 1)
    for k, (r, c) in enumerate(copy_b):
        mods[r, c] = bool((fmt >> (14 - k)) & 1)
    # Data bits, masked.
    coords = _data_coords(version)
    bits = []
    for cw in seq:
        for j in range(7, -1, -1):
            bits.append((cw >> j) & 1)
    bits += [0] * (len(coords) - len(bits))  # remainder bits
    pred = _mask_predicate(mask)
    for (r, c), v in zip(coords, bits):
        mods[r, c] = bool(v ^ (1 if pred(r, c) else 0))
    return mods


def render_qr(mods: np.ndarray, module_px: int = 6,
              quiet: int = 4) -> np.ndarray:
    """Module grid -> uint8 grayscale image with a quiet zone."""
    size = mods.shape[0]
    img = np.full(((size + 2 * quiet) * module_px,) * 2, 255, np.uint8)
    big = np.kron(mods, np.ones((module_px, module_px), bool))
    q = quiet * module_px
    img[q:q + big.shape[0], q:q + big.shape[1]][big] = 0
    return img

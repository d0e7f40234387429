"""Bayer demosaicing.

Reference: src/algos/demosaicing.c — methods (enum src/core/siril.h:249-255):
super-pixel half-size (:32-80), bilinear (OpenCV scheme, :89-175),
nearest neighbor (:177-244), VNG (:284-421), AHD (:473-665).

Implemented vectorized (NumPy phase-slicing): super_pixel, bilinear,
nearest, and exact array-program ports of the dcraw VNG and AHD.

Conventions: input CFA is a top-down single layer as stored in SER
(callers flip afterwards, see siriltpu/io/ser.py); output is (3, H, W)
uint16 in the same row order. Bilinear/nearest leave the 1-pixel border
at 0 exactly like the reference (calloc'd output, interior-only loops).
"""

from __future__ import annotations

import functools

import numpy as np

from siriltpu.io.ser import (SER_BAYER_BGGR, SER_BAYER_GBRG, SER_BAYER_GRBG,
                             SER_BAYER_RGGB)
from siriltpu.utils.rounding import np_round_to_word

BAYER_PATTERNS = ("RGGB", "BGGR", "GBRG", "GRBG")


def pattern_from_ser(color_id: int) -> str:
    """retrieveSERBayerPattern (io/ser.c)."""
    return {SER_BAYER_RGGB: "RGGB", SER_BAYER_BGGR: "BGGR",
            SER_BAYER_GBRG: "GBRG", SER_BAYER_GRBG: "GRBG"}[color_id]


def _phase_offsets(pattern: str):
    """(dy, dx) of R, G1, G2, B cells within the 2x2 tile."""
    p = pattern.upper()
    pos = {p[0]: (0, 0), p[3]: (1, 1)}
    # two greens
    greens = [(0, 1), (1, 0)]
    out = {}
    out["R"] = {"RGGB": (0, 0), "BGGR": (1, 1), "GBRG": (1, 0),
                "GRBG": (0, 1)}[p]
    out["B"] = {"RGGB": (1, 1), "BGGR": (0, 0), "GBRG": (0, 1),
                "GRBG": (1, 0)}[p]
    out["G"] = [g for g in [(0, 0), (0, 1), (1, 0), (1, 1)]
                if g not in (out["R"], out["B"])]
    return out


def super_pixel(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Half-size super-pixel debayer (demosaicing.c:32-80): R and B taken
    directly, G = round((G1+G2)/2)."""
    h, w = cfa.shape
    # reference loops row < height-1, col < width-1 with step 2
    h2 = len(range(0, h - 1, 2))
    w2 = len(range(0, w - 1, 2))
    a = cfa[: 2 * h2, : 2 * w2].astype(np.float64)
    t00 = a[0::2, 0::2]
    t01 = a[0::2, 1::2]
    t10 = a[1::2, 0::2]
    t11 = a[1::2, 1::2]
    tiles = {(0, 0): t00, (0, 1): t01, (1, 0): t10, (1, 1): t11}
    off = _phase_offsets(pattern)
    r = tiles[off["R"]]
    b = tiles[off["B"]]
    g = np_round_to_word((tiles[off["G"][0]] + tiles[off["G"][1]]) / 2.0)
    out = np.stack([r.astype(np.uint16), g, b.astype(np.uint16)])
    if (h % 2) or (w % 2):
        # Odd dimensions: the reference writes h2*w2 superpixels
        # CONTIGUOUSLY (i += 3, demosaicing.c:76) into a calloc'd buffer
        # that debayer_buffer sizes and reinterprets as ceil(h/2) x
        # ceil(w/2) (demosaicing.c:713-725) -- rows wrap and the tail is
        # zeros. Reproduce that exact (buggy) layout; verified against
        # the compiled C in tests/test_c_goldens.py.
        ch = h // 2 + h % 2
        cw = w // 2 + w % 2
        flat = np.zeros(ch * cw * 3, dtype=np.uint16)
        interleaved = np.moveaxis(out, 0, -1).reshape(-1)
        flat[: interleaved.size] = interleaved
        out = np.moveaxis(flat.reshape(ch, cw, 3), -1, 0).copy()
    return out


def bilinear(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Bilinear debayer (OpenCV scheme, demosaicing.c:89-175): missing
    colors averaged from 2/4 neighbors with (sum + n/2) >> log2(n)
    integer rounding; the 1-pixel border is left at 0.

    The Bayer phases tile 2x2, so channels assemble from strided slices
    of the four neighbor aggregates — no masks, no fancy indexing."""
    h, w = cfa.shape
    a = cfa.astype(np.int32)  # sums of 4 values stay < 2^18
    off = _phase_offsets(pattern)

    cross4 = np.zeros((h, w), dtype=np.int32)
    diag4 = np.zeros((h, w), dtype=np.int32)
    horiz2 = np.zeros((h, w), dtype=np.int32)
    vert2 = np.zeros((h, w), dtype=np.int32)
    cross4[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2] +
                          a[1:-1, 2:] + 2) >> 2
    diag4[1:-1, 1:-1] = (a[:-2, :-2] + a[:-2, 2:] + a[2:, :-2] +
                         a[2:, 2:] + 2) >> 2
    horiz2[1:-1, 1:-1] = (a[1:-1, :-2] + a[1:-1, 2:] + 1) >> 1
    vert2[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + 1) >> 1

    R = np.zeros((h, w), dtype=np.int32)
    G = np.zeros((h, w), dtype=np.int32)
    B = np.zeros((h, w), dtype=np.int32)

    def sl(ph):
        return (slice(ph[0], None, 2), slice(ph[1], None, 2))

    pr, pb = off["R"], off["B"]
    R[sl(pr)] = a[sl(pr)]; G[sl(pr)] = cross4[sl(pr)]; B[sl(pr)] = diag4[sl(pr)]
    B[sl(pb)] = a[sl(pb)]; G[sl(pb)] = cross4[sl(pb)]; R[sl(pb)] = diag4[sl(pb)]
    r_row = off["R"][0]
    for pg in off["G"]:
        s = sl(pg)
        G[s] = a[s]
        if pg[0] == r_row:   # green in an R row
            R[s] = horiz2[s]; B[s] = vert2[s]
        else:                # green in a B row
            R[s] = vert2[s]; B[s] = horiz2[s]

    out = np.stack([np.clip(R, 0, 65535).astype(np.uint16),
                    np.clip(G, 0, 65535).astype(np.uint16),
                    np.clip(B, 0, 65535).astype(np.uint16)])
    out[:, 0, :] = 0; out[:, -1, :] = 0
    out[:, :, 0] = 0; out[:, :, -1] = 0
    return out


def nearest(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Nearest-neighbor debayer (bayer_NearestNeighbor,
    demosaicing.c:177-283), exact array re-derivation of the C's paired
    scan, verified against the compiled reference
    (tests/test_c_goldens.py):

    - last row and last column are black (the "black border");
    - each row alternates ``blue`` sign and ``start_with_green``;
    - a start-with-green row emits one leading pixel from its right/down
      neighbors, then the paired loop;
    - pairs: first-of-pair (and the odd tail) take (cur, right, diag),
      second-of-pair takes (right, diag, down) -- with the first/third
      channel swapped on blue<0 rows.
    """
    h, w = cfa.shape
    a = cfa.astype(np.uint16)
    out = np.zeros((3, h, w), dtype=np.uint16)
    if h < 2 or w < 2:
        return out
    blue0 = -1 if pattern.upper() in ("BGGR", "GBRG") else 1
    swg0 = 1 if pattern.upper() in ("GBRG", "GRBG") else 0

    cur = a[:-1, :-1]
    right = a[:-1, 1:]
    down = a[1:, :-1]
    diag = a[1:, 1:]
    rr, cc = np.mgrid[0: h - 1, 0: w - 1]
    blue_pos = ((rr & 1) == 0) if blue0 == 1 else ((rr & 1) == 1)
    s = swg0 ^ (rr & 1)  # per-row start_with_green
    lead = (cc == 0) & (s == 1)
    first = ~lead & (((cc - s) & 1) == 0)
    # X1 = the rgb[-blue] channel source, X2 = the rgb[blue] source
    x1 = np.where(lead, right, np.where(first, cur, right))
    g = np.where(lead, diag, np.where(first, right, diag))
    x2 = np.where(lead, down, np.where(first, diag, down))
    out[0, :-1, :-1] = np.where(blue_pos, x1, x2)
    out[1, :-1, :-1] = g
    out[2, :-1, :-1] = np.where(blue_pos, x2, x1)
    return out


def debayer_buffer(cfa: np.ndarray, pattern: str,
                   method: str = "bilinear") -> np.ndarray:
    """``debayer_buffer`` (demosaicing.c:667-728): dispatch by method;
    AHD currently maps to VNG."""
    cfa = np.asarray(cfa, dtype=np.uint16)
    method = method.lower()
    if method in ("super_pixel", "superpixel", "super-pixel"):
        return super_pixel(cfa, pattern)
    if method in ("nearest", "nearestneighbor"):
        return nearest(cfa, pattern)
    if method == "vng":
        # device path for large frames (same bits; numpy fallback is the
        # literal reference used by the parity tests)
        if cfa.size >= (1 << 20):
            try:
                return vng_device(cfa, pattern)
            except Exception:
                pass
        return vng(cfa, pattern)
    if method == "ahd":
        if cfa.size >= (1 << 20):
            try:
                return ahd_device(cfa, pattern)
            except Exception:
                pass
        return ahd(cfa, pattern)
    if method == "bilinear":
        return bilinear(cfa, pattern)
    raise ValueError(f"unknown debayer method {method}")


__all__ = ["debayer_buffer", "super_pixel", "bilinear", "nearest", "vng",
           "vng_device", "ahd", "ahd_device",
           "pattern_from_ser", "BAYER_PATTERNS"]


# ------------------------------------------------------------------- VNG

_VNG_TERMS = [
    -2, -2, +0, -1, 0, 0x01, -2, -2, +0, +0, 1, 0x01, -2, -1, -1, +0, 0, 0x01,
    -2, -1, +0, -1, 0, 0x02, -2, -1, +0, +0, 0, 0x03, -2, -1, +0, +1, 1, 0x01,
    -2, +0, +0, -1, 0, 0x06, -2, +0, +0, +0, 1, 0x02, -2, +0, +0, +1, 0, 0x03,
    -2, +1, -1, +0, 0, 0x04, -2, +1, +0, -1, 1, 0x04, -2, +1, +0, +0, 0, 0x06,
    -2, +1, +0, +1, 0, 0x02, -2, +2, +0, +0, 1, 0x04, -2, +2, +0, +1, 0, 0x04,
    -1, -2, -1, +0, 0, 0x80, -1, -2, +0, -1, 0, 0x01, -1, -2, +1, -1, 0, 0x01,
    -1, -2, +1, +0, 1, 0x01, -1, -1, -1, +1, 0, 0x88, -1, -1, +1, -2, 0, 0x40,
    -1, -1, +1, -1, 0, 0x22, -1, -1, +1, +0, 0, 0x33, -1, -1, +1, +1, 1, 0x11,
    -1, +0, -1, +2, 0, 0x08, -1, +0, +0, -1, 0, 0x44, -1, +0, +0, +1, 0, 0x11,
    -1, +0, +1, -2, 1, 0x40, -1, +0, +1, -1, 0, 0x66, -1, +0, +1, +0, 1, 0x22,
    -1, +0, +1, +1, 0, 0x33, -1, +0, +1, +2, 1, 0x10, -1, +1, +1, -1, 1, 0x44,
    -1, +1, +1, +0, 0, 0x66, -1, +1, +1, +1, 0, 0x22, -1, +1, +1, +2, 0, 0x10,
    -1, +2, +0, +1, 0, 0x04, -1, +2, +1, +0, 1, 0x04, -1, +2, +1, +1, 0, 0x04,
    +0, -2, +0, +0, 1, 0x80, +0, -1, +0, +1, 1, 0x88, +0, -1, +1, -2, 0, 0x40,
    +0, -1, +1, +0, 0, 0x11, +0, -1, +2, -2, 0, 0x40, +0, -1, +2, -1, 0, 0x20,
    +0, -1, +2, +0, 0, 0x30, +0, -1, +2, +1, 1, 0x10, +0, +0, +0, +2, 1, 0x08,
    +0, +0, +2, -2, 1, 0x40, +0, +0, +2, -1, 0, 0x60, +0, +0, +2, +0, 1, 0x20,
    +0, +0, +2, +1, 0, 0x30, +0, +0, +2, +2, 1, 0x10, +0, +1, +1, +0, 0, 0x44,
    +0, +1, +1, +2, 0, 0x10, +0, +1, +2, -1, 1, 0x40, +0, +1, +2, +0, 0, 0x60,
    +0, +1, +2, +1, 0, 0x20, +0, +1, +2, +2, 0, 0x10, +1, -2, +1, +0, 0, 0x80,
    +1, -1, +1, +1, 0, 0x88, +1, +0, +1, +2, 0, 0x08, +1, +0, +2, -1, 0, 0x40,
    +1, +0, +2, +1, 0, 0x10,
]
_VNG_CHOOD = [-1, -1, -1, 0, -1, +1, 0, +1, +1, +1, +1, 0, +1, -1, 0, -1]

_VNG_FILTERS = {"BGGR": 0x16161616, "GRBG": 0x61616161,
                "RGGB": 0x94949494, "GBRG": 0x49494949}


def _fc(filters: int, row: int, col: int) -> int:
    return (filters >> ((((row << 1) & 14) + (col & 1)) << 1)) & 3


def vng(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """VNG demosaic — an exact array-program port of the dcraw-derived
    ``bayer_VNG`` (demosaicing.c:246-421).

    The reference delays write-back by two rows, so every gradient and
    neighbor read sees BILINEAR values; reading from the bilinear result
    and writing a fresh output reproduces it exactly. Pixels sharing
    (row & 7, col & 1) share the precalculated code table, so each of
    the 16 classes vectorizes over a strided subgrid.
    """
    cfa = np.asarray(cfa, dtype=np.uint16)
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    rgb = bilinear(cfa, pattern)
    img = rgb.astype(np.int32)  # diffs << 2 and 8-term sums stay < 2^22
    out = rgb.copy()

    for r8 in range(8):
        # rows in [2, h-2) with row & 7 == r8 form an arithmetic slice:
        # strided VIEWS replace np.ix_ fancy-index copies (the old form
        # made ~1000 copying gathers per image)
        start_r = r8 if r8 >= 2 else r8 + 8
        if start_r >= h - 2:
            continue
        nrows = len(range(start_r, h - 2, 8))
        for c2 in range(2):
            start_c = c2 if c2 >= 2 else c2 + 2
            if start_c >= w - 2:
                continue
            ncols = len(range(start_c, w - 2, 2))

            def sub(ch, dy, dx):
                return img[ch,
                           start_r + dy : start_r + dy + 8 * nrows : 8,
                           start_c + dx : start_c + dx + 2 * ncols : 2]

            color = _fc(filters, r8, c2)
            # ---- gradients (bayervng_terms decode, demosaicing.c:316-341)
            gval = np.zeros((8, nrows, ncols), dtype=np.int32)
            t = 0
            while t < len(_VNG_TERMS):
                y1, x1, y2, x2, weight, grads = _VNG_TERMS[t : t + 6]
                t += 6
                c1 = _fc(filters, r8 + y1, c2 + x1)
                if _fc(filters, r8 + y2, c2 + x2) != c1:
                    continue
                diag = 2 if (_fc(filters, r8, c2 + 1) == c1 and
                             _fc(filters, r8 + 1, c2) == c1) else 1
                if abs(y1 - y2) == diag and abs(x1 - x2) == diag:
                    continue
                diff = np.abs(sub(c1, y1, x1) -
                              sub(c1, y2, x2)) << weight
                for g in range(8):
                    if grads & (1 << g):
                        gval[g] += diff
            gmin = gval.min(axis=0)
            gmax = gval.max(axis=0)
            thold = gmin + (gmax >> 1)
            # ---- average the low-gradient directions (chood decode)
            sums = np.zeros((3, nrows, ncols), dtype=np.int32)
            num = np.zeros((nrows, ncols), dtype=np.int32)
            for g in range(8):
                dy, dx = _VNG_CHOOD[2 * g], _VNG_CHOOD[2 * g + 1]
                pair = (_fc(filters, r8 + dy, c2 + dx) != color and
                        _fc(filters, r8 + 2 * dy, c2 + 2 * dx) == color)
                use = gval[g] <= thold
                for c in range(3):
                    if c == color and pair:
                        contrib = (sub(c, 0, 0) +
                                   sub(color, 2 * dy, 2 * dx)) >> 1
                    else:
                        contrib = sub(c, dy, dx)
                    sums[c] += np.where(use, contrib, 0)
                num += use
            center = sub(color, 0, 0)
            numsafe = np.maximum(num, 1)
            for c in range(3):
                tval = center.astype(np.float64)
                if True:
                    dsum = sums[c] - sums[color]
                    # C integer division truncates toward zero
                    q = np.trunc(dsum / numsafe)
                    tval = np.where(c == color, tval, tval + q)
                vals = np_round_to_word(tval)
                keep = gmax == 0  # untouched pixels keep bilinear values
                view = out[c,
                           start_r : start_r + 8 * nrows : 8,
                           start_c : start_c + 2 * ncols : 2]
                view[...] = np.where(keep, view, vals)
    return out




# --------------------------------------------------------- device AHD

@functools.lru_cache(maxsize=8)
def _ahd_jax_fn(h: int, w: int, filters: int):
    """jit-compiled whole-image AHD for one (shape, pattern) — the same
    program as :func:`ahd` in jnp. int32 arithmetic everywhere it is
    exact; the two float32 spots (CIELAB xyz rounding, chroma-difference
    squares) can differ from the f64/int64 host reference only on
    knife-edge ties at extreme local chroma jumps (PARITY.md #7)."""
    import jax
    import jax.numpy as jnp

    yy0, xx0 = np.mgrid[0:h, 0:w]
    fcmap_np = (filters >> (((((yy0 << 1) & 14) + (xx0 & 1))) << 1)) & 3

    global _CBRT_LUT
    if _CBRT_LUT is None:
        _CBRT_LUT = _ahd_cbrt_lut()
    xyz_cam_np = (_XYZ_RGB / _D65[:, None]).astype(np.float32)

    def shift(a, dy, dx):
        """out[y, x] = a[y - dy, x - dx], zero fill (matches host)."""
        pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
        ap = jnp.pad(a, pad)
        return ap[max(-dy, 0) : max(-dy, 0) + h,
                  max(-dx, 0) : max(-dx, 0) + w]

    def cam_to_lab(rgb3, lut):
        cam = rgb3.astype(jnp.float32)
        # explicit elementwise 3x3 transform: a float32 matmul may run
        # in TF32 on a GPU and shift the LUT index by hundreds
        M = xyz_cam_np
        xyz = jnp.stack([
            M[c, 0] * cam[0] + M[c, 1] * cam[1] + M[c, 2] * cam[2]
            for c in range(3)]) + 0.5
        idx = jnp.clip(jnp.floor(xyz + 0.5), 0, 65535).astype(jnp.int32)
        f = lut[idx]
        L = 116.0 * f[1] - 16.0
        a = 500.0 * (f[0] - f[1])
        b = 200.0 * (f[1] - f[2])
        lab = jnp.stack([L, a, b]) * 64.0
        return jnp.trunc(lab).astype(jnp.int32)

    def run(cfa_u16, fcmap, lut):
        cfa = cfa_u16.astype(jnp.int32)
        at = [fcmap == c for c in range(3)]
        dst = jnp.stack([jnp.where(at[c], cfa, 0) for c in range(3)])

        # border_interpolate(3)
        iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        is_border = (iy < 3) | (iy >= h - 3) | (ix < 3) | (ix >= w - 3)
        newdst = []
        for c in range(3):
            known = at[c].astype(jnp.int32)
            vals = jnp.where(at[c], cfa, 0)
            s3 = sum(shift(vals, dy, dx)
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1))
            c3 = sum(shift(known, dy, dx)
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1))
            fill = is_border & (~at[c]) & (c3 > 0)
            newdst.append(jnp.where(fill, s3 // jnp.maximum(c3, 1),
                                    dst[c]))
        dst = jnp.stack(newdst)
        g_cfa = dst[1]
        own = cfa
        nong = ~at[1]

        valid_g = ((iy >= 2) & (iy < h - 2) & (ix >= 2) & (ix < w - 2)
                   & nong)
        gl = shift(g_cfa, 0, 1)
        gr = shift(g_cfa, 0, -1)
        vh = ((gl + own + gr) * 2 - shift(own, 0, 2)
              - shift(own, 0, -2)) >> 2
        gh = jnp.clip(vh, jnp.minimum(gl, gr), jnp.maximum(gl, gr))
        gu = shift(g_cfa, 1, 0)
        gd = shift(g_cfa, -1, 0)
        vv = ((gu + own + gd) * 2 - shift(own, 2, 0)
              - shift(own, -2, 0)) >> 2
        gv = jnp.clip(vv, jnp.minimum(gu, gd), jnp.maximum(gu, gd))

        inner = (iy >= 1) & (iy < h - 1) & (ix >= 1) & (ix < w - 1)
        c_below = jnp.roll(fcmap, -1, axis=0)
        outs, labs = [], []
        for gcand in (gh, gv):
            G = jnp.where(valid_g, gcand, 0)
            G = jnp.where(at[1], own, G)
            ch = [jnp.zeros((h, w), jnp.int32), G,
                  jnp.zeros((h, w), jnp.int32)]
            for cb in (0, 2):
                m = at[1] & inner & (c_below == cb)
                hcol = 2 - cb
                val_h = own + ((shift(dst[hcol], 0, 1)
                                + shift(dst[hcol], 0, -1)
                                - shift(G, 0, 1) - shift(G, 0, -1)) >> 1)
                val_v = own + ((shift(dst[cb], 1, 0)
                                + shift(dst[cb], -1, 0)
                                - shift(G, 1, 0) - shift(G, -1, 0)) >> 1)
                ch[hcol] = jnp.where(m, jnp.clip(val_h, 0, 65535),
                                     ch[hcol])
                ch[cb] = jnp.where(m, jnp.clip(val_v, 0, 65535), ch[cb])
            diag_g = (shift(G, 1, 1) + shift(G, 1, -1)
                      + shift(G, -1, 1) + shift(G, -1, -1))
            for fc_ in (0, 2):
                o = 2 - fc_
                m = at[fc_] & inner
                diag_o = (shift(dst[o], 1, 1) + shift(dst[o], 1, -1)
                          + shift(dst[o], -1, 1) + shift(dst[o], -1, -1))
                val = G + ((diag_o - diag_g + 1) >> 2)
                ch[o] = jnp.where(m, jnp.clip(val, 0, 65535), ch[o])
                ch[fc_] = jnp.where(m, own, ch[fc_])
            rgbd = jnp.stack(ch)
            outs.append(rgbd)
            labs.append(cam_to_lab(rgbd, lut))

        dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))
        ldiff = [[None] * 4 for _ in range(2)]
        abdiff = [[None] * 4 for _ in range(2)]
        for d in range(2):
            L, A, B = labs[d][0], labs[d][1], labs[d][2]
            for i, (dy, dx) in enumerate(dirs):
                ldiff[d][i] = jnp.abs(L - shift(L, dy, dx))
                da = (A - shift(A, dy, dx)).astype(jnp.float32)
                db = (B - shift(B, dy, dx)).astype(jnp.float32)
                abdiff[d][i] = da * da + db * db
        leps = jnp.minimum(jnp.maximum(ldiff[0][0], ldiff[0][1]),
                           jnp.maximum(ldiff[1][2], ldiff[1][3]))
        abeps = jnp.minimum(jnp.maximum(abdiff[0][0], abdiff[0][1]),
                            jnp.maximum(abdiff[1][2], abdiff[1][3]))
        hvalid = (iy >= 2) & (iy < h - 2) & (ix >= 2) & (ix < w - 2)
        homo = []
        for d in range(2):
            acc = jnp.zeros((h, w), jnp.int32)
            for i in range(4):
                acc = acc + (hvalid & (ldiff[d][i] <= leps)
                             & (abdiff[d][i] <= abeps)).astype(jnp.int32)
            homo.append(acc)
        hm = [sum(shift(homo[d], dy, dx)
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1))
              for d in range(2)]
        final = (iy >= 3) & (iy < h - 3) & (ix >= 3) & (ix < w - 3)
        use_v = hm[1] > hm[0]
        tie = hm[0] == hm[1]
        res = []
        for c in range(3):
            pick = jnp.where(use_v, outs[1][c], outs[0][c])
            avg = (outs[0][c] + outs[1][c]) >> 1
            val = jnp.where(tie, avg, pick)
            res.append(jnp.where(final, jnp.clip(val, 0, 65535), dst[c]))
        return jnp.clip(jnp.stack(res), 0, 65535).astype(jnp.uint16)

    jitted = jax.jit(run)
    import jax.numpy as jnp2
    fc_dev = jnp2.asarray(fcmap_np.astype(np.int32))
    lut_dev = jnp2.asarray(_CBRT_LUT.astype(np.float32))
    return lambda cfa: jitted(cfa, fc_dev, lut_dev)


def ahd_device(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """AHD on the accelerator; see :func:`_ahd_jax_fn` for the two f32
    knife-edge caveats vs the int64/f64 host reference."""
    cfa = np.asarray(cfa, dtype=np.uint16)
    h, w = cfa.shape
    import jax.numpy as jnp
    fn = _ahd_jax_fn(h, w, _VNG_FILTERS[pattern.upper()])
    return np.asarray(fn(jnp.asarray(cfa)))


# --------------------------------------------------------- device VNG

@functools.lru_cache(maxsize=8)
def _vng_jax_fn(h: int, w: int, filters: int):
    """jit-compiled whole-image VNG for one (shape, pattern): the same
    16-class strided-slice program as :func:`vng`, in integer jnp ops
    (bit-exact — every quantity is an int32; the C truncating division
    is sign * (|dsum| // num))."""
    import jax
    import jax.numpy as jnp

    def _bilinear_dev(cfa):
        """Device bilinear, same integer semantics as :func:`bilinear`:
        neighbor aggregates from shifted adds, per-phase select by
        parity masks (pure elementwise — no scatters)."""
        a = cfa.astype(jnp.int32)
        z = jnp.zeros((h, w), jnp.int32)
        cross4 = z.at[1:-1, 1:-1].set(
            (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2] + a[1:-1, 2:] + 2)
            >> 2)
        diag4 = z.at[1:-1, 1:-1].set(
            (a[:-2, :-2] + a[:-2, 2:] + a[2:, :-2] + a[2:, 2:] + 2) >> 2)
        horiz2 = z.at[1:-1, 1:-1].set((a[1:-1, :-2] + a[1:-1, 2:] + 1) >> 1)
        vert2 = z.at[1:-1, 1:-1].set((a[:-2, 1:-1] + a[2:, 1:-1] + 1) >> 1)
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) & 1
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) & 1
        # phase of each pixel: color index via _fc on the 2x2 parity
        col_of = [[_fc(filters, py, px) for px in (0, 1)] for py in (0, 1)]
        at = {}
        for py in (0, 1):
            for px in (0, 1):
                at[(py, px)] = (yy == py) & (xx == px)
        is_r = jnp.zeros((h, w), bool)
        is_b = jnp.zeros((h, w), bool)
        is_g = jnp.zeros((h, w), bool)
        for py in (0, 1):
            for px in (0, 1):
                m = at[(py, px)]
                c = col_of[py][px]
                if c == 0:
                    is_r = is_r | m
                    r_row = py
                elif c == 2:
                    is_b = is_b | m
                else:
                    is_g = is_g | m
        in_r_row = (yy == r_row)
        R = jnp.where(is_r, a, jnp.where(is_b, diag4,
                      jnp.where(in_r_row, horiz2, vert2)))
        G = jnp.where(is_g, a, cross4)
        B = jnp.where(is_b, a, jnp.where(is_r, diag4,
                      jnp.where(in_r_row, vert2, horiz2)))
        rgb = jnp.stack([R, G, B])
        rgb = jnp.clip(rgb, 0, 65535)
        border = ((jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) % (h - 1)
                   == 0) |
                  (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) % (w - 1)
                   == 0))
        return jnp.where(border[None], 0, rgb)

    def run(cfa):  # (h, w) uint16 CFA
        img = _bilinear_dev(cfa)
        # Space-to-depth: pad to (hp, wp) = multiples of (8, 2) plus one
        # spare block each way, then view as per-phase planes
        # (3, 8, 2, hp//8, wp//2). Every class access below becomes a
        # CONTIGUOUS slice of a phase plane instead of a stride-8/stride-2
        # gather, and the per-class output store becomes one contiguous
        # block write instead of a strided one.
        # Padded cells never reach a real output: classes only write rows
        # [2, h-2) x cols [2, w-2) and their terms span +-2.
        hp = ((h + 7) // 8 + 1) * 8
        wp = ((w + 1) // 2 + 2) * 2
        imgp = jnp.pad(img, ((0, 0), (0, hp - h), (0, wp - w)))
        hp8, wp2 = hp // 8, wp // 2
        # one strided extraction per (channel, row-phase, col-phase): all
        # later class accesses are contiguous slices of these 2-D planes.
        # (Keeping a 5-D space-to-depth tensor around instead makes XLA
        # pick 130x-padded layouts for its slices and OOM.)
        planes = [[[imgp[c, p::8, pc::2] for pc in range(2)]
                   for p in range(8)] for c in range(3)]
        out_planes = [[[planes[c][p][pc] for pc in range(2)]
                       for p in range(8)] for c in range(3)]
        for r8 in range(8):
            start_r = r8 if r8 >= 2 else r8 + 8
            if start_r >= h - 2:
                continue
            nrows = len(range(start_r, h - 2, 8))
            for c2 in range(2):
                start_c = c2 if c2 >= 2 else c2 + 2
                if start_c >= w - 2:
                    continue
                ncols = len(range(start_c, w - 2, 2))

                def sub(ch, dy, dx):
                    g0 = start_r + dy
                    c0 = start_c + dx
                    q, p = g0 >> 3, g0 & 7
                    qc, pc = c0 >> 1, c0 & 1
                    return planes[ch][p][pc][q : q + nrows,
                                             qc : qc + ncols]

                color = _fc(filters, r8, c2)
                gval = [jnp.zeros((nrows, ncols), jnp.int32)
                        for _ in range(8)]
                t = 0
                while t < len(_VNG_TERMS):
                    y1, x1, y2, x2, weight, grads = _VNG_TERMS[t : t + 6]
                    t += 6
                    c1 = _fc(filters, r8 + y1, c2 + x1)
                    if _fc(filters, r8 + y2, c2 + x2) != c1:
                        continue
                    diag = 2 if (_fc(filters, r8, c2 + 1) == c1 and
                                 _fc(filters, r8 + 1, c2) == c1) else 1
                    if abs(y1 - y2) == diag and abs(x1 - x2) == diag:
                        continue
                    diff = jnp.abs(sub(c1, y1, x1) -
                                   sub(c1, y2, x2)) << weight
                    for g in range(8):
                        if grads & (1 << g):
                            gval[g] = gval[g] + diff
                gval = jnp.stack(gval)
                gmin = gval.min(axis=0)
                gmax = gval.max(axis=0)
                thold = gmin + (gmax >> 1)
                sums = [jnp.zeros((nrows, ncols), jnp.int32)
                        for _ in range(3)]
                num = jnp.zeros((nrows, ncols), jnp.int32)
                for g in range(8):
                    dy, dx = _VNG_CHOOD[2 * g], _VNG_CHOOD[2 * g + 1]
                    pair = (_fc(filters, r8 + dy, c2 + dx) != color and
                            _fc(filters, r8 + 2 * dy, c2 + 2 * dx) == color)
                    use = gval[g] <= thold
                    for c in range(3):
                        if c == color and pair:
                            contrib = (sub(c, 0, 0) +
                                       sub(color, 2 * dy, 2 * dx)) >> 1
                        else:
                            contrib = sub(c, dy, dx)
                        sums[c] = sums[c] + jnp.where(use, contrib, 0)
                    num = num + use.astype(jnp.int32)
                center = sub(color, 0, 0)
                numsafe = jnp.maximum(num, 1)
                keep = gmax == 0
                q0, qc0 = start_r >> 3, start_c >> 1
                for c in range(3):
                    if c == color:
                        vals = jnp.clip(center, 0, 65535)
                    else:
                        dsum = sums[c] - sums[color]
                        qv = jnp.sign(dsum) * (jnp.abs(dsum) // numsafe)
                        vals = jnp.clip(center + qv, 0, 65535)
                    view = out_planes[c][r8][c2][q0 : q0 + nrows,
                                                 qc0 : qc0 + ncols]
                    out_planes[c][r8][c2] = out_planes[c][r8][c2].at[
                        q0 : q0 + nrows, qc0 : qc0 + ncols].set(
                        jnp.where(keep, view, vals))
        out = imgp
        for c in range(3):
            for p in range(8):
                for pc in range(2):
                    out = out.at[c, p::8, pc::2].set(out_planes[c][p][pc])
        return out[:, :h, :w].astype(jnp.uint16)

    return jax.jit(run)


def vng_device(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """VNG on the accelerator: bilinear on host (cheap, strided) feeds
    the jitted 16-class program. Bit-identical to :func:`vng`."""
    cfa = np.asarray(cfa, dtype=np.uint16)
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    import jax.numpy as jnp
    fn = _vng_jax_fn(h, w, filters)
    return np.asarray(fn(jnp.asarray(cfa)))


# ------------------------------------------------------------------- AHD

_XYZ_RGB = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _ahd_cbrt_lut() -> np.ndarray:
    i = np.arange(0x10000, dtype=np.float32)
    r = i / np.float32(65535.0)
    return np.where(r > 0.008856, np.cbrt(r),
                    np.float32(7.787) * r + np.float32(16.0 / 116)
                    ).astype(np.float32)


_CBRT_LUT = None


def _cam_to_lab64(rgb3: np.ndarray) -> np.ndarray:
    """cam_to_cielab (demosaicing.c:433-466) vectorized: rgb3 (3, H, W)
    uint16 -> int16 lab*64 (C truncation to short)."""
    global _CBRT_LUT
    if _CBRT_LUT is None:
        _CBRT_LUT = _ahd_cbrt_lut()
    xyz_cam = (_XYZ_RGB / _D65[:, None]).astype(np.float32)
    cam = rgb3.astype(np.float32)
    xyz = np.tensordot(xyz_cam, cam, axes=1) + np.float32(0.5)
    idx = np_round_to_word(xyz.astype(np.float64))
    f = _CBRT_LUT[idx]
    L = np.float32(116) * f[1] - np.float32(16)
    a = np.float32(500) * (f[0] - f[1])
    b = np.float32(200) * (f[1] - f[2])
    lab = np.stack([L, a, b]) * np.float32(64)
    return np.trunc(lab).astype(np.int16)


def ahd(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """AHD demosaic — exact array-program port of the dcraw-derived
    ``bayer_AHD`` (demosaicing.c:473-665, Hirakawa-Parks adaptive
    homogeneity-directed interpolation).

    The reference tiles at TS=256 purely to bound memory; the dependency
    cone of every output pixel is identical in a full-image computation
    (verified against a literal transcription), so each step vectorizes:
    green H/V candidates, R/B from green differences, CIELAB via the
    cbrt LUT, homogeneity maps, 3x3 homogeneity vote.
    """
    cfa = np.asarray(cfa, dtype=np.int64)
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    yy, xx = np.mgrid[0:h, 0:w]
    fcmap = (((yy << 1) & 14) + (xx & 1))
    fcmap = (filters >> (fcmap << 1)) & 3

    # known CFA values placed; everything else 0
    dst = np.zeros((3, h, w), dtype=np.int64)
    for c in range(3):
        m = fcmap == c
        dst[c][m] = cfa[m]

    # ---- border_interpolate(3) (demosaicing.c:521-546)
    border = 3
    is_border = np.zeros((h, w), dtype=bool)
    is_border[:border, :] = True
    is_border[h - border :, :] = True
    is_border[:, :border] = True
    is_border[:, w - border :] = True
    for c in range(3):
        known = (fcmap == c).astype(np.int64)
        vals = np.where(fcmap == c, cfa, 0)
        ps = np.pad(vals, 1)
        pc = np.pad(known, 1)
        s3 = sum(ps[dy : dy + h, dx : dx + w]
                 for dy in range(3) for dx in range(3))
        c3 = sum(pc[dy : dy + h, dx : dx + w]
                 for dy in range(3) for dx in range(3))
        fill = is_border & (fcmap != c) & (c3 > 0)
        dst[c][fill] = (s3[fill] // np.maximum(c3[fill], 1))

    g_cfa = dst[1]

    def shift(a, dy, dx, fill=0):
        out = np.full_like(a, fill)
        ys0, ys1 = max(dy, 0), min(h + dy, h)
        xs0, xs1 = max(dx, 0), min(w + dx, w)
        out[ys0:ys1, xs0:xs1] = a[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
        return out

    nong = fcmap != 1
    # value of the pixel's own CFA color at every position
    own = cfa

    # ---- green H / V candidates at non-green positions (:560-577)
    valid_g = np.zeros((h, w), dtype=bool)
    valid_g[2 : h - 2, 2 : w - 2] = True
    valid_g &= nong
    gl = shift(g_cfa, 0, 1)    # green at col-1 (value from left)
    gr = shift(g_cfa, 0, -1)   # green at col+1
    fl2 = shift(own, 0, 2)
    fr2 = shift(own, 0, -2)
    vh = ((gl + own + gr) * 2 - fl2 - fr2) >> 2
    gh = np.clip(vh, np.minimum(gl, gr), np.maximum(gl, gr))  # ULIM
    gu = shift(g_cfa, 1, 0)
    gd = shift(g_cfa, -1, 0)
    fu2 = shift(own, 2, 0)
    fd2 = shift(own, -2, 0)
    vv = ((gu + own + gd) * 2 - fu2 - fd2) >> 2
    gv = np.clip(vv, np.minimum(gu, gd), np.maximum(gu, gd))

    out = [np.zeros((3, h, w), dtype=np.int64), None]
    labs = [None, None]
    inner = np.zeros((h, w), dtype=bool)
    inner[1 : h - 1, 1 : w - 1] = True
    at_g = fcmap == 1
    for d, gcand in enumerate((gh, gv)):
        G = np.where(valid_g, gcand, 0)
        G = np.where(at_g, own, G)  # greens keep their CFA value
        rgbd = np.zeros((3, h, w), dtype=np.int64)
        rgbd[1] = G
        # at green pixels: c = FC(row+1, col) (:585-596)
        c_below = np.roll(fcmap, -1, axis=0)
        for cb in (0, 2):
            m = at_g & inner & (c_below == cb)
            hcol = 2 - cb
            val_h = own + ((shift(dst[hcol], 0, 1) + shift(dst[hcol], 0, -1)
                            - shift(G, 0, 1) - shift(G, 0, -1)) >> 1)
            val_v = own + ((shift(dst[cb], 1, 0) + shift(dst[cb], -1, 0)
                            - shift(G, 1, 0) - shift(G, -1, 0)) >> 1)
            rgbd[hcol][m] = np.clip(val_h, 0, 65535)[m]
            rgbd[cb][m] = np.clip(val_v, 0, 65535)[m]
        # at non-green pixels: opposite color from diagonals (:597-607)
        diag_g = (shift(G, 1, 1) + shift(G, 1, -1) +
                  shift(G, -1, 1) + shift(G, -1, -1))
        for fc_ in (0, 2):
            o = 2 - fc_
            m = (fcmap == fc_) & inner
            diag_o = (shift(dst[o], 1, 1) + shift(dst[o], 1, -1) +
                      shift(dst[o], -1, 1) + shift(dst[o], -1, -1))
            val = G + ((diag_o - diag_g + 1) >> 2)
            rgbd[o][m] = np.clip(val, 0, 65535)[m]
            rgbd[fc_][m] = own[m]
        out[d] = rgbd
        labs[d] = _cam_to_lab64(rgbd.astype(np.uint16))

    # ---- homogeneity maps (:609-637); dirs: col-1, col+1, row-1, row+1
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))
    ldiff = np.zeros((2, 4, h, w), dtype=np.int64)
    abdiff = np.zeros((2, 4, h, w), dtype=np.int64)
    for d in range(2):
        L = labs[d][0].astype(np.int64)
        A = labs[d][1].astype(np.int64)
        B = labs[d][2].astype(np.int64)
        for i, (dy, dx) in enumerate(dirs):
            ldiff[d, i] = np.abs(L - shift(L, dy, dx))
            abdiff[d, i] = ((A - shift(A, dy, dx)) ** 2 +
                            (B - shift(B, dy, dx)) ** 2)
    leps = np.minimum(np.maximum(ldiff[0, 0], ldiff[0, 1]),
                      np.maximum(ldiff[1, 2], ldiff[1, 3]))
    abeps = np.minimum(np.maximum(abdiff[0, 0], abdiff[0, 1]),
                       np.maximum(abdiff[1, 2], abdiff[1, 3]))
    homo = np.zeros((2, h, w), dtype=np.int64)
    hvalid = np.zeros((h, w), dtype=bool)
    hvalid[2 : h - 2, 2 : w - 2] = True
    for d in range(2):
        for i in range(4):
            homo[d] += (hvalid & (ldiff[d, i] <= leps) &
                        (abdiff[d, i] <= abeps))

    # ---- combine (:639-658): 3x3 homogeneity vote on rows/cols [3, n-4]
    hm = np.zeros((2, h, w), dtype=np.int64)
    for d in range(2):
        p = np.pad(homo[d], 1)
        hm[d] = sum(p[dy : dy + h, dx : dx + w]
                    for dy in range(3) for dx in range(3))
    final = np.zeros((h, w), dtype=bool)
    final[3 : h - 3, 3 : w - 3] = True
    use_v = hm[1] > hm[0]
    tie = hm[0] == hm[1]
    result = dst.copy()
    for c in range(3):
        pick = np.where(use_v, out[1][c], out[0][c])
        avg = (out[0][c] + out[1][c]) >> 1
        val = np.where(tie, avg, pick)
        result[c][final] = np.clip(val, 0, 65535)[final]
    return np.clip(result, 0, 65535).astype(np.uint16)

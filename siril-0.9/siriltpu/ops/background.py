"""Background extraction: polynomial gradient fit over a grid of sample
boxes.

Reference: src/algos/gradient.c — box grid construction
(``buildBoxesAutomatically`` :77-186), per-box robust value (sigma-clip
replace-by-median then median), box rejection (deviation·sigma high side,
deviation·unbalance low side :177-183), weighted least-squares polynomial
fit of order 1–4 (3/6/10/15 params, :34-37, ``computeBackground``
:188-300), model stored via the reference's bare (WORD) truncation
cast (verified against the compiled C in test_c_goldens).

Device mapping: per-box statistics are a blocked reduction; the polynomial
evaluation over the full image is a fused Vandermonde combination on
device (vmapped powers) — but sizes are tiny, so host NumPy float64 is
used for exactness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


NPARAMS = {1: 3, 2: 6, 3: 10, 4: 15}


@dataclass
class BackgroundParams:
    """newBackground knobs (gradient.h / GUI defaults)."""
    order: int = 4
    box: int = 20
    boxes_per_row: int = 10
    boxes_per_col: int = 10
    tolerance: float = 2.0
    deviation: float = 1.0
    unbalance: float = 0.8


def _poly_terms(x: np.ndarray, y: np.ndarray, order: int) -> np.ndarray:
    """Columns of the design matrix in the reference's exact order
    (gradient.c:42-75)."""
    cols = [np.ones_like(x), x, y]
    if order >= 2:
        cols += [x * x, y * x, y * y]
    if order >= 3:
        cols += [x ** 3, x * x * y, x * y * y, y ** 3]
    if order >= 4:
        cols += [x ** 4, x ** 3 * y, x * x * y * y, x * y ** 3, y ** 4]
    return np.stack(cols, axis=-1)


# (x-power, y-power) of each design-matrix column, reference order
_TERM_POWERS = [(0, 0), (1, 0), (0, 1),
                (2, 0), (1, 1), (0, 2),
                (3, 0), (2, 1), (1, 2), (0, 3),
                (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)]


def build_background_samples(layer: np.ndarray, params: BackgroundParams
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Box grid + robust per-box values (buildBoxesAutomatically).

    Returns (cols, rows, values) with rejected boxes marked value = -1.
    ``layer`` is float64 (the reference converts WORD->double MatR).
    """
    p = params
    height, width = layer.shape
    midbox = int(p.box * 0.5)
    nboxes = p.boxes_per_row * p.boxes_per_col
    if nboxes < NPARAMS[p.order]:
        raise ValueError("not enough boxes for the polynomial order")
    # The reference converts the WHOLE image to a double MatR and
    # mutates it in place (gradient.c:97,144-153); but only box pixels
    # are ever read, and with the default geometry (box 20, grid steps
    # of hundreds of px) boxes never overlap, so per-box f64 copies are
    # observationally identical — and skip a 200 MB full-image copy per
    # 6K channel (the dominant cost of bgextract on this host).
    step_r = (height - 2 * midbox) // (p.boxes_per_col - 1)
    step_c = (width - 2 * midbox) // (p.boxes_per_row - 1)
    if p.box > min(step_r, step_c):
        # overlapping boxes: fall back to the literal shared matrix so
        # cross-box mutations stay visible
        mat = layer.astype(np.float64)
        box_of = lambda sr, sc: mat[sr:sr + p.box, sc:sc + p.box]
    else:
        box_of = lambda sr, sc: layer[sr:sr + p.box,
                                      sc:sc + p.box].astype(np.float64)

    row_pos = np.empty(p.boxes_per_col)
    col_pos = np.empty(p.boxes_per_row)
    tmp = midbox - 1.0
    for i in range(p.boxes_per_col):
        row_pos[i] = tmp
        tmp += step_r
    tmp = midbox - 1.0
    for i in range(p.boxes_per_row):
        col_pos[i] = tmp
        tmp += step_c

    rows = np.empty(nboxes)
    cols = np.empty(nboxes)
    vals = np.empty(nboxes)
    k = 0
    for r in range(p.boxes_per_col):
        sr = int(round(row_pos[r] - midbox + 1))
        for c in range(p.boxes_per_row):
            sc = int(round(col_pos[c] - midbox + 1))
            boxdata = box_of(sr, sc)
            flat = boxdata.reshape(-1)
            sigma = flat.std(ddof=1)
            median = _gsl_median(np.sort(flat))
            # replace outliers by the median IN the matrix (the reference
            # mutates MatR, gradient.c:144-153)
            mask = boxdata > (p.tolerance * sigma + median)
            boxdata[mask] = median
            value = _gsl_median(np.sort(boxdata.reshape(-1)))
            rows[k] = row_pos[r]
            cols[k] = col_pos[c]
            vals[k] = value
            k += 1

    med = _gsl_median(np.sort(vals.copy()))
    sig = vals.std(ddof=1)
    reject = ((vals - med) / sig > params.deviation) | \
             ((med - vals) / sig > params.deviation * params.unbalance)
    vals = np.where(reject, -1.0, vals)
    return cols, rows, vals


def _gsl_median(s: np.ndarray) -> float:
    n = s.size
    if n == 0:
        return 0.0
    if n % 2:
        return float(s[(n - 1) // 2])
    return (float(s[n // 2 - 1]) + float(s[n // 2])) / 2.0


def compute_background(layer: np.ndarray,
                       params: Optional[BackgroundParams] = None
                       ) -> np.ndarray:
    """Full background model of one layer (float64 image values in/out).
    ``layer`` is the bottom-up uint16 data; the returned model is float64
    (computeBackground, clamped at 0)."""
    p = params or BackgroundParams()
    height, width = layer.shape
    cols, rows, vals = build_background_samples(layer, p)
    ok = vals >= 0
    if ok.sum() < NPARAMS[p.order]:
        raise ValueError("not enough valid background samples")
    A = _poly_terms(cols[ok], rows[ok], p.order)
    # column balancing as in gsl_multifit_linear (modified Golub-Reinsch
    # SVD with column scaling): raw pixel coords give x^4 ~ 1e15 columns
    # whose unbalanced SVD zeroes small singular values and produces a
    # catastrophically wrong corner extrapolation.
    scale = np.linalg.norm(A, axis=0)
    scale[scale == 0] = 1.0
    coef, *_ = np.linalg.lstsq(A / scale, vals[ok], rcond=None)
    coef = coef / scale
    # full-image evaluation: the polynomial is separable, so build the
    # (deg+1, deg+1) coefficient grid and evaluate as Y_pows @ C @ X_pows^T
    # (three small matmuls) instead of a (H*W, nparams) term matrix of
    # libm pow() calls (~200s at 6K x 4K).
    deg = p.order
    C = np.zeros((deg + 1, deg + 1))
    for k, (i, j) in enumerate(_TERM_POWERS[: len(coef)]):
        C[j, i] = coef[k]
    xp = np.vander(np.arange(width, dtype=np.float64), deg + 1,
                   increasing=True)
    yp = np.vander(np.arange(height, dtype=np.float64), deg + 1,
                   increasing=True)
    model = yp @ C @ xp.T
    return model


def extract_background(data: np.ndarray,
                       params: Optional[BackgroundParams] = None
                       ) -> np.ndarray:
    """Background image of a (C, H, W) frame as uint16
    (extractBackgroundAuto, gradient.c:299-333). The reference stores
    the model with a bare ``(WORD)`` TRUNCATION cast — out-of-range
    values (negative corners of high-order fits) wrap through the
    compiled int32→uint16 conversion; verified in test_c_goldens."""
    out = np.empty_like(data)
    for c in range(data.shape[0]):
        model = compute_background(data[c], params)
        out[c] = (model.astype(np.int64).astype(np.int32)
                  & 0xFFFF).astype(np.uint16)
    return out


def subtract_background(data: np.ndarray,
                        params: Optional[BackgroundParams] = None
                        ) -> np.ndarray:
    """Model + sub_background in one step (bgextract command path)."""
    from siriltpu.ops.imops import sub_background_layer

    bkg = extract_background(data, params)
    out = np.empty_like(data)
    for c in range(data.shape[0]):
        out[c] = sub_background_layer(data[c], bkg[c])
    return out


__all__ = ["compute_background", "extract_background", "subtract_background",
           "build_background_samples", "BackgroundParams", "NPARAMS"]

"""High-level stacking drivers: method dispatch, frame filtering,
normalization, blockwise streaming over row blocks.

Reference: src/stacking/stacking.c —
- ``struct stacking_args`` (stacking.h:38-56): method × rejection ×
  normalization × filtering × memory budget;
- normalization coefficients from cached IKSS stats (:79-190);
- block partitioning by memory budget (:1397-1476, SURVEY §5.7);
- mean-with-rejection main loop (:1189-1858) with y-shift folded into the
  block read (:1546-1590) and x-shift at gather time (:1624-1632);
- median stack (:362-816) — NOTE: the reference median stack applies NO
  registration shifts (it's for calibration frames);
- frame filters (:2183-2260).

Device mapping: the reference's OpenMP-over-blocks becomes a host loop over
row blocks, each block one fused device program (normalize → x-shift →
sort → masked fixed-point rejection → mean). Multi-device: shard the rows
axis of each block, or the frames axis with a reduction — see
siriltpu/parallel/.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence as Seq, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from siriltpu.core.frame import ImStats
from siriltpu.ops import stack as basic_stack
from siriltpu.ops.rejection import masked_median, reject_and_mean
from siriltpu.ops.stats import STATS_EXTRA, statistics
from siriltpu.utils.rounding import round_to_word_f

NORM_MODES = ("none", "additive", "additive_scaling", "multiplicative",
              "multiplicative_scaling")
REJECTION_MODES = ("none", "percentile", "sigma", "sigmedian", "winsorized",
                   "linearfit")
METHODS = ("sum", "mean", "median", "max", "min")


# ------------------------------------------------------------- normalization

def compute_normalization(stats: Seq[ImStats], ref_index: int, mode: str):
    """Per-frame (offset, mul, scale) from IKSS location/scale
    (``_compute_normalization_for_image``, stacking.c:79-123)."""
    n = len(stats)
    offset = np.zeros(n)
    mul = np.ones(n)
    scale = np.ones(n)
    if mode == "none":
        return offset, mul, scale
    if mode not in NORM_MODES:
        raise ValueError(f"unknown normalization {mode}")
    ref = stats[ref_index]
    scale0, loc0 = ref.scale, ref.location
    for i, st in enumerate(stats):
        if mode.endswith("_scaling"):
            scale[i] = scale0 / st.scale if st.scale != 0 else 1.0
        if mode.startswith("additive"):
            offset[i] = scale[i] * st.location - loc0
        else:
            mul[i] = loc0 / st.location if st.location != 0 else 1.0
    return offset, mul, scale


def sequence_normalization(seq, layer: int, indices: Seq[int], mode: str):
    """Normalization for a Sequence using (and filling) the stats cache,
    like compute_normalization + seq_get_imstats (stacking.c:125-190)."""
    if mode == "none":
        n = len(indices)
        return np.zeros(n), np.ones(n), np.ones(n)
    stats = []
    for i in indices:
        st = seq.get_imstats(
            i, layer,
            compute=lambda fr: statistics(fr, layer, option=STATS_EXTRA))
        stats.append(st)
    ref = seq.reference_image if seq.reference_image >= 0 else 0
    ref_pos = indices.index(ref) if ref in indices else 0
    return compute_normalization(stats, ref_pos, mode)


# ----------------------------------------------------------------- filtering

def filter_indices(seq, *, filter_type: str = "all", param: float = 0.0,
                   layer: int = 0) -> List[int]:
    """Frame filtering criteria (stack_filter_*, stacking.c:2183-2260):
    all | included | best_fwhm (param = %) | best_quality (param = %)."""
    if filter_type == "all":
        return list(range(seq.number))
    if filter_type == "included":
        return seq.included_indices()
    reg = seq.regparam.get(layer)
    if not reg:
        raise ValueError("registration data required for best_* filtering")
    incl = np.array([bool(seq.imgparam[i].incl) for i in range(seq.number)])
    if filter_type == "best_fwhm":
        # compute_highest_accepted_fwhm (stacking.c:2248-2278): threshold is
        # val[(int)(percent*N/100)] over ALL N frames' fwhm (sorted ascending);
        # any frame with fwhm <= 0 aborts with threshold 0.0. The filter
        # itself (stack_filter_fwhm, stacking.c:2192) additionally requires
        # imgparam[i].incl and fwhm > 0.
        vals = np.array([r.fwhm for r in reg], dtype=np.float64)
        if np.any(vals <= 0.0):
            return []
        ordered = np.sort(vals)
        k = min(int(param * seq.number / 100.0), seq.number - 1)
        thresh = ordered[k]
        return [i for i in range(seq.number)
                if incl[i] and vals[i] > 0.0 and vals[i] <= thresh]
    if filter_type == "best_quality":
        # compute_highest_accepted_quality (stacking.c:2283-2309): threshold
        # is val[(int)((100-percent)*N/100)] ascending over ALL N frames;
        # an included frame with quality < 0 aborts with threshold 0.0.
        # stack_filter_quality (stacking.c:2204) requires incl and quality>0.
        vals = np.array([r.quality for r in reg], dtype=np.float64)
        if np.any(incl & (vals < 0.0)):
            return []
        ordered = np.sort(vals)
        k = min(int((100.0 - param) * seq.number / 100.0), seq.number - 1)
        thresh = ordered[k]
        return [i for i in range(seq.number)
                if incl[i] and vals[i] > 0.0 and vals[i] >= thresh]
    raise ValueError(f"unknown filter {filter_type}")


# ----------------------------------------------------------- device kernels

def _normalize_block(block_u16: jnp.ndarray, coeffs: jnp.ndarray,
                     mode: str) -> jnp.ndarray:
    """Apply per-frame normalization (stacking.c:1635-1651).
    block (F, Bh, W) uint16 -> float32 normalized WORD values."""
    x = block_u16.astype(jnp.float32)
    if mode == "none":
        return x
    scale = coeffs[:, 2][:, None, None]
    if mode.startswith("additive"):
        offset = coeffs[:, 0][:, None, None]
        return round_to_word_f(x * scale - offset)
    mul = coeffs[:, 1][:, None, None]
    return round_to_word_f(x * scale * mul)


def _xshift_block(vals: jnp.ndarray, shiftx: jnp.ndarray,
                  norm_vals: jnp.ndarray) -> jnp.ndarray:
    """x-shift at gather time with zero fill (stacking.c:1624-1632):
    out[f, y, x] = norm_vals[f, y, x - sx] if in bounds else 0.
    ``vals`` is unused except for shape; kept for clarity."""
    f, bh, w = norm_vals.shape
    xx = jax.lax.broadcasted_iota(jnp.int32, (f, bh, w), 2)
    sx = shiftx[:, None, None]
    rolled = jax.vmap(lambda v, s: jnp.roll(v, s, axis=-1))(norm_vals, shiftx)
    ix = xx - sx
    return jnp.where((ix >= 0) & (ix < w), rolled, 0.0)


@functools.lru_cache(maxsize=None)
def _make_block_kernel(mode: str, rejection: str, sig: Tuple[float, float]):
    if rejection == "linearfit":
        # linearfit is a HYBRID (like sigma): the kernel also returns
        # per-pixel counters and the knife-edge mask so the host can
        # re-run flagged pixels through the f64 oracle (PARITY.md 7a)
        from siriltpu.ops.rejection import (_mean_of_survivors,
                                            reject_linearfit)

        @jax.jit
        def lf_kernel(block_u16, coeffs, shiftx):
            norm = _normalize_block(block_u16, coeffs, mode)
            shifted = _xshift_block(block_u16, shiftx, norm)
            f, bh, w = shifted.shape
            flat = shifted.reshape(f, bh * w)
            valid, v, rl, rh, knife = reject_linearfit(
                flat, float(sig[0]), float(sig[1]))
            out = _mean_of_survivors(v, valid)
            return (out.reshape(bh, w), rl.reshape(bh, w),
                    rh.reshape(bh, w), knife.reshape(bh, w))

        return lf_kernel

    @jax.jit
    def kernel(block_u16, coeffs, shiftx):
        norm = _normalize_block(block_u16, coeffs, mode)
        shifted = _xshift_block(block_u16, shiftx, norm)
        f, bh, w = shifted.shape
        flat = shifted.reshape(f, bh * w)
        out, rejl, rejh = reject_and_mean(flat, rejection, sig)
        return (out.reshape(bh, w),
                jnp.sum(rejl, dtype=jnp.int32),
                jnp.sum(rejh, dtype=jnp.int32))

    return kernel


def _linearfit_fixup(host_block: np.ndarray, off, mul, scale,
                     shifts_x: np.ndarray, knife: np.ndarray,
                     out_rows: np.ndarray, rl_map: np.ndarray,
                     rh_map: np.ndarray, sig, mode: str) -> None:
    """Re-run knife-edge pixels of one block through the literal f64
    oracle (normalization stacking.c:1635-1651 + linearfit rejection
    :1750-1783), in place. ``host_block`` is the y-shifted uint16
    (F, Bh, W) block the kernel consumed."""
    from siriltpu.utils.rounding import np_round_to_word
    from siriltpu.verify.oracle import (c_reject_block,
                                        normalize_pixel_vector)

    f, bh, w = host_block.shape
    ys, xs = np.nonzero(knife)
    for y, x in zip(ys, xs):
        vec = np.zeros(f, np.uint16)
        for i in range(f):
            ix = x - int(shifts_x[i])
            if 0 <= ix < w:
                vec[i] = normalize_pixel_vector(
                    host_block[i, y, ix], mode, scale[i], off[i], mul[i])
        surv, crej = c_reject_block(vec, "linearfit", sig)
        out_rows[y, x] = (np_round_to_word(
            surv.astype(np.float64).sum() / surv.size) if surv.size else 0)
        rl_map[y, x] = crej[0]
        rh_map[y, x] = crej[1]


@functools.lru_cache(maxsize=None)
def _make_median_kernel(mode: str):
    @jax.jit
    def kernel(block_u16, coeffs):
        norm = _normalize_block(block_u16, coeffs, mode)
        f, bh, w = norm.shape
        return masked_median(norm.reshape(f, bh * w)).reshape(bh, w)

    return kernel



def _gather_block_rows_from_seq(seq, layer: int, r0: int, r1: int,
                                indices, shifts_y: np.ndarray) -> np.ndarray:
    """Stream a y-shifted bottom-up row block [r0, r1) of one layer from
    every frame via partial reads (the reference's seq_opened_read_region
    + shift folding, stacking.c:1535-1591). Memory: one block."""
    from siriltpu.core.frame import Rect

    h, w = seq.ry, seq.rx
    bh = r1 - r0
    out = np.zeros((len(indices), bh, w), dtype=np.uint16)
    for k, i in enumerate(indices):
        sy = int(shifts_y[k])
        # bottom-up source rows [r0-sy, r1-sy) clipped to [0, h)
        lo = max(r0 - sy, 0)
        hi = min(r1 - sy, h)
        if lo >= hi:
            continue
        # top-down area for the partial read
        area = Rect(0, h - hi, w, hi - lo)
        block_td = seq.read_frame_part(i, layer, area)
        out[k, lo - (r0 - sy) : hi - (r0 - sy)] = block_td[::-1]
    return out


# ----------------------------------------------------------- block assembly

def _gather_block_rows(frames: np.ndarray, ch: int, r0: int, r1: int,
                       shifts_y: np.ndarray) -> np.ndarray:
    """Host-side y-shifted block gather with zero fill
    (stacking.c:1546-1590): block row y (bottom-up) of frame i comes from
    frame row y - shifty[i]."""
    f, c, h, w = frames.shape
    bh = r1 - r0
    out = np.zeros((f, bh, w), dtype=np.uint16)
    for i in range(f):
        sy = int(shifts_y[i])
        src0 = r0 - sy
        src1 = r1 - sy
        lo = max(src0, 0)
        hi = min(src1, h)
        if lo < hi:
            out[i, lo - src0 : hi - src0] = frames[i, ch, lo:hi]
    return out


def default_block_rows(f: int, w: int, *, budget_bytes: int = 1 << 28) -> int:
    """Rows per block so the f32 working set fits the budget (the
    reference's memory_percent formula analog, stacking.c:1903-1915)."""
    per_row = f * w * 4 * 3  # values + sort buffer + mask, f32-ish
    rows = max(1, budget_bytes // per_row)
    return int(rows)


# ------------------------------------------------------------------ drivers

@dataclass
class StackResult:
    data: np.ndarray            # (C, H, W) uint16
    rejection_low: np.ndarray   # per channel total low-rejected pixels
    rejection_high: np.ndarray
    total_pixels: int = 0

    def rejection_percent(self, channel: int) -> Tuple[float, float]:
        """Per-channel rejection percentages (stacking.c:1811-1817)."""
        npix = self.total_pixels
        if not npix:
            return 0.0, 0.0
        return (100.0 * self.rejection_low[channel] / npix,
                100.0 * self.rejection_high[channel] / npix)


_COMBINATION_NAMES = {"mean": "average", "sum": "normalized sum",
                      "median": "median", "min": "minimum", "max": "maximum"}
_NORM_NAMES = {"none": "none", "additive": "additive",
               "multiplicative": "multiplicative",
               "additive_scaling": "additive + scaling",
               "multiplicative_scaling": "multiplicative + scaling"}
_REJECTION_NAMES = {"none": "none", "percentile": "percentile clipping",
                    "sigma": "sigma clipping",
                    "sigma_masked": "sigma clipping",
                    "sigmedian": "median sigma clipping",
                    "winsorized": "Winsorized sigma clipping",
                    "linearfit": "linear fit clipping"}


def stack_summary(nb_images: int, method: str, rejection: str,
                  sig=(3.0, 3.0), normalize: str = "none") -> list:
    """The consolidated pre-stack report, line for line the reference's
    _show_summary (stacking.c:1929-2011): combination method,
    normalization, rejection algorithm and parameters. Normalization and
    rejection only apply to mean-with-rejection stacks; every other
    method reports them as 'none' like the reference does."""
    lines = [f"Integration of {nb_images} images:"]
    comb = _COMBINATION_NAMES.get(method, "none")
    lines.append(f"Pixel combination ......... {comb}")
    is_mean = method == "mean"
    norm = _NORM_NAMES.get(normalize, "none") if is_mean else "none"
    lines.append(f"Normalization ............. {norm}")
    if is_mean:
        rej = _REJECTION_NAMES.get(rejection, "none")
        lines.append(f"Pixel rejection ........... {rej}")
        # the reference prints the sig parameters for every mean stack,
        # even with rejection 'none' (stacking.c:2005-2010)
        lines.append("Rejection parameters ...... "
                     f"low={sig[0]:.3f} high={sig[1]:.3f}")
    else:
        lines.append("Pixel rejection ........... none")
        lines.append("Rejection parameters ...... none")
    return lines


def stack_frames(frames: np.ndarray, *, method: str = "mean",
                 shifts: Optional[np.ndarray] = None,
                 rejection: str = "sigma", sig: Tuple[float, float] = (3.0, 3.0),
                 normalize: str = "none",
                 coeffs: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                 block_rows: Optional[int] = None) -> StackResult:
    """Stack an in-memory (F, C, H, W) uint16 array.

    ``method``: sum | mean | median | max | min. ``mean`` applies the
    rejection algorithm; ``median`` ignores shifts (reference behavior).
    """
    frames = np.asarray(frames)
    f, c, h, w = frames.shape
    if shifts is None:
        shifts = np.zeros((f, 2), dtype=np.int32)
    shifts = np.asarray(shifts, dtype=np.int32)

    if method == "sum":
        out, _ = basic_stack.stack_sum(frames, shifts)
        return StackResult(out, np.zeros(c), np.zeros(c), f * c * h * w)
    if method == "max":
        return StackResult(basic_stack.stack_max(frames, shifts),
                           np.zeros(c), np.zeros(c), f * c * h * w)
    if method == "min":
        return StackResult(basic_stack.stack_min(frames, shifts),
                           np.zeros(c), np.zeros(c), f * c * h * w)

    if coeffs is None:
        if normalize != "none":
            stats = [statistics(frames[i], 0, option=STATS_EXTRA)
                     for i in range(f)]
            off, mul, scale = compute_normalization(stats, 0, normalize)
        else:
            off, mul, scale = np.zeros(f), np.ones(f), np.ones(f)
    else:
        off, mul, scale = coeffs
    coeff_arr = jnp.asarray(np.stack([off, mul, scale], axis=1),
                            dtype=jnp.float32)

    if block_rows is None:
        block_rows = default_block_rows(f, w)
    out = np.zeros((c, h, w), dtype=np.uint16)
    rejl = np.zeros(c, dtype=np.int64)
    rejh = np.zeros(c, dtype=np.int64)

    if method == "median":
        kernel = _make_median_kernel(normalize)
        for ch in range(c):
            for r0 in range(0, h, block_rows):
                r1 = min(r0 + block_rows, h)
                block = frames[:, ch, r0:r1, :]  # no shifts (reference)
                out[ch, r0:r1] = np.asarray(kernel(jnp.asarray(block), coeff_arr))
        return StackResult(out, rejl, rejh, f * c * h * w)

    if method != "mean":
        raise ValueError(f"unknown method {method}")
    if rejection not in REJECTION_MODES:
        raise ValueError(f"unknown rejection {rejection}")

    kernel = _make_block_kernel(normalize, rejection, sig)
    sx = jnp.asarray(shifts[:, 0])
    for ch in range(c):
        for r0 in range(0, h, block_rows):
            r1 = min(r0 + block_rows, h)
            block = _gather_block_rows(frames, ch, r0, r1, shifts[:, 1])
            if rejection == "linearfit":
                o, rlm, rhm, km = kernel(jnp.asarray(block), coeff_arr, sx)
                o = np.asarray(o).copy()
                rlm = np.asarray(rlm).copy()
                rhm = np.asarray(rhm).copy()
                km = np.asarray(km)
                if km.any():
                    _linearfit_fixup(block, off, mul, scale, shifts[:, 0],
                                     km, o, rlm, rhm, sig, normalize)
                out[ch, r0:r1] = o
                rejl[ch] += int(rlm.sum())
                rejh[ch] += int(rhm.sum())
            else:
                o, rl, rh = kernel(jnp.asarray(block), coeff_arr, sx)
                out[ch, r0:r1] = np.asarray(o)
                rejl[ch] += int(rl)
                rejh[ch] += int(rh)
    return StackResult(out, rejl, rejh, f * c * h * w)


def stack_sequence(seq, *, method: str = "mean", layer_shifts: int = 0,
                   filter_type: str = "included", filter_param: float = 0.0,
                   rejection: str = "sigma", sig=(3.0, 3.0),
                   normalize: str = "none",
                   block_rows: Optional[int] = None,
                   stream: Optional[bool] = None) -> StackResult:
    """Stack a Sequence: filtering → normalization from cached stats →
    blockwise streaming reads → device stacking. The .seq-level driver
    matching start_stacking (stacking.c:1871-1927)."""
    indices = filter_indices(seq, filter_type=filter_type, param=filter_param,
                             layer=layer_shifts)
    if len(indices) < 2:
        raise ValueError("No frame selected for stacking (select at least 2)")
    shifts = seq.reg_shifts(layer_shifts)[indices]
    if stream is None:
        # stream when the whole sequence would not comfortably fit the
        # reference's memory budget (stacking.c:1903-1915)
        from siriltpu.core.memory import get_available_memory_mb
        seq_mb = len(indices) * max(seq.nb_layers, 1) * seq.rx * seq.ry * 2 / (1 << 20)
        stream = seq_mb > 0.25 * get_available_memory_mb()
    if stream and method in ("mean", "median"):
        return _stack_sequence_streaming(
            seq, indices, shifts, method=method, layer_shifts=layer_shifts,
            rejection=rejection, sig=sig, normalize=normalize,
            block_rows=block_rows)
    frames = np.stack([seq.read_frame(i).data for i in indices])
    coeffs = None
    if normalize != "none" and method in ("mean", "median"):
        coeffs = sequence_normalization(seq, layer_shifts, indices, normalize)
    return stack_frames(frames, method=method, shifts=shifts,
                        rejection=rejection, sig=sig, normalize=normalize,
                        coeffs=coeffs, block_rows=block_rows)


def _stack_sequence_streaming(seq, indices, shifts, *, method: str,
                              layer_shifts: int, rejection: str, sig,
                              normalize: str,
                              block_rows: Optional[int]) -> StackResult:
    """Bounded-memory stacking: row blocks are read from the files with
    the y-shift folded into the read window (the reference's streaming
    model, SURVEY §5.7); only one (F, Bh, W) block lives in memory."""
    if seq.nb_layers == -1 or seq.rx == 0:
        seq.read_frame(indices[0])  # populates nb_layers/rx/ry
    f = len(indices)
    c, h, w = seq.nb_layers, seq.ry, seq.rx
    coeffs = None
    if normalize != "none":
        coeffs = sequence_normalization(seq, layer_shifts, indices, normalize)
        off, mul, scale = coeffs
    else:
        off, mul, scale = np.zeros(f), np.ones(f), np.ones(f)
    coeff_arr = jnp.asarray(np.stack([off, mul, scale], axis=1),
                            dtype=jnp.float32)
    if block_rows is None:
        from siriltpu.core.memory import stacking_block_rows
        block_rows = min(max(stacking_block_rows(w, f), 16), h)
    out = np.zeros((c, h, w), dtype=np.uint16)
    rejl = np.zeros(c, dtype=np.int64)
    rejh = np.zeros(c, dtype=np.int64)
    sx = jnp.asarray(shifts[:, 0])
    median_kernel = _make_median_kernel(normalize) if method == "median" else None
    mean_kernel = (_make_block_kernel(normalize, rejection, tuple(sig))
                   if method == "mean" else None)

    # Double-buffered streaming (SURVEY §7.2 M7, mirroring the reference's
    # blockwise reads stacking.c:1535-1591): a host thread reads block i+1
    # from disk and starts its async device upload while the device
    # computes block i. The np.asarray() readback of block i is what
    # blocks the main thread, so disk + PCIe time hides under compute.
    blocks = [(ch, r0, min(r0 + block_rows, h))
              for ch in range(c) for r0 in range(0, h, block_rows)]
    sy_med = np.zeros(f, np.int32)

    keep_host = method == "mean" and rejection == "linearfit"

    def load(task):
        ch, r0, r1 = task
        sy = sy_med if method == "median" else shifts[:, 1]
        host = _gather_block_rows_from_seq(seq, ch, r0, r1, indices, sy)
        # async H2D; returns immediately (host kept for the linearfit
        # oracle fixup, which reads flagged pixels back off the block)
        return host if keep_host else None, jax.device_put(host)

    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load, blocks[0])
        for bi, (ch, r0, r1) in enumerate(blocks):
            host, dev = fut.result()
            if bi + 1 < len(blocks):
                fut = pool.submit(load, blocks[bi + 1])
            if method == "median":
                out[ch, r0:r1] = np.asarray(median_kernel(dev, coeff_arr))
            elif rejection == "linearfit":
                o, rlm, rhm, km = mean_kernel(dev, coeff_arr, sx)
                o = np.asarray(o).copy()
                rlm = np.asarray(rlm).copy()
                rhm = np.asarray(rhm).copy()
                km = np.asarray(km)
                if km.any():
                    _linearfit_fixup(host, off, mul, scale, shifts[:, 0],
                                     km, o, rlm, rhm, sig, normalize)
                out[ch, r0:r1] = o
                rejl[ch] += int(rlm.sum())
                rejh[ch] += int(rhm.sum())
            else:
                o, rl, rh = mean_kernel(dev, coeff_arr, sx)
                out[ch, r0:r1] = np.asarray(o)
                rejl[ch] += int(rl)
                rejh[ch] += int(rh)
    return StackResult(out, rejl, rejh, f * c * h * w)


__all__ = ["stack_frames", "stack_sequence", "compute_normalization",
           "sequence_normalization", "filter_indices", "StackResult",
           "NORM_MODES", "REJECTION_MODES", "METHODS", "default_block_rows"]

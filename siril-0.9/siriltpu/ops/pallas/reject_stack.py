"""Fused rejection stack for the GPU: per-pixel sort + rejection + mean
in one kernel, through Pallas' Triton route.

Stacking sorts every cross-frame pixel vector. The plain XLA path
(:func:`siriltpu.ops.rejection.reject_and_mean`) runs the sort as a
network of compare-exchange stages, each of which reads and writes the
whole (F, P) block in device memory, and then makes several more full
passes per clip iteration. This kernel reads the block once: each
program owns ``BLOCK`` pixel columns, one per thread, copies them into a
working block, runs the pruned Batcher network on it (a loop over a
comparator table), clips, and writes only the per-pixel results. A
thread touches nothing but its own column, so the working set of a
program (F x BLOCK values) stays in L1/L2.

Rejections:

- ``sigma``  — windowed sigma clip with the semantics of
  :func:`siriltpu.ops.rejection.reject_sigma_window`, including the
  DEGENERATE flag: pixels whose scan would hit the reference's mid-scan
  break (N - r <= 4, stacking.c:1684-1688) are frozen and flagged, and
  the wrapper re-runs them through the exact masked kernel, so the
  result matches ``reject_and_mean`` bit for bit.
- ``median`` — GSL sorted median of the full vector, C-truncated to WORD
  (stacking.c:765-767).

Statistics use the reference-exact integer sums of ``_gsl_sd``
(deviations centred on the low median, hi/lo 8-bit square split), and
the survivor mean is exact integer round-half-up. The two f32 divisions
and the square root of the variance are issued as IEEE round-to-nearest
PTX (``div.rn``, ``sqrt.rn``): Triton's own f32 ``/`` and ``sqrt`` are
approximate, and one ulp in sigma can flip a clip decision. For the
same reason the plain path takes its roots with :func:`sqrt_rn`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from siriltpu.ops.sortnet import batcher_pairs

#: pixel columns per program: one column per thread of ``NUM_WARPS`` warps
BLOCK = 128
NUM_WARPS = 4

#: largest frame count the kernel takes: the largest checked against the
#: plain path on the card (tests marked gpu); larger stacks run the plain
#: path
F_MAX = 128

#: degenerate pixels re-run per pass of the exact fix-up (degeneracy
#: needs clipping ~all of a 100-frame vector — see tests for constructed
#: cases; real stacks hit 0)
DEGEN_K = 128

FUSED_REJECTIONS = ("sigma", "median")

_MAX_ITERS = 512  # same safety bound as ops.rejection.MAX_ITERS
_EW_BLOCK = 1024  # elements per program of the sqrt_rn kernel


def fused_applies(rejection: str, f: int) -> bool:
    """True when the fused kernel stacks ``f`` frames with ``rejection``.

    Sigma needs F >= 5: at F <= 4 every pixel hits the reference's
    mid-scan break, so every pixel would go through the exact fix-up,
    ``DEGEN_K`` at a time; the plain path is the faster one there."""
    if rejection == "sigma":
        return 5 <= f <= F_MAX
    return rejection == "median" and 1 <= f <= F_MAX


def _network(f: int):
    """Batcher's odd-even merge sort for the next power of two, pruned to
    the comparators whose wires are both < f. A wire >= f would hold +inf,
    so every comparator touching one is a no-op."""
    n = 1 << (f - 1).bit_length()
    return tuple((a, b) for a, b in batcher_pairs(n) if b < f)


def _f32_op(asm: str, interpret: bool, fallback, *args):
    """An f32 op with IEEE rounding: inline PTX on the card, the plain
    jnp op under the interpreter (which already rounds to nearest)."""
    if interpret:
        return fallback(*args)
    constraints = ",".join(["=f"] + ["f"] * len(args))
    [out] = plgpu.elementwise_inline_asm(
        asm, args=list(args), constraints=constraints, pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(args[0].shape,
                                                  jnp.float32)])
    return out


def sqrt_rn(x: jnp.ndarray) -> jnp.ndarray:
    """Correctly rounded float32 square root on every backend.

    XLA's GPU sqrt computes x * rsqrt(x), which can land one ulp below
    the IEEE result; a clip decision on the card then differs from the
    CPU and from the compiled reference. A program compiled for CUDA
    takes the root with PTX ``sqrt.rn`` instead."""
    if x.size == 0:
        return jnp.sqrt(x)

    def on_gpu(v):
        flat = v.reshape(-1)
        n = flat.shape[0]

        def kernel(x_ref, o_ref):
            i = pl.program_id(0) * _EW_BLOCK + jnp.arange(_EW_BLOCK,
                                                           dtype=jnp.int32)
            ok = i < n
            root = _f32_op("sqrt.rn.f32 $0, $1;", False, None,
                           plgpu.load(x_ref.at[i], mask=ok, other=0.0))
            plgpu.store(o_ref.at[i], root, mask=ok)

        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
            grid=(pl.cdiv(n, _EW_BLOCK),), backend="triton",
            name="sqrt_rn")(flat).reshape(v.shape)

    return jax.lax.platform_dependent(x, cuda=on_gpu, default=jnp.sqrt)


def _make_kernel(f: int, p: int, rejection: str, siglow: float,
                 sighigh: float, interpret: bool):
    pairs = _network(f)

    def div(a, b):
        return _f32_op("div.rn.f32 $0, $1, $2;", interpret,
                       lambda x, y: x / y, a, b)

    def sqrt(a):
        return _f32_op("sqrt.rn.f32 $0, $1;", interpret, jnp.sqrt, a)

    def kernel(pairs_ref, x_ref, mean_ref, degen_ref, rejl_ref, rejh_ref,
               sorted_ref):
        cols = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
        inb = cols < p
        zero = jnp.zeros((BLOCK,), jnp.int32)

        # Every thread sorts and clips its own column inside sorted_ref
        # (its rows stay in L1/L2), with rolled loops: unrolling the
        # network and the clip passes over F register rows made the
        # compile take minutes.
        def row(r):
            return plgpu.load(sorted_ref.at[r, cols], mask=inb, other=0
                              ).astype(jnp.int32)

        def put(r, v):
            plgpu.store(sorted_ref.at[r, cols], v.astype(jnp.uint16),
                        mask=inb)

        def copy(r, carry):
            put(r, plgpu.load(x_ref.at[r, cols], mask=inb, other=0))
            return carry

        def exchange(c, carry):
            a, b = pairs_ref[0, c], pairs_ref[1, c]
            xa, xb = row(a), row(b)
            put(a, jnp.minimum(xa, xb))
            put(b, jnp.maximum(xa, xb))
            return carry

        jax.lax.fori_loop(0, f, copy, 0)
        jax.lax.fori_loop(0, len(pairs), exchange, 0)

        def store(mean, degen, lo, hi):
            plgpu.store(mean_ref.at[cols], mean.astype(jnp.uint16), mask=inb)
            plgpu.store(degen_ref.at[cols], degen, mask=inb)
            plgpu.store(rejl_ref.at[cols], lo, mask=inb)
            plgpu.store(rejh_ref.at[cols], f - hi, mask=inb)

        if rejection == "median":
            # mean of the two middle order statistics, truncated
            store((row((f - 1) // 2) + row(f // 2)) >> 1, zero, zero,
                  zero + f)
            return

        def over_window(lo, hi, fn, init):
            """Fold ``fn(r, x_r, in_window, acc)`` over the rows that any
            pixel of this block still has in its window."""
            def step(r, acc):
                return fn(r, row(r), (lo <= r) & (r < hi), acc)
            return jax.lax.fori_loop(jnp.min(lo), jnp.max(hi), step, init)

        def body(state):
            lo, hi, r_acc, done, degen, it = state
            n = hi - lo
            v1 = plgpu.load(sorted_ref.at[lo + (n - 1) // 2, cols], mask=inb,
                            other=0).astype(jnp.int32)
            v2 = plgpu.load(sorted_ref.at[lo + n // 2, cols], mask=inb,
                            other=0).astype(jnp.int32)
            median = 0.5 * (v1 + v2).astype(jnp.float32)

            def sums(r, xr, w, acc):
                # exact integer sums centred on the low median (_gsl_sd)
                s1, shh, shl, sll = acc
                d = jnp.where(w, xr - v1, 0)
                ad = jnp.abs(d)
                h8 = ad >> 8
                l8 = ad & 255
                return s1 + d, shh + h8 * h8, shl + h8 * l8, sll + l8 * l8

            s1, shh, shl, sll = over_window(lo, hi, sums, (zero,) * 4)
            nf = n.astype(jnp.float32)
            s2 = (shh.astype(jnp.float32) * 65536.0
                  + shl.astype(jnp.float32) * 512.0
                  + sll.astype(jnp.float32))
            s1f = s1.astype(jnp.float32)
            var = div(s2 - div(s1f * s1f, jnp.maximum(nf, 1.0)),
                      jnp.maximum(nf - 1.0, 1.0))
            sigma = jnp.where(n > 1, sqrt(jnp.maximum(var, 0.0)), 0.0)
            lo_thr = siglow * sigma
            hi_thr = sighigh * sigma

            def counts(r, xr, w, acc):
                xf = xr.astype(jnp.float32)
                return (acc[0] + (w & (median - xf > lo_thr)).astype(jnp.int32),
                        acc[1] + (w & (xf - median > hi_thr)).astype(jnp.int32))

            nlow, nhigh = over_window(lo, hi, counts, (zero, zero))
            removed = nlow + nhigh
            # the C scan breaks iff n - (r + c) <= 4 for some prefix count
            # c (max c = nlow + nhigh), incl. c == 0 when n - r <= 4
            hits_break = (n - r_acc - removed) <= 4
            upd = (done == 0) & ~hits_break
            lo = jnp.where(upd, lo + nlow, lo)
            hi = jnp.where(upd, hi - nhigh, hi)
            r_acc = jnp.where(upd, r_acc + removed, r_acc)
            degen = jnp.where((done == 0) & hits_break, 1, degen)
            newly = hits_break | (removed == 0) | ((hi - lo) <= 3)
            done = jnp.where(newly, 1, done)
            return lo, hi, r_acc, done, degen, it + 1

        def cond(state):
            done, it = state[3], state[5]
            return (jnp.min(done) == 0) & (it < _MAX_ITERS)

        lo, hi, _, _, degen, _ = jax.lax.while_loop(
            cond, body, (zero, zero + f, zero, zero, zero, jnp.int32(0)))
        s = over_window(lo, hi, lambda r, xr, w, acc: acc + jnp.where(w, xr, 0),
                        zero)
        n = hi - lo
        mean = jnp.where(n > 0, (2 * s + n) // jnp.maximum(2 * n, 1), 0)
        store(jnp.clip(mean, 0, 65535), degen, lo, hi)

    return kernel


@functools.partial(jax.jit, static_argnames=("rejection", "siglow",
                                             "sighigh", "interpret"))
def _fused_raw(vals, rejection: str, siglow: float, sighigh: float,
               interpret: bool):
    f, p = vals.shape
    i32 = jax.ShapeDtypeStruct((p,), jnp.int32)
    # (2, n) comparator table; one no-op pair when F = 1 has none
    pairs = np.array(_network(f) or ((0, 0),), np.int32).T
    return pl.pallas_call(
        _make_kernel(f, p, rejection, siglow, sighigh, interpret),
        # the last output is the sorted block, the kernel's working space
        out_shape=[jax.ShapeDtypeStruct((p,), jnp.uint16), i32, i32, i32,
                   jax.ShapeDtypeStruct((f, p), jnp.uint16)],
        grid=(pl.cdiv(p, BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"fused_{rejection}_stack",
    )(jnp.asarray(pairs), vals)[:4]


@functools.partial(jax.jit, static_argnames=("rejection", "siglow",
                                             "sighigh", "interpret"))
def fused_stack(vals: jnp.ndarray, rejection: str, siglow: float = 0.0,
                sighigh: float = 0.0, interpret: bool = False):
    """Rejection stack of (F, P) uint16 values -> ``(mean (P,) uint16,
    rejlow (P,), rejhigh (P,))``, bit-exact vs ``reject_and_mean``
    including the counters.

    For sigma, the pixels that hit the reference's degenerate
    mid-scan-break path are re-run on the device through the exact
    masked kernel, ``DEGEN_K`` columns per pass.
    """
    f, p = vals.shape
    if not fused_applies(rejection, f):
        raise ValueError(f"no fused {rejection} kernel for F={f}")
    mean, degen, rejl, rejh = _fused_raw(vals, rejection, float(siglow),
                                         float(sighigh), interpret)
    if rejection == "sigma":
        mean, rejl, rejh = _degenerate_fixup(vals, degen, float(siglow),
                                             float(sighigh), mean, rejl, rejh)
    return mean, rejl, rejh


def _degenerate_fixup(vals, degen, siglow: float, sighigh: float, mean,
                      rejl, rejh):
    """Re-run every pixel the kernel flagged degenerate through the exact
    masked kernel, DEGEN_K columns per pass, and patch the results in.
    Real stacks flag none: the loop then ends after one reduction."""
    from siriltpu.ops.rejection import _mean_of_survivors, reject_sigma
    p = vals.shape[1]

    def one_pass(state):
        todo, mean, rejl, rejh = state
        idx = jnp.nonzero(todo, size=DEGEN_K, fill_value=p)[0]
        sel = idx < p                      # unused slots hold p: dropped
        cols = jnp.take(vals, jnp.minimum(idx, p - 1), axis=1)
        valid, v, srl, srh = reject_sigma(cols.astype(jnp.float32), siglow,
                                          sighigh, active=sel)
        fix = _mean_of_survivors(v, valid)
        return (todo.at[idx].set(False, mode="drop"),
                mean.at[idx].set(fix, mode="drop"),
                rejl.at[idx].set(srl, mode="drop"),
                rejh.at[idx].set(srh, mode="drop"))

    _, mean, rejl, rejh = jax.lax.while_loop(
        lambda state: jnp.any(state[0]), one_pass,
        (degen != 0, mean, rejl, rejh))
    return mean, rejl, rejh

__all__ = ["fused_stack", "fused_applies", "FUSED_REJECTIONS", "F_MAX",
           "DEGEN_K", "BLOCK"]

"""FFT phase cross-correlation shift registration (the "image pattern"
planetary registration method).

Reference: ``register_shift_dft``, src/registration/registration.c:182-400.
Semantics: on a SQUARE selection, compute FFT(ref) and per frame
``cross = FFT(ref) * conj(FFT(frame))``, inverse-transform, take the
argmax of the real part (first occurrence, scanning in row-major order,
registration.c:330-345), decode (shifty, shiftx) = divmod(idx, size)
wrapping values > size/2 to negative (:346-353).

The resulting (shiftx, shifty) make ``frame(x - shiftx, y - shifty) ≈
ref(x, y)`` in bottom-up row coordinates — exactly what the stacking
shift consumers expect (stacking.c:298-319).

Device-native: one batched ``jnp.fft.fft2`` over all frames, fused
cross-power and argmax — the reference's per-frame OpenMP loop becomes a
single device program; `vmap`/sharding over the frame axis scales it out.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


@jax.jit
def _ref_fft(ref: Array) -> Array:
    # real-input transform: half the spectrum, half the FLOPs/bytes of
    # fft2 — the cross-correlation of two real signals is real, so the
    # rfft/irfft round trip is mathematically identical to the C's
    # complex transform + real-part (registration.c:330)
    return jnp.fft.rfft2(ref.astype(jnp.float32))


@jax.jit
def phase_correlate(ref_fft: Array, frames: Array):
    """Batched phase correlation.

    ref_fft: (S, S//2+1) complex64 (precomputed rfft2 of the reference
    selection). frames: (F, S, S) uint16/float. Returns
    (shiftx, shifty) int32 (F,).
    """
    size = frames.shape[-1]
    ffts = jnp.fft.rfft2(frames.astype(jnp.float32))
    cross = ref_fft[None] * jnp.conj(ffts)
    corr = jnp.fft.irfft2(cross, s=(size, size))
    flat = corr.reshape(corr.shape[0], -1)
    idx = jnp.argmax(flat, axis=1).astype(jnp.int32)  # first max, like the C scan
    shifty = idx // size
    shiftx = idx % size
    shifty = jnp.where(shifty > size // 2, shifty - size, shifty)
    shiftx = jnp.where(shiftx > size // 2, shiftx - size, shiftx)
    return shiftx, shifty


def decode_corr_peak(corr: np.ndarray):
    """Decode (shiftx, shifty) from a real correlation surface exactly
    like the reference scan (registration.c:337-354): first strict
    maximum in row-major order, (shifty, shiftx) = divmod(idx, size),
    values > size/2 wrap negative. This is the host mirror of the
    argmax+decode inside :func:`phase_correlate` (same semantics,
    anchored by tests/goldens/c_dftreg.bin)."""
    corr = np.asarray(corr)
    size = corr.shape[-1]
    idx = int(np.argmax(corr.reshape(-1)))
    shifty, shiftx = divmod(idx, size)
    if shifty > size // 2:
        shifty -= size
    if shiftx > size // 2:
        shiftx -= size
    return shiftx, shifty


def register_shift_frames(ref_sel: np.ndarray, frame_sels: np.ndarray,
                          chunk: int = 64):
    """Host driver: phase-correlate every frame selection against the
    reference selection. Returns (shiftx (F,), shifty (F,)) int arrays."""
    ref_sel = np.asarray(ref_sel)
    if ref_sel.shape[0] != ref_sel.shape[1]:
        raise ValueError("the selection needs to be square for the DFT "
                         "(registration.c:198)")
    rf = _ref_fft(jnp.asarray(ref_sel))
    f = len(frame_sels)
    sx = np.zeros(f, dtype=np.int32)
    sy = np.zeros(f, dtype=np.int32)
    for s in range(0, f, chunk):
        e = min(s + chunk, f)
        bx, by = phase_correlate(rf, jnp.asarray(np.asarray(frame_sels[s:e])))
        sx[s:e] = np.asarray(bx)
        sy[s:e] = np.asarray(by)
    return sx, sy


__all__ = ["phase_correlate", "register_shift_frames",
           "decode_corr_peak"]

"""ECC (Enhanced Correlation Coefficient) translation alignment.

Reference: src/opencv/ecc/ecc.cpp (``findTransform_ECC`` :307-554, the
Siril wrapper ``findTransform`` :556-603) implementing Evangelidis &
Psarakis, PAMI 2008, translation warp only as used by ``register_ecc``
(src/registration/registration.c:786-930).

Frozen behaviors:

- both images are saturated to 8-bit before alignment (findTransform
  converts CV_16U -> CV_8U, ecc.cpp:568-569);
- 5x5 fixed-kernel Gaussian smoothing of template and input (:401-415);
- centered [-0.5, 0, 0.5] gradients of the smoothed input (:423-426);
- per-iteration: inverse-map bilinear warp of image and gradients by the
  current translation, nearest-warp of the validity mask, masked
  zero-means, rho = corr/(|img||tmp|), illumination-compensation lambda,
  2-parameter Gauss-Newton update dp = H^-1 J^T (lambda*t - i) (:449-552);
- at most 50 iterations, stop when |rho - last_rho| < 0.001 (:562-563);
- failure (rho <= 0) excludes the frame; the caller stores
  shiftx = -round(dx), shifty = -round(dy) (registration.c:906-908).

Device-native: the whole iteration is one jitted ``lax.while_loop``;
``ecc_translation_batch`` vmaps it over frames so a sequence aligns as a
single device program.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from siriltpu.ops.interp import (cv_gradient_x, cv_gradient_y, gaussian_blur5,
                                 translate_mask)

Array = jnp.ndarray

NUM_ITERATIONS = 50
TERMINATION_EPS = 0.001

# max |translation| the fast slice-warp supports; pads each image by this
# much. Planetary ECC drifts are tens of pixels; the reference has no
# larger reach either (it starts from identity and must converge in 50
# Gauss-Newton steps).
MAX_SHIFT = 64


@jax.jit
def ecc_translation(template: Array, image: Array):
    """Align ``image`` to ``template`` with a translation warp.

    Inputs are 2D float arrays (already 8-bit-saturated by the caller for
    reference parity). Returns (tx, ty, rho): the translation stored in
    the warp matrix (dst(x,y) = image(x+tx, y+ty)) and the final ECC.

    Gather-free warp: a translation moves EVERY pixel by the same
    offset, so the bilinear inverse-map is one ``dynamic_slice`` from a
    zero-padded copy plus a static 4-tap blend. (Zero padding
    reproduces OpenCV's BORDER_CONSTANT blend exactly for |t| < MAX_SHIFT.)
    """
    h, w = template.shape
    M = MAX_SHIFT
    tf = gaussian_blur5(template.astype(jnp.float32))
    imf = gaussian_blur5(image.astype(jnp.float32))
    gx = cv_gradient_x(imf)
    gy = cv_gradient_y(imf)
    padded = jnp.pad(jnp.stack([imf, gx, gy]),
                     ((0, 0), (M, M + 1), (M, M + 1)))

    def warp3(tx, ty):
        k = jnp.floor(tx)
        l = jnp.floor(ty)
        fx = tx - k
        fy = ty - l
        win = jax.lax.dynamic_slice(
            padded, (0, (M + l).astype(jnp.int32), (M + k).astype(jnp.int32)),
            (3, h + 1, w + 1))
        v00 = win[:, :h, :w]
        v01 = win[:, :h, 1:]
        v10 = win[:, 1:, :w]
        v11 = win[:, 1:, 1:]
        top = v00 * (1 - fx) + v01 * fx
        bot = v10 * (1 - fx) + v11 * fx
        return top * (1 - fy) + bot * fy

    def cond(state):
        i, tx, ty, rho, last_rho = state
        return (i <= NUM_ITERATIONS) & (jnp.abs(rho - last_rho) >= TERMINATION_EPS)

    def body(state):
        i, tx, ty, rho, last_rho = state
        tx = jnp.clip(tx, -(M - 1.0), M - 1.0)
        ty = jnp.clip(ty, -(M - 1.0), M - 1.0)
        warped, gxw, gyw = warp3(tx, ty)
        mask = translate_mask((h, w), tx, ty)
        nnz = jnp.sum(mask).astype(jnp.float32)
        mnz = jnp.maximum(nnz, 1.0)

        img_mean = jnp.sum(jnp.where(mask, warped, 0.0)) / mnz
        tmp_mean = jnp.sum(jnp.where(mask, tf, 0.0)) / mnz
        img_var = jnp.sum(jnp.where(mask, (warped - img_mean) ** 2, 0.0)) / mnz
        tmp_var = jnp.sum(jnp.where(mask, (tf - tmp_mean) ** 2, 0.0)) / mnz

        iw = jnp.where(mask, warped - img_mean, 0.0)
        tzm = jnp.where(mask, tf - tmp_mean, 0.0)
        img_norm = jnp.sqrt(nnz * img_var)
        tmp_norm = jnp.sqrt(nnz * tmp_var)

        # 2x2 Hessian of the translation Jacobian [gx, gy]
        hxx = jnp.sum(gxw * gxw)
        hxy = jnp.sum(gxw * gyw)
        hyy = jnp.sum(gyw * gyw)
        det = hxx * hyy - hxy * hxy
        # OpenCV Mat::inv returns zeros for singular matrices
        inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
        i00, i01, i11 = hyy * inv_det, -hxy * inv_det, hxx * inv_det

        corr = jnp.sum(tzm * warped)  # templateZM.dot(imageWarped)
        new_rho = corr / jnp.maximum(img_norm * tmp_norm, 1e-30)

        tpx = jnp.sum(gxw * tzm)
        tpy = jnp.sum(gyw * tzm)
        ipx = jnp.sum(gxw * iw)
        ipy = jnp.sum(gyw * iw)
        iphx = i00 * ipx + i01 * ipy
        iphy = i01 * ipx + i11 * ipy
        lambda_n = img_norm * img_norm - (ipx * iphx + ipy * iphy)
        lambda_d = corr - (tpx * iphx + tpy * iphy)
        lam = lambda_n / jnp.where(lambda_d == 0, 1e-30, lambda_d)
        new_rho = jnp.where(lambda_d <= 0.0, -1.0, new_rho)

        err = lam * tzm - iw
        epx = jnp.sum(gxw * err)
        epy = jnp.sum(gyw * err)
        dpx = i00 * epx + i01 * epy
        dpy = i01 * epx + i11 * epy
        return i + 1, tx + dpx, ty + dpy, new_rho, rho

    state = (jnp.int32(1), jnp.float32(0.0), jnp.float32(0.0),
             jnp.float32(-1.0), jnp.float32(-TERMINATION_EPS))
    _, tx, ty, rho, _ = jax.lax.while_loop(cond, body, state)
    return tx, ty, rho


def ecc_find_translation(ref_layer: np.ndarray, img_layer: np.ndarray
                         ) -> Tuple[float, float, float]:
    """Siril's ``findTransform``: saturate to 8-bit, run ECC translation.
    Returns (dx, dy, rho); rho <= 0 means failure (frame excluded)."""
    ref8 = np.minimum(np.asarray(ref_layer), 255).astype(np.float32)
    img8 = np.minimum(np.asarray(img_layer), 255).astype(np.float32)
    tx, ty, rho = ecc_translation(jnp.asarray(ref8), jnp.asarray(img8))
    return float(tx), float(ty), float(rho)


def ecc_translation_batch(template: Array, images: Array):
    """vmapped ECC: align (F, H, W) frames to one template on device."""
    return jax.vmap(lambda im: ecc_translation(template, im))(images)


__all__ = ["ecc_translation", "ecc_find_translation", "ecc_translation_batch",
           "NUM_ITERATIONS", "TERMINATION_EPS"]

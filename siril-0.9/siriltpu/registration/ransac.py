"""RANSAC homography estimation (4-point DLT hypotheses + inlier count).

Reference: ``cvCalculH`` (src/opencv/opencv.cpp:207-240) calls OpenCV-2's
``findHomography(img, ref, CV_RANSAC, 3.0)`` (bundled sources under
src/opencv/findHomography/). Reproduced behavior: RANSAC with a 3-px
reprojection threshold (opencv.cpp:47), adaptive iteration count with
0.995 confidence, final least-squares (DLT) refit on the inliers.

This shape of computation — hundreds of independent 4-point hypotheses,
each a tiny solve plus an inlier count over all pairs — is a natural device
batch; a device version can vmap `_dlt` over hypothesis batches. The
host NumPy version here is deterministic (seeded) and fast for the
typical <= 2000 matched pairs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DEFAULT_THRESHOLD = 3.0  # opencv.cpp:47
CONFIDENCE = 0.995
MAX_ITERS = 2000


def _normalize(pts: np.ndarray):
    c = pts.mean(axis=0)
    d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    ph = np.column_stack([pts, np.ones(len(pts))]) @ T.T
    return ph[:, :2], T


def dlt_homography(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """Normalized DLT from >= 4 correspondences."""
    n = src.shape[0]
    if n < 4:
        return None
    sn, Ts = _normalize(src)
    dn, Td = _normalize(dst)
    A = np.zeros((2 * n, 9))
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    A[0::2, 0] = -x
    A[0::2, 1] = -y
    A[0::2, 2] = -1
    A[0::2, 6] = u * x
    A[0::2, 7] = u * y
    A[0::2, 8] = u
    A[1::2, 3] = -x
    A[1::2, 4] = -y
    A[1::2, 5] = -1
    A[1::2, 6] = v * x
    A[1::2, 7] = v * y
    A[1::2, 8] = v
    try:
        _, _, vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]


def _reproj_err(H: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    ph = np.column_stack([src, np.ones(len(src))]) @ H.T
    w = ph[:, 2]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    proj = ph[:, :2] / w[:, None]
    return np.sqrt(((proj - dst) ** 2).sum(axis=1))


def find_homography(src: np.ndarray, dst: np.ndarray, *,
                    threshold: float = DEFAULT_THRESHOLD,
                    seed: int = 0, max_iters: int = MAX_ITERS
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """RANSAC homography src -> dst. Returns (H, inlier_mask) or None."""
    src = np.asarray(src, dtype=np.float64).reshape(-1, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(-1, 2)
    n = src.shape[0]
    if n < 4:
        return None
    rng = np.random.default_rng(seed)
    best_inliers = None
    best_count = 0
    iters = max_iters
    it = 0
    while it < iters:
        it += 1
        idx = rng.choice(n, size=4, replace=False)
        H = dlt_homography(src[idx], dst[idx])
        if H is None:
            continue
        err = _reproj_err(H, src, dst)
        inl = err < threshold
        cnt = int(inl.sum())
        if cnt > best_count:
            best_count = cnt
            best_inliers = inl
            # adaptive termination (0.995 confidence)
            w = cnt / n
            if w > 0:
                denom = np.log(max(1e-12, 1.0 - w ** 4))
                if denom < 0:
                    iters = min(iters, int(np.ceil(
                        np.log(1.0 - CONFIDENCE) / denom)))
    if best_inliers is None or best_count < 4:
        return None
    H = dlt_homography(src[best_inliers], dst[best_inliers])
    if H is None:
        return None
    return H, best_inliers


__all__ = ["find_homography", "dlt_homography", "DEFAULT_THRESHOLD"]

"""Global star alignment (deep-sky registration).

Reference: ``register_star_alignment``
(src/registration/registration.c:525-784):

1. find stars on the reference frame (peaker), need >= 10
   (AT_MATCH_MINPAIRS), cap at MAX_STARS_FITTED = 2000 brightest
   (registration.c:55);
2. per frame: peaker → ``new_star_match`` (triangle vote + iterated
   TRANS) → RANSAC homography to the reference (3-px threshold);
3. warp the frame into the reference geometry (flip → warpPerspective →
   flip) and write it into a NEW sequence named ``<prefix><name>``
   (FITS files or one SER), with fresh imgparam/regparam carrying the
   frame's mean FWHM (:731-749);
4. in ``translation_only`` mode no warp happens: regdata stores
   shiftx = +h02, shifty = −h12 (:746-747, y sign flips because star
   coordinates are top-down while shift consumers are bottom-up).

Frames failing star detection or matching are dropped from the new
sequence (skip + new_total decrement, :683-690).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from siriltpu.core.frame import Frame, ImgParam, RegData
from siriltpu.ops.starfind import StarFinderParams, peaker
from siriltpu.ops.warp import INTER_LINEAR, warp_batch_dev
from siriltpu.registration.matching import (AT_MATCH_MINPAIRS,
                                            new_star_match)
from siriltpu.registration.ransac import find_homography

MAX_STARS_FITTED = 2000  # registration.c:55


@dataclass
class GlobalRegReport:
    registered: int = 0
    failed: int = 0
    new_seqname: str = ""
    homographies: List[Optional[np.ndarray]] = field(default_factory=list)
    fwhm: List[float] = field(default_factory=list)


def _fwhm_average(stars, n):
    if not stars:
        return 0.0, 0.0
    n = min(n, len(stars))
    fx = float(np.mean([s.fwhmx for s in stars[:n]]))
    fy = float(np.mean([s.fwhmy for s in stars[:n]]))
    return fx, fy


def compute_homography(stars_img, stars_ref, nbpoints: int
                       ) -> Optional[np.ndarray]:
    """new_star_match + RANSAC H (match.c:125-389 → cvCalculH)."""
    m = new_star_match(stars_img[:nbpoints], stars_ref[:nbpoints])
    if m is None:
        return None
    xy_img, xy_ref, _ = m
    res = find_homography(xy_img, xy_ref)
    if res is None:
        return None
    H, _ = res
    return H


def register_global_star(seq, layer: int, *, prefix: str = "r_",
                         interpolation: int = INTER_LINEAR,
                         translation_only: bool = False,
                         process_all_frames: bool = True,
                         sf_params: Optional[StarFinderParams] = None,
                         write_output: bool = True,
                         output_frames: Optional[list] = None,
                         mesh=None,
                         chunk_frames: Optional[int] = None
                         ) -> GlobalRegReport:
    """Run global star alignment over a Sequence
    (``register_star_alignment``, registration.c:525-784).

    Chunked engine: a loader thread reads frames ahead while the
    device works; each chunk of frames is star-found by ONE batched
    device program (:func:`siriltpu.ops.starfind.peaker_batch`,
    shardable over a ``frames`` mesh), matched + RANSAC'd on the host,
    then warped by ONE batched program; the aligned chunk is written
    back while the loader fills the next chunk. Chunk size comes from
    the device memory budget (:func:`siriltpu.core.memory.starfind_chunk_frames`)
    so sequences larger than device memory stream through. The
    reference processes one frame at a time in a serial loop
    (registration.c:655-749); per-frame results here are identical
    regardless of chunking or mesh partitioning (per-frame lax.map
    bodies — see parallel/mesh.run_frames_sharded).

    When ``write_output`` the aligned frames are written as a new
    sequence (``<prefix><seqname>``, FITS files or SER matching the
    input type); ``output_frames`` (a list) collects aligned Frames
    in-memory instead/additionally.
    """
    import queue
    import threading

    from siriltpu.core.memory import starfind_chunk_frames
    from siriltpu.io import fits as fits_io
    from siriltpu.io.seqfile import write_seqfile
    from siriltpu.io.sequence import Sequence
    from siriltpu.io.ser import SerFile
    from siriltpu.ops.starfind import peaker_batch

    report = GlobalRegReport(new_seqname=f"{prefix}{seq.seqname}")
    reg = seq.ensure_regparam(layer)
    ref_image = seq.reference_image if seq.reference_image >= 0 else 0

    ref_frame = seq.read_frame(ref_image)
    refstars = peaker(ref_frame.layer(layer), params=sf_params)
    if len(refstars) < AT_MATCH_MINPAIRS:
        raise ValueError(
            "There are not enough stars in reference image to perform alignment")
    fitted_stars = min(len(refstars), MAX_STARS_FITTED)
    fx_ref, fy_ref = _fwhm_average(refstars, fitted_stars)
    reg[ref_image].fwhm = fx_ref
    out_h, out_w = ref_frame.ry, ref_frame.rx

    todo = [i for i in range(seq.number)
            if process_all_frames or seq.imgparam[i].incl]
    n_dev = mesh.devices.size if mesh is not None else 1
    if chunk_frames is None:
        chunk_frames = starfind_chunk_frames(out_h, out_w, n_dev)
    chunks = [todo[i:i + chunk_frames]
              for i in range(0, len(todo), chunk_frames)]

    # loader thread: reads the NEXT chunk from disk while the device
    # star-finds/warps the current one (the reference reads serially
    # inside its loop, registration.c:666; here IO and device overlap)
    q: "queue.Queue" = queue.Queue(maxsize=1)
    abort = threading.Event()

    def _put(item) -> bool:
        # abort-aware put: if the consume loop died, stop instead of
        # blocking forever on the full queue (r4 advice fix)
        while not abort.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _loader():
        try:
            for ck in chunks:
                if abort.is_set():
                    return
                frames = [seq.read_frame(i) for i in ck]
                layers = np.stack([f.layer(layer) for f in frames])
                if not _put((ck, frames, layers)):
                    return
            _put(None)
        except BaseException as e:  # surface read errors in the main loop
            _put(e)

    loader = threading.Thread(target=_loader, daemon=True)
    loader.start()

    new_imgparam: List[ImgParam] = []
    new_regparam: List[RegData] = []
    new_ser = None
    if write_output and seq.seqtype == "ser" and not translation_only:
        from siriltpu.io.ser import SER_MONO, SER_RGB
        new_ser = SerFile.create(
            os.path.join(seq.seq_dir, report.new_seqname + ".ser"),
            width=out_w, height=out_h,
            color_id=SER_RGB if ref_frame.nlayers == 3 else SER_MONO)

    def _emit(warped: Frame, fidx: int, fwhm_val: float):
        if output_frames is not None:
            output_frames.append(warped)
        if write_output and not translation_only:
            if new_ser is not None:
                new_ser.write_frame(warped)
                new_imgparam.append(ImgParam(filenum=len(new_imgparam)))
            else:
                dest = os.path.join(
                    seq.seq_dir, f"{prefix}{seq.image_filename(fidx)}")
                fits_io.write_fits(dest, warped)
                new_imgparam.append(
                    ImgParam(filenum=seq.imgparam[fidx].filenum))
        new_regparam.append(RegData(fwhm=fwhm_val))

    def _consume():
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            ck, frames, layers = item
            star_lists, dev_layers = peaker_batch(layers, params=sf_params,
                                                  nmax=2048, mesh=mesh,
                                                  return_device=True)
            # host stage: triangle match + RANSAC per frame (match.c:125)
            good: List[int] = []         # positions within the chunk
            Hs: List[np.ndarray] = []
            fwhms: List[float] = []
            for j, fidx in enumerate(ck):
                if fidx == ref_image:
                    report.homographies.append(np.eye(3))
                    report.fwhm.append(fx_ref)
                    good.append(j)
                    Hs.append(np.eye(3))
                    fwhms.append(fx_ref)
                    report.registered += 1
                    continue
                stars = star_lists[j]
                if len(stars) < AT_MATCH_MINPAIRS:
                    report.failed += 1
                    report.homographies.append(None)
                    continue
                nbpoints = min(len(stars), fitted_stars)
                H = compute_homography(stars, refstars, nbpoints)
                if H is None:
                    report.failed += 1
                    report.homographies.append(None)
                    continue
                fx, fy = _fwhm_average(stars, nbpoints)
                reg[fidx].fwhm = fx
                report.homographies.append(H)
                report.fwhm.append(fx)
                good.append(j)
                Hs.append(H)
                fwhms.append(fx)
                report.registered += 1

            if translation_only:
                for j, H, fw in zip(good, Hs, fwhms):
                    fidx = ck[j]
                    if fidx != ref_image:
                        reg[fidx].shiftx = int(round(H[0, 2]))
                        reg[fidx].shifty = int(round(-H[1, 2]))
                    seq.imgparam[fidx].incl = True
                continue
            if not good:
                continue

            # device stage 2: ONE batched warp for the chunk's good frames.
            # The reference frame passes through unwarped (it IS the target
            # geometry, registration.c:720-722 warps every OTHER frame).
            warp_pos = [j for j in good if ck[j] != ref_image]
            warped_np = None
            if warp_pos:
                Hmap = {j: H for j, H in zip(good, Hs)}
                nlayers = frames[0].nlayers
                if nlayers == 1:
                    # reuse the star-find upload when available: the warp
                    # reads the same frames, so indexing the device copy
                    # halves the per-frame host->device traffic
                    src = dev_layers if dev_layers is not None else layers
                    stack = src[np.asarray(warp_pos)]
                    dev_layers = None   # free the full-chunk upload before
                    # the warp allocates its padded working set
                    Hsel = np.stack([Hmap[j] for j in warp_pos])
                else:
                    stack = np.concatenate(
                        [frames[j].data for j in warp_pos])
                    Hsel = np.stack([Hmap[j] for j in warp_pos
                                     for _ in range(nlayers)])
                warped_np = np.asarray(warp_batch_dev(
                    stack, Hsel, (out_h, out_w), interpolation, mesh=mesh))
                if nlayers > 1:
                    warped_np = warped_np.reshape(
                        len(warp_pos), nlayers, out_h, out_w)

            wi = 0
            for j, H, fw in zip(good, Hs, fwhms):
                fidx = ck[j]
                if fidx == ref_image:
                    _emit(frames[j], fidx, fw)
                    continue
                arr = warped_np[wi]
                wi += 1
                if arr.ndim == 2:
                    arr = arr[None]
                _emit(Frame(arr, dict(frames[j].meta)), fidx, fw)

    try:
        _consume()
    finally:
        # unblock a loader stuck on q.put, reap it, and ALWAYS close the
        # output SER (write_and_close fixes the header frame count, so
        # an error mid-sequence leaves a consistent truncated file
        # instead of an unclosed one)
        abort.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        loader.join(timeout=10)
        if new_ser is not None:
            new_ser.write_and_close()

    if write_output and not translation_only and report.registered:
        # build and persist the new sequence (end_register_idle,
        # registration.c:1199-1244)
        new_seq = Sequence(
            seqname=report.new_seqname,
            seqtype="ser" if new_ser is not None else "regular",
            seq_dir=seq.seq_dir, number=report.registered,
            selnum=report.registered, fixed=seq.fixed, ext=seq.ext,
            nb_layers=seq.nb_layers, rx=out_w, ry=out_h,
            imgparam=new_imgparam, regparam={layer: new_regparam})
        write_seqfile(new_seq, seq.seq_dir)
    seq.needs_saving = True
    return report


def global_align_batch(layers_bu: np.ndarray, ref_index: int = 0, *,
                       interpolation: int = INTER_LINEAR,
                       sf_params: Optional[StarFinderParams] = None,
                       nmax: int = 1024, mesh=None):
    """Multi-device global star alignment of an in-memory frame batch.

    The fully batched form of :func:`register_global_star`'s device
    work: ONE vmapped star-find program over all frames
    (:func:`siriltpu.ops.starfind.peaker_batch`), host triangle
    matching + RANSAC per frame, then ONE vmapped warp program — both
    device stages shard over a ``frames`` mesh axis so each chip
    processes its own frame subset (the reference's OpenMP-over-frames
    registration, registration.c:276-279, at chip scale; the warp and
    star find are frame-local so no collectives are needed).

    Returns ``(aligned, report)``: aligned (F, H, W) uint16 frames in
    reference geometry (failed frames pass through unwarped and are
    recorded in the report), and a GlobalRegReport with per-frame
    homographies (None on failure).
    """
    from siriltpu.ops.starfind import peaker_batch
    from siriltpu.ops.warp import warp_batch_dev

    layers_bu = np.asarray(layers_bu)
    f, h, w = layers_bu.shape
    report = GlobalRegReport()

    star_lists, dev_layers = peaker_batch(layers_bu, params=sf_params,
                                          nmax=nmax, mesh=mesh,
                                          return_device=True)
    refstars = star_lists[ref_index]
    if len(refstars) < AT_MATCH_MINPAIRS:
        raise ValueError(
            "There are not enough stars in reference image to perform alignment")
    fitted_stars = min(len(refstars), MAX_STARS_FITTED)

    Hs = np.tile(np.eye(3), (f, 1, 1))
    for i in range(f):
        if i == ref_index:
            report.homographies.append(np.eye(3))
            report.registered += 1
            continue
        stars = star_lists[i]
        if len(stars) < AT_MATCH_MINPAIRS:
            report.failed += 1
            report.homographies.append(None)
            continue
        nbpoints = min(len(stars), fitted_stars)
        H = compute_homography(stars, refstars, nbpoints)
        if H is None:
            report.failed += 1
            report.homographies.append(None)
            continue
        Hs[i] = H
        report.homographies.append(H)
        report.registered += 1

    src = dev_layers if dev_layers is not None else layers_bu
    aligned = np.asarray(warp_batch_dev(src, Hs, (h, w),
                                        interpolation, mesh=mesh))
    return aligned, report


__all__ = ["register_global_star", "global_align_batch",
           "compute_homography", "GlobalRegReport", "MAX_STARS_FITTED"]

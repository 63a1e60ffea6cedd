"""Primary dataset-generation driver (the para_gen.py equivalent).

End-to-end DAVIS-style generation (reference call stack SURVEY.md §3.1):
scan the input tree for frame pairs at distance --fd, preprocess, find sparse
correspondences, filter them to segment-consistent short-displacement
constraints, composite random backgrounds, ARAP-solve each (frame, segment),
compose per-segment products, and emit Flow/.flo + warped RGB/mask trees plus
``all_files.list``.

Differences from the reference by design:
- correspondences come from the on-device NCC pyramid matcher
  (ops/matching.py) instead of a DeepMatching subprocess; pass
  ``--matcher binary --dm_bin PATH`` to shell out exactly like
  para_gen.py:227-240, or ``--matcher file`` to reuse cached constraint files;
- ARAP solves run batched on the device (no per-GPU process farm / tmp list
  files; the jit cache replaces the per-size Opt plan rebuild);
- the directory layout, mask conventions, filter rules, --resume semantics and
  the final existence sweep (para_gen.py:594-603) are preserved.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import re
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np

from ..io import flo
from ..io.constraints import filter_matches, write_constraint_file
from ..io.image import (ARAP_BG, load_image, load_rgb, png_bytes, resize,
                        save_image)
from ..models.arap import ArapDeformer
from ..ops.solver import SolverConfig

log = logging.getLogger("arap_flow.para_gen")

from ..utils.profiling import StageTimer

TIMER = StageTimer()  # populated when ARAP_PROFILE=1

# (pairs_collected, loop_iteration_wall_s, t_end_unix) per batched-loop
# iteration of the LAST main_pipeline call — steady-state latency telemetry
# for endurance runs (scripts/endurance.py). Iterations overlap chunks
# (dispatch k while collecting k-1), so wall/pairs is per-pair THROUGHPUT
# latency, not submit-to-write latency. t_end anchors compile-census events
# to pair progress.
CHUNK_STATS: list = []

# pairs per vmapped matcher program in batched mode (fixed so the compile
# set stays at two programs: B=this and B=1 for ragged tails;
# ARAP_MATCH_SUBBATCH overrides for probing other sub-batches)
MATCH_SUBBATCH = int(os.environ.get("ARAP_MATCH_SUBBATCH", "4"))

# canonical directory names (para_gen.py:18-26)
ORGCOLOR = "orgRGB"
ORGMASK = "orgMasks"
COLOR_DIR = "inpRGB"
MASK_DIR = "inpMasks"
CNSTR_DIR = "tmpCnstr"
FLOW_DIR = "Flow"
WRGB_DIR = "wRGB"
WMASK_DIR = "wMasks"


@dataclass
class PairPaths:
    """All generated/original paths for one frame pair (the reference's entry
    dict, para_gen.py:417-429)."""

    rgb1_gen: str
    msk1_gen: str
    rgb2_gen: str
    msk2_gen: str
    cstr_tmp: str
    flow_gen: str
    rgb1_org: str
    msk1_org: str
    rgb2_org: str
    msk2_org: str


@dataclass
class PipelineFlags:
    input: str
    output: str
    bg_dir: str | None = None
    gpu: list = field(default_factory=lambda: [0])  # accepted for CLI parity
    multseg: bool = False
    resume: bool = False
    # batch budget (reference: buffered files per GPU). Default 2 → 4-pair
    # chunks: fine-grained chunks keep the depth-2 prep/solve pipeline full
    # and align with MATCH_SUBBATCH=4 matcher programs. The value predates
    # the GPU port and is not yet re-measured on the card.
    narap: int = 2
    size: tuple | None = None
    fd: int = 1
    matcher: str = "native"  # native | binary | file
    dm_bin: str | None = None
    schedule: str = "parity"  # parity | fast
    seed: int | None = None
    mode: str = "simple"  # simple (per-pair) | batched (bucketed cross-pair)
    warmup: bool = False  # compile the standard bucket programs up front
    shard: tuple | None = None  # (i, n): this host takes pairs with idx%n==i
    match_downscale: int = 1  # match on a 2^k-pooled image (faster, coarser)
    # mask gate semantics: "count" (default) skips pairs with <=10 OBJECT
    # PIXELS — a deliberate deviation: sub-10-px objects cannot be matched or
    # solved meaningfully; "refsum" replicates the reference exactly
    # (mask.sum() > 10 — sum of pixel VALUES, para_gen.py:251 — under which a
    # single 255-valued annotation pixel passes the gate)
    mask_gate: str = "count"  # count | refsum


def scale_rotate(im: np.ndarray, mk: np.ndarray, size):
    """Preprocessing parity (para_gen.py:253-291): transpose portrait frames,
    then resize (+10px slack) and center-crop to `size` (w, h). `im` is
    (H, W, 3), `mk` (H, W[, C]) as loaded."""
    if im.shape[:2] != mk.shape[:2]:
        # ValueError, not assert: this is a DATA error (one corrupt pair),
        # and the per-pair isolation handlers deliberately re-raise
        # AssertionError (programming errors) while skipping data failures —
        # an assert here would let one bad mask kill a whole batched run
        raise ValueError(
            f"Image and mask must be of the same size but given "
            f"{im.shape[1::-1]} vs {mk.shape[1::-1]}"
        )
    preprocessed = False
    if im.shape[0] > im.shape[1]:
        im = np.ascontiguousarray(np.swapaxes(im, 0, 1))
        mk = np.ascontiguousarray(np.swapaxes(mk, 0, 1))
        preprocessed = True
    h0, w0 = im.shape[:2]
    if size is not None and (w0, h0) != tuple(size):
        r = max(float(size[0] + 10) / w0, float(size[1] + 10) / h0)
        w, h = (np.array([w0, h0]) * r).astype(int)
        im = resize(im, (w, h))
        mk = resize(mk, (w, h), nearest=True)
        left = w // 2 - size[0] // 2
        upper = h // 2 - size[1] // 2
        im = im[upper : upper + size[1], left : left + size[0]]
        mk = mk[upper : upper + size[1], left : left + size[0]]
        preprocessed = True
    return preprocessed, im, mk


class BackgroundPool:
    """Random background images: scan once, draw without replacement until the
    pool refills; corrupt files are dropped (para_gen.py:365-375, 484-497)."""

    def __init__(self, bg_dir, rng: np.random.Generator):
        self.rng = rng
        self.paths: list[str] = []
        if bg_dir and osp.isdir(bg_dir):
            for root, _, files in os.walk(bg_dir):
                for f in files:
                    up = f.upper()
                    if ".PNG" in up or ".JPG" in up or ".JPEG" in up:
                        self.paths.append(osp.join(root, f))
        self.tmp: list[str] = []

    def fit(self, bg: np.ndarray, shape) -> np.ndarray:
        """Random 1-2× upscale + random crop to `shape` (fit_bg,
        para_gen.py:36-48)."""
        imh, imw = shape[:2]
        bgh, bgw = bg.shape[:2]
        r = self.rng.uniform(1, 2) * max(
            float(max(bgh, imh)) / bgh, float(max(bgw, imw)) / bgw
        )
        bg = resize(bg, (int(bgw * r), int(bgh * r)))
        sy = self.rng.integers(0, bg.shape[0] - imh + 1)
        sx = self.rng.integers(0, bg.shape[1] - imw + 1)
        return bg[sy : sy + imh, sx : sx + imw, :3]

    def draw(self, shape) -> np.ndarray | None:
        while self.paths:
            if not self.tmp:
                self.tmp = sorted(self.paths)
            p = self.tmp[self.rng.integers(0, len(self.tmp))]
            self.tmp.remove(p)
            try:
                return self.fit(load_rgb(p), shape)
            except Exception:
                self.paths.remove(p)
        return None


def add_bg(im: np.ndarray, mk: np.ndarray, bgim: np.ndarray, bgval=0):
    """Background compositing (add_bg, para_gen.py:50-61)."""
    assert mk.shape == im.shape[:-1], (
        f"Sizes mismatch mask and image {mk.shape} vs {im.shape[:-1]}"
    )
    assert bgim.shape == im.shape, (
        f"Sizes mismatch background and image {bgim.shape} vs {im.shape}"
    )
    out = im.copy()
    idx = mk == bgval
    out[idx] = bgim[idx]
    return out


def scan_pairs(flags: PipelineFlags) -> list[PairPaths]:
    """Input-tree scan with frame-distance pairing (para_gen.py:384-434):
    frames matched by the trailing number of ``(\\d+).jp?g`` (case-insensitive),
    masks as .png; pairs skipped when frame t+fd or either mask is missing;
    --resume skips pairs whose .flo already exists."""
    rgb_org = osp.join(flags.input, ORGCOLOR)
    msk_org = osp.join(flags.input, ORGMASK)
    out = flags.output
    reg = re.compile(r"(\d+)\.(jpe?g|png)", flags=re.IGNORECASE)

    pairs: list[PairPaths] = []
    for root, dirs, _ in os.walk(rgb_org):
        for d in sorted(dirs):
            folder = osp.join(root, d)
            files = sorted(
                f for f in os.listdir(folder) if reg.search(f) is not None
            )
            for f1 in files:
                seq = osp.join(root.replace(rgb_org, "").strip(osp.sep), d)
                f, ext = osp.splitext(f1)
                if not osp.exists(osp.join(msk_org, seq, f + ".png")):
                    continue
                num = reg.search(f1)
                n = "{:0" + str(len(num.group(1))) + "d}"
                nxt = int(num.group(1)) + flags.fd
                # substitute ONLY at the matched span (the digit run before
                # the extension): str.replace would also rewrite an earlier
                # occurrence of the same digits in the stem ('001_001.jpg'
                # -> '002_002' instead of '001_002', silently dropping or
                # mispairing frames)
                a, b = num.span(1)
                f2 = f[:a] + n.format(nxt) + f[b:]
                if not osp.exists(osp.join(rgb_org, seq, f2 + ext)) or not osp.exists(
                    osp.join(msk_org, seq, f2 + ".png")
                ):
                    continue
                pp = PairPaths(
                    rgb1_gen=osp.abspath(osp.join(out, COLOR_DIR, seq, f + ".png")),
                    msk1_gen=osp.abspath(osp.join(out, MASK_DIR, seq, f + ".png")),
                    rgb2_gen=osp.abspath(osp.join(out, WRGB_DIR, seq, f + ".png")),
                    msk2_gen=osp.abspath(osp.join(out, WMASK_DIR, seq, f + ".png")),
                    cstr_tmp=osp.abspath(osp.join(out, CNSTR_DIR, seq, f + ".txt")),
                    flow_gen=osp.abspath(osp.join(out, FLOW_DIR, seq, f + ".flo")),
                    rgb1_org=osp.abspath(osp.join(rgb_org, seq, f1)),
                    msk1_org=osp.abspath(osp.join(msk_org, seq, f + ".png")),
                    rgb2_org=osp.abspath(osp.join(rgb_org, seq, f2 + ext)),
                    msk2_org=osp.abspath(osp.join(msk_org, seq, f2 + ".png")),
                )
                if not flags.resume or not osp.exists(pp.flow_gen):
                    pairs.append(pp)
    if flags.shard is not None:
        # multi-host dataset sharding (SURVEY §2.7: scan + file IO per host
        # over DCN): host i of n takes every n-th pair. Deterministic from
        # the sorted scan, no coordination needed — hosts share only the
        # filesystem, exactly like the reference's process farm.
        i, n = flags.shard
        assert 0 <= i < n, f"--shard {i}/{n}"
        pairs = pairs[i::n]
    return pairs


def run_matching(
    flags: PipelineFlags, p: PairPaths, rgb1, rgb2, src_paths=None,
    roi_mask=None,
) -> np.ndarray:
    """Produce raw matches (N,4+) for a pair, by backend.

    `src_paths` (path1, path2) names the PREPROCESSED frame files the external
    matcher must see: when --size resizes or a portrait frame is transposed,
    matches must be in preprocessed coordinates or filter_matches silently
    misfilters them (the reference re-points rgb1_org/rgb2_org at the saved
    preprocessed files, para_gen.py:294-310). Defaults to the original files
    (correct when no preprocessing happened)."""
    if flags.matcher == "binary":
        assert flags.dm_bin and osp.exists(flags.dm_bin), (
            f"File not found {flags.dm_bin}"
        )
        src1, src2 = src_paths or (p.rgb1_org, p.rgb2_org)
        cmd = (
            f"{osp.abspath(flags.dm_bin)} {src1} {src2} -nt 0 "
            f"-out {p.cstr_tmp} -ngh_rad 100"
        )
        status = subprocess.call(cmd, shell=True)
        assert status == 0, f"matcher exited with code {status}: {cmd}"
        from ..io.constraints import read_matches

        return read_matches(p.cstr_tmp)
    if flags.matcher == "file":
        from ..io.constraints import read_matches

        return read_matches(p.cstr_tmp)
    from ..ops.matching import match_images

    return match_images(
        rgb1, rgb2, radius=100, downscale=flags.match_downscale,
        roi_mask=roi_mask,
    )[:, :4].astype(np.int32)


def has_mask(msk1, msk2, gate: str = "count") -> bool:
    """Both masks must have enough object content (para_gen.py:243-251).

    gate="count" (default): >10 nonzero PIXELS — deliberate deviation from
    the reference, which sums pixel VALUES (`mask.sum() > 10`,
    para_gen.py:251) so a single 255-valued pixel passes; a <=10-px object
    has nothing the matcher or solver can use. gate="refsum" replicates the
    reference's value-sum semantics exactly (PipelineFlags.mask_gate).
    """
    if gate == "refsum":
        return int(np.sum(msk1)) > 10 and int(np.sum(msk2)) > 10
    return int(np.sum(msk1 != 0)) > 10 and int(np.sum(msk2 != 0)) > 10


def _ensure_dirs(p: PairPaths):
    for path in vars(p).values():
        d = osp.dirname(path)
        if not osp.isdir(d):
            os.makedirs(d, exist_ok=True)


@dataclass
class PairWork:
    """Host-side products of one pair's prep stage, awaiting solves."""

    p: PairPaths
    out1: np.ndarray  # frame1 with background composited
    bgim: np.ndarray | None
    mk1: np.ndarray
    segments: list  # [(seg_id, arap_mask (H,W) u8, constraints (N,4))]


def decode_pair(flags: PipelineFlags, p: PairPaths):
    """Decode + preprocess one pair; returns
    (im1, mk1, im2, mk2, src1, src2, src1_path, src2_path) or None when the
    masks are empty (has_mask, para_gen.py:243-251). src*_path name the files
    an EXTERNAL matcher must read — the saved preprocessed frames when
    preprocessing happened, the originals otherwise."""
    with TIMER.stage("decode+preprocess"):
        pre1, im1, mk1 = scale_rotate(load_rgb(p.rgb1_org),
                                      load_image(p.msk1_org), flags.size)
        pre2, im2, mk2 = scale_rotate(load_rgb(p.rgb2_org),
                                      load_image(p.msk2_org), flags.size)
    if mk1.ndim == 3:
        mk1 = mk1[:, :, 0]
    if mk2.ndim == 3:
        mk2 = mk2[:, :, 0]

    if not has_mask(mk1, mk2, flags.mask_gate):
        return None

    # preprocessed sources feed the matcher when resizing happened
    if pre1 or pre2:
        save_image(p.rgb1_gen, im1)
        save_image(p.rgb2_gen, im2)
        src1, src2 = im1, im2
        src1_path, src2_path = p.rgb1_gen, p.rgb2_gen
    else:
        src1, src2 = im1, im2
        src1_path, src2_path = p.rgb1_org, p.rgb2_org
    return im1, mk1, im2, mk2, src1, src2, src1_path, src2_path


def prep_pair(
    flags: PipelineFlags, p: PairPaths, bgpool: BackgroundPool,
    prematched: np.ndarray | None = None,
    decoded: tuple | None = None,
) -> PairWork | None:
    """Host + matcher stage: preprocessing, matching, filtering, backgrounds,
    per-segment mask/constraint splitting. No solver work. `decoded` reuses
    a decode_pair result from the match-dispatch phase (batched mode decodes
    once, not twice per pair)."""
    _ensure_dirs(p)
    if decoded is None:
        decoded = decode_pair(flags, p)
    if decoded is None:
        return None
    im1, mk1, im2, mk2, src1, src2, src1_path, src2_path = decoded

    if prematched is not None:
        matches = prematched
    else:
        with TIMER.stage("matching"):
            matches = run_matching(
                flags, p, src1, src2, src_paths=(src1_path, src2_path),
                roi_mask=mk1,
            )
    kept, seg_ids = filter_matches(matches, mk1, mk2)
    write_constraint_file(p.cstr_tmp, kept)  # cache (para_gen.py:479)
    if len(kept) == 0:
        return None

    # background for this pair (applied to inpRGB now, wRGB after the solve)
    with TIMER.stage("background+inputs-io"):
        bgim = bgpool.draw(im1.shape)
        out1 = add_bg(im1, mk1, bgim) if bgim is not None else im1
        save_image(p.rgb1_gen, out1)

    segments = []
    if not flags.multseg:
        arap_mask = np.zeros_like(mk1, dtype=np.uint8)
        arap_mask[mk1 == 0] = ARAP_BG  # para_gen.py:514-517
        save_image(p.msk1_gen, arap_mask)
        segments.append((0, arap_mask, kept))
    else:
        for s in np.unique(seg_ids):
            if s == 0:
                continue
            arap_mask = np.full_like(mk1, ARAP_BG, dtype=np.uint8)
            arap_mask[mk1 == s] = 0  # para_gen.py:526-528
            cons_s = kept[seg_ids == s]
            assert len(cons_s) > 0, f"Segment {s} has no constraint"
            segments.append((int(s), arap_mask, cons_s))
        if not segments:
            return None
        save_image(p.msk1_gen, np.where(mk1 == 0, ARAP_BG, 0).astype(np.uint8))
    return PairWork(p=p, out1=out1, bgim=bgim, mk1=mk1, segments=segments)


def finish_pair(work: PairWork, seg_results: list, writer=None) -> list[str]:
    """Compose per-segment results (flatten, para_gen.py:151-164), re-apply the
    background to uncovered warped pixels, write outputs."""
    p = work.p
    flow = seg_results[0].flow.copy()
    wrgb = seg_results[0].warped_rgb.copy()
    wmask = seg_results[0].warped_mask.copy()
    for r in seg_results[1:]:
        ob = r.warped_mask != 0
        flow[ob] = r.flow[ob]
        wrgb[ob] = r.warped_rgb[ob]
        wmask[ob] = r.warped_mask[ob]
    if work.bgim is not None:
        wrgb = add_bg(wrgb, wmask, work.bgim)

    if writer is not None:
        writer.submit_flo(p.flow_gen, flow.astype(np.float32))
        writer.submit_bytes(p.rgb2_gen, png_bytes(wrgb))
        writer.submit_bytes(p.msk2_gen, png_bytes(wmask))
    else:
        flo.flow_write(p.flow_gen, flow.astype(np.float32))
        save_image(p.rgb2_gen, wrgb)
        save_image(p.msk2_gen, wmask)
    return [p.rgb1_gen, p.rgb2_gen, p.flow_gen]


def process_pair(
    flags: PipelineFlags,
    p: PairPaths,
    deformer: ArapDeformer,
    bgpool: BackgroundPool,
    writer=None,
) -> list[str] | None:
    """Run one frame pair end-to-end (simple sequential mode). Returns the
    lmdb triple [inpRGB, wRGB, flo] on success, None when skipped."""
    work = prep_pair(flags, p, bgpool)
    if work is None:
        return None
    with TIMER.stage("solve+raster"):
        seg_results = [
            deformer.deform(work.out1, arap_mask, cons)
            for _, arap_mask, cons in work.segments
        ]
    with TIMER.stage("compose+outputs-io"):
        return finish_pair(work, seg_results, writer)


def prep_chunk_batched(
    flags: PipelineFlags,
    pairs: list[PairPaths],
    weights,
    bgpool: BackgroundPool,
):
    """Host+matcher preparation for a chunk: decode, match, filter, bucket.

    Returns (works, tasks, fallbacks) ready for execute_chunk_batched. Split
    out so main_pipeline can run the NEXT chunk's prep on a worker thread
    while the current chunk's solves occupy the device (the matcher's device
    dispatches interleave safely; the host decode/bg/crop work hides)."""
    # matcher failures fall back to prep_pair's isolated retry
    handles = prep_chunk_dispatch_match(flags, pairs)
    return prep_chunk_finish(flags, pairs, handles, weights, bgpool)


def prep_chunk_dispatch_match(flags: PipelineFlags, pairs):
    """Phase A of chunk prep: decode + DISPATCH the matcher programs (async).

    Called on the MAIN thread BEFORE the previous chunk's solves are
    dispatched, so the matchers sit AHEAD of them in the device queue —
    phase B (on the worker) can then fetch the matches and finish the whole
    host prep while the previous chunk's solves still occupy the device
    (otherwise the post-matcher host tail lands after the solves finish and
    the device idles for it)."""
    if flags.matcher != "native":
        return None
    from ..ops.matching import (match_images_dispatch,
                                match_images_dispatch_multi)

    handles = []
    with TIMER.stage("match dispatch"):
        decoded = []
        for p in pairs:
            try:
                _ensure_dirs(p)
                d = decode_pair(flags, p)
                if d is not None:
                    decoded.append((p, d))
            except Exception as e:
                log.warning("pair match dispatch failed: %s (%s)",
                            p.rgb1_org, e)
        # same-shaped pairs dispatch through ONE vmapped matcher program in
        # fixed sub-batches of MATCH_SUBBATCH (one dispatch per sub-batch;
        # fixed B keeps the compile set at two programs). Ragged tails and
        # odd shapes go per-pair.
        groups: dict = {}
        for p, d in decoded:
            groups.setdefault(d[4].shape, []).append((p, d))
        for _, grp in groups.items():
            i, retry = 0, []
            while i < len(grp):
                sub = grp[i : i + MATCH_SUBBATCH]
                i += MATCH_SUBBATCH
                n_real = len(sub)
                if n_real == 1:
                    # a single leftover runs per-pair: one B=1 program beats
                    # B-1 wasted duplicate slots
                    retry.extend(sub)
                    continue
                # ragged tail (2..B-1): pad by repeating the last pair (a
                # padded slot costs less than a separate per-pair program)
                padded = sub + [sub[-1]] * (MATCH_SUBBATCH - n_real)
                try:
                    hs = match_images_dispatch_multi(
                        [(d[4], d[5]) for _, d in padded], radius=100,
                        downscale=flags.match_downscale)
                    handles.extend(
                        (p, h, d)
                        for (p, d), h in zip(sub, hs[:n_real]))
                except Exception as e:
                    log.warning("multi match dispatch failed (%s); "
                                "falling back per-pair", e)
                    retry.extend(sub)
            for p, d in retry:
                try:
                    handles.append((p, match_images_dispatch(
                        d[4], d[5], radius=100,
                        downscale=flags.match_downscale), d))
                except Exception as e:
                    log.warning("pair match dispatch failed: %s (%s)",
                                p.rgb1_org, e)
    return handles


def prep_chunk_finish(flags: PipelineFlags, pairs, handles, weights, bgpool):
    """Phase B of chunk prep: fetch matches, filter, backgrounds, bucket."""
    from ..ops.matching import match_images_fetch
    from .batch import make_task

    prematched: dict = {}
    predecoded: dict = {}
    if handles is not None:
        with TIMER.stage("matching"):
            for p, h, d in handles:
                # phase A already decoded+preprocessed this pair — hand the
                # arrays to prep_pair so it doesn't decode AGAIN
                predecoded[id(p)] = d
                try:
                    # selection restricted to the annotated objects: the
                    # constraint filter drops off-object matches anyway
                    m = match_images_fetch(h, roi_mask=d[1])
                    prematched[id(p)] = m[:, :4].astype(np.int32)
                except Exception as e:
                    log.warning("pair matching failed: %s (%s)",
                                p.rgb1_org, e)

    works: list[PairWork] = []
    tasks, fallbacks = [], []
    for p in pairs:
        try:
            w = prep_pair(flags, p, bgpool, prematched.get(id(p)),
                          decoded=predecoded.get(id(p)))
        except AssertionError:
            raise
        except Exception as e:
            log.warning("pair prep failed: %s (%s)", p.rgb1_org, e)
            w = None
        if w is None:
            continue
        idx = len(works)
        works.append(w)
        for seg_id, arap_mask, cons in w.segments:
            t = make_task(idx, seg_id, w.out1, arap_mask, cons, weights)
            if t is not None:
                tasks.append(t)
            else:
                # raw constraints: add_fallback pins the border itself
                # (duplicated pins would double-weight the border fit terms)
                fallbacks.append((idx, seg_id, w.out1, arap_mask, cons))
    return works, tasks, fallbacks


def execute_chunk_batched(
    flags: PipelineFlags,
    prepped,
    cfg,
    weights,
    writer=None,
    mesh=None,
) -> list[str]:
    """Solve + compose + write one prepped chunk (see prep_chunk_batched).
    With `mesh` (--mode sharded) the bucket batches are sharded over the
    mesh's 'data' axis — the reference's multi-GPU farm (para_gen.py:560-567)
    as zero-collective data parallelism."""


    return collect_chunk_batched(
        flags, dispatch_chunk_batched(prepped, cfg, weights, mesh=mesh),
        cfg, weights, writer,
    )


def dispatch_chunk_batched(prepped, cfg, weights, mesh=None):
    """Dispatch a prepped chunk's solves (async) — returns inflight state
    for collect_chunk_batched. Dispatch errors are captured, not raised
    (the collector owns the per-pair retry)."""
    from .batch import BatchRunner

    works, tasks, fallbacks = prepped
    runner = BatchRunner(cfg, mesh=mesh, weights=weights, timer=TIMER)
    err = None
    try:
        for t in tasks:
            runner.add(t)
        for fb in fallbacks:
            runner.add_fallback(*fb)
        runner.flush()
    except Exception as e:  # poisoned chunk: retried per pair in collect
        err = e
    return works, runner, err


def collect_chunk_batched(flags, inflight, cfg, weights, writer) -> list[str]:
    """Fetch a dispatched chunk's products, compose + write per pair."""
    works, runner, err = inflight
    results = None
    if err is None:
        try:
            results = runner.collect()
        except Exception as e:
            err = e
    if err is not None:
        # failure isolation: a poisoned segment fails its chunk — retry the
        # chunk pair-by-pair through the simple path (the reference's worker
        # processes isolate at pair granularity, para_gen.py:194-195)
        log.warning("batched chunk failed (%s); retrying per pair", err)
        deformer = ArapDeformer(cfg, weights=weights, crop=True)
        triples = []
        for w in works:
            try:
                seg_results = [
                    deformer.deform(w.out1, m, cns) for _, m, cns in w.segments
                ]
                triples.append(" ".join(finish_pair(w, seg_results, writer)))
            except Exception as e2:
                log.warning("pair failed: %s (%s)", w.p.rgb1_org, e2)
        return triples

    triples = []
    for idx, w in enumerate(works):
        seg_results = [
            results[(idx, seg_id)] for seg_id, _, _ in w.segments
            if (idx, seg_id) in results
        ]
        if seg_results:
            triples.append(" ".join(finish_pair(w, seg_results, writer)))
    return triples


def process_chunk_batched(
    flags: PipelineFlags,
    pairs: list[PairPaths],
    cfg,
    weights,
    bgpool: BackgroundPool,
    writer=None,
    mesh=None,
) -> list[str]:
    """Batched mode, one chunk end-to-end (prep + execute in sequence)."""
    return execute_chunk_batched(
        flags, prep_chunk_batched(flags, pairs, weights, bgpool),
        cfg, weights, writer, mesh=mesh,
    )


def prewarm(cfg, weights, buckets=None, batched: bool = True,
            frame_shape: tuple | None = None,
            match_downscale: int = 1, mesh=None) -> None:
    """Compile the standard bucket solver programs on dummy problems before
    the first real pair arrives (--warmup). Prewarming moves the one-time
    XLA compiles ahead of the pipeline's timed/streamed phase. Covers the batched kernel at each
    bucket's standard chunk size (batched/sharded mode) or the per-problem
    program (simple mode). `mesh` (--mode sharded) warms the jit(shard_map)
    executable the sharded dispatch actually runs — a DIFFERENT top-level
    program from the unsharded impl — at the sharded chunk size."""
    import jax
    import jax.numpy as jnp

    from ..io.constraints import add_border_pins
    from ..models.arap import solve_and_raster_canvas
    from ..ops import energy as E
    from .batch import PREWARM_BUCKETS, max_chunk_for

    t_all = time.time()
    for bh, bw in buckets or PREWARM_BUCKETS:
        t0 = time.time()
        mask = np.full((bh, bw), 255, np.uint8)
        mask[8 : bh - 8, 8 : bw - 8] = 0
        cons = add_border_pins(
            np.array([[bw // 2, bh // 2, bw // 2 + 2, bh // 2 + 1]], np.int32),
            bw, bh,
        )
        ops = E.build_compact(mask, cons, weights)
        rgb = np.zeros((3, bh, bw), np.uint8)
        # warm the solve==canvas case (small-displacement pairs hit it;
        # larger-displacement canvas combos compile on demand). Simple mode
        # (crop=True) runs the SAME canvas program at B=1 with full-frame
        # flow output — warm that exact signature, not the full-frame
        # fallback (_solve_and_raster), which only rare no-bucket-fits
        # segments hit.
        n_data = 1 if mesh is None else mesh.shape["data"]
        B = max_chunk_for((bh, bw), n_data) if batched else 1
        # numpy stacks: must match the production dispatch's input types
        # (batch.BatchRunner._dispatch) so the warmed executable fingerprint
        # is the one the pipeline actually hits
        b_ops = jax.tree.map(lambda l: np.stack([l] * B), ops)
        out = solve_and_raster_canvas(
            b_ops, np.stack([rgb] * B), np.zeros((B, 2), np.int32),
            cfg, canvas_hw=(bh, bw), compact_flow=batched, mesh=mesh)
        jax.block_until_ready(out[1])
        print(f"warmup {bh}x{bw}: {time.time() - t0:.1f}s", flush=True)
    if frame_shape is not None:
        from ..ops.matching import (clamp_match_params, match_grid,
                                    match_grid_multi)

        t0 = time.time()
        H, W = frame_shape
        # same clamps as match_images: otherwise small frames warm a program
        # (levels/radius) different from the one actually run
        ds = max(1, int(match_downscale))
        radius, levels = clamp_match_params(
            H // ds, W // ds, int(np.ceil(100 / ds))
        )
        z = jnp.zeros((3, H, W), jnp.uint8)
        jax.block_until_ready(
            match_grid(z, z, stride=max(1, 4 // ds), radius=radius,
                       levels=levels, downscale=ds)[0]
        )
        if batched:
            zb = jnp.zeros((MATCH_SUBBATCH, 3, H, W), jnp.uint8)
            jax.block_until_ready(
                match_grid_multi(zb, zb, stride=max(1, 4 // ds),
                                 radius=radius, levels=levels,
                                 downscale=ds)[0]
            )
        print(f"warmup matcher {H}x{W}: {time.time() - t0:.1f}s", flush=True)
    print(f"warmup done in {time.time() - t_all:.1f}s", flush=True)


def make_solver_config(schedule: str) -> SolverConfig:
    if schedule == "parity":
        return SolverConfig()
    # fast: full depth only near alpha=1 (measured: EPE 0.21px,
    # docs/PARITY.md) — a fixed budget, no data-dependent exits
    return SolverConfig(pcg_iters_early=150.0, anneal_split=12.0)


def main_pipeline(
    flags: PipelineFlags, solver_cfg: SolverConfig | None = None
) -> list[str]:
    # unified config (SURVEY §5): CLI flags give the base, ARAP_* env vars
    # override on top (ARAP_SCHEDULE/ARAP_BACKEND/ARAP_RASTER/ARAP_MATCHER/
    # ARAP_W_FIT/ARAP_W_REG), mirroring the reference's $ARAP_PLAN precedence
    from ..utils.config import FrameworkConfig

    fw = FrameworkConfig.from_env(
        solver=solver_cfg or make_solver_config(flags.schedule),
        matcher=flags.matcher,
    )
    flags.matcher = fw.matcher
    if fw.raster == "host" and flags.mode != "simple":
        # the exact host rasterizer runs per pair; batched chunks rasterize
        # inside the device program
        print("ARAP_RASTER=host: forcing --mode simple (exact per-pair raster)")
        flags.mode = "simple"
    CHUNK_STATS.clear()
    rng = np.random.default_rng(flags.seed)
    bgpool = BackgroundPool(flags.bg_dir, rng)
    deformer = ArapDeformer(
        fw.solver, weights=fw.weights, crop=fw.crop, raster=fw.raster,
    )

    pairs = scan_pairs(flags)
    print(f"{len(pairs)} frame pairs to process")
    mesh = None
    if flags.mode == "sharded":
        from ..parallel import make_mesh

        mesh = make_mesh()  # all visible devices on the 'data' axis
        print(f"sharded over {mesh.shape['data']} devices")
    if flags.warmup and pairs:
        # --size is (w, h); the matcher program compiles only when the frame
        # shape is known up front
        fshape = (flags.size[1], flags.size[0]) if flags.size else None
        # ARAP_WARMUP_FULL=1: precompile the ENTIRE bucket ladder (31 shapes)
        # instead of the 13 common ones — 2-3x the warmup wall time, zero
        # on-demand compiles afterwards; pair with --exec_pack so one builder
        # process pays it for the whole worker farm
        buckets = None
        if os.environ.get("ARAP_WARMUP_FULL", "") not in ("", "0", "off"):
            from ..models.arap import CROP_BUCKETS

            buckets = CROP_BUCKETS
        prewarm(deformer.cfg, deformer.weights, buckets=buckets,
                batched=flags.mode in ("batched", "sharded"),
                frame_shape=fshape,
                match_downscale=flags.match_downscale, mesh=mesh)
    triples = []
    begin = time.time()

    writer = None
    try:
        from ..native.runtime import AsyncWriter, native_available

        # FrameworkConfig knobs are live: async_io=False forces synchronous
        # writes (debugging write ordering), io_threads sizes the pool
        if fw.async_io and native_available():
            writer = AsyncWriter(threads=max(1, int(fw.io_threads)))
    except Exception:
        writer = None

    try:
        if flags.mode in ("batched", "sharded"):
            cfg = deformer.cfg
            chunk = max(flags.narap, 1) * 2
            if mesh is not None:
                chunk = max(chunk, mesh.shape["data"] * 2)
            # pipelined: chunk k+1's host+matcher prep runs on a worker
            # thread while chunk k's solves occupy the device (single
            # worker keeps prep order and the BackgroundPool draw
            # sequence deterministic)
            from concurrent.futures import ThreadPoolExecutor

            # ramp-up: the FIRST chunk's match-fetch + filter + bucket prep
            # cannot overlap any solves (nothing is in flight yet), so a
            # half-size first chunk halves the pipeline-fill bubble; the
            # MATCH_SUBBATCH-multiple keeps its matcher programs unpadded
            first = max(MATCH_SUBBATCH, (chunk // 2) // MATCH_SUBBATCH
                        * MATCH_SUBBATCH)
            if len(pairs) > chunk and first < chunk:
                chunks = [pairs[:first]] + [
                    pairs[i : i + chunk]
                    for i in range(first, len(pairs), chunk)
                ]
            else:
                chunks = [pairs[i : i + chunk]
                          for i in range(0, len(pairs), chunk)]
            # depth-2 pipeline: while chunk k's solves execute, chunk k+1's
            # prep (phase B: match fetch, filter, bg, bucketing) runs on the
            # worker thread and chunk k-1's compose/write runs on the main
            # thread. Chunk k+1's MATCHER programs are dispatched (phase A,
            # main thread) BEFORE chunk k's solves so they sit ahead in the
            # device queue — prep(k+1) finishes well inside solves(k) and
            # the device never idles between chunks.
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = None
                if chunks:
                    ha = prep_chunk_dispatch_match(flags, chunks[0])
                    fut = ex.submit(prep_chunk_finish, flags, chunks[0], ha,
                                    deformer.weights, bgpool)
                inflight = None  # dispatched-runner state of chunk k-1
                prof = os.environ.get("ARAP_PROFILE")
                pairs_started = 0  # chunks are non-uniform (ramp-up first)
                for i, ch in enumerate(chunks):
                    print(f"{100.0 * pairs_started / max(len(pairs), 1):.3f}%",
                          flush=True)
                    pairs_started += len(ch)
                    t0 = time.time()
                    if i + 1 < len(chunks):
                        ha_next = prep_chunk_dispatch_match(
                            flags, chunks[i + 1])
                    t1 = time.time()
                    prepped = fut.result()
                    t2 = time.time()
                    if i + 1 < len(chunks):
                        fut = ex.submit(prep_chunk_finish, flags,
                                        chunks[i + 1], ha_next,
                                        deformer.weights, bgpool)
                    disp = dispatch_chunk_batched(
                        prepped, cfg, deformer.weights, mesh=mesh
                    )
                    t3 = time.time()
                    if inflight is not None:
                        triples += collect_chunk_batched(
                            flags, inflight, cfg, deformer.weights, writer
                        )
                    t4 = time.time()
                    if prof:
                        print(f"  [chunk {i}] phaseA {t1-t0:.2f}s "
                              f"prep-wait {t2-t1:.2f}s dispatch {t3-t2:.2f}s "
                              f"collect+finish {t4-t3:.2f}s", flush=True)
                    if i > 0:
                        CHUNK_STATS.append((len(chunks[i - 1]), t4 - t0, t4))
                    inflight = disp
                if inflight is not None:
                    t0 = time.time()
                    triples += collect_chunk_batched(
                        flags, inflight, cfg, deformer.weights, writer
                    )
                    t4 = time.time()
                    CHUNK_STATS.append((len(chunks[-1]), t4 - t0, t4))
        else:
            # pipelined simple mode: the next pair's host+matcher prep runs on
            # a worker thread while the current pair's solves occupy the
            # device (jax dispatch is thread-safe; one worker keeps prep order
            # and the BackgroundPool draw sequence deterministic)
            from concurrent.futures import ThreadPoolExecutor

            def safe_prep(p):
                try:
                    return prep_pair(flags, p, bgpool)
                except AssertionError:
                    raise
                except Exception as e:
                    log.warning("pair prep failed: %s (%s)", p.rgb1_org, e)
                    return None

            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(safe_prep, pairs[0]) if pairs else None
                for i, p in enumerate(pairs):
                    print(f"{100.0 * i / max(len(pairs), 1):.3f}%", flush=True)
                    work = fut.result()
                    if i + 1 < len(pairs):
                        fut = ex.submit(safe_prep, pairs[i + 1])
                    if work is None:
                        continue
                    try:
                        with TIMER.stage("solve+raster"):
                            seg_results = [
                                deformer.deform(work.out1, m, cns)
                                for _, m, cns in work.segments
                            ]
                        with TIMER.stage("compose+outputs-io"):
                            t = finish_pair(work, seg_results, writer)
                    except Exception as e:  # keep generating; log the failure
                        log.warning("pair failed: %s (%s)", p.rgb1_org, e)
                        t = None
                    if t is not None:
                        triples.append(" ".join(t))
    finally:
        if writer is not None:
            writer.close()
            n_err = writer.errors()
            if n_err:
                # failed/truncated async writes (disk full, perms): surface
                # them — the existence sweep below checks presence only, so
                # a truncated file would otherwise enter all_files.list
                log.error(
                    "%d async product writes FAILED (possibly truncated "
                    "files on disk) — the all_files.list existence sweep "
                    "cannot detect truncation; verify the output tree",
                    n_err,
                )
    print(f"done in {(time.time() - begin) / 60:.2f} mins")
    if os.environ.get("ARAP_PROFILE"):
        print(TIMER.report())

    # final existence sweep (para_gen.py:594-603)
    out_paths = [
        line
        for line in triples
        if all(osp.exists(l) for l in line.split(" "))
    ]
    os.makedirs(flags.output, exist_ok=True)
    # multi-host runs share the output tree: each shard writes its own list
    # (disjoint union over shards = the unsharded list; cat them for training)
    name = (
        "all_files.list" if flags.shard is None
        else f"all_files.list.{flags.shard[0]}of{flags.shard[1]}"
    )
    with open(osp.join(flags.output, name), "w") as f:
        f.write("\n".join(out_paths))
    return out_paths


def parse_args(argv=None) -> PipelineFlags:
    parser = argparse.ArgumentParser(
        description="Arguments for ARAP flow generation"
    )
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--bg_dir", type=str, default=None,
                        help="background image pool directory")
    parser.add_argument("--gpu", nargs="*", type=int, default=[0],
                        help="accepted for CLI parity; devices come from jax")
    parser.add_argument("--multseg", action="store_true", default=False,
                        help="if each object segment is treated separately")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="skip pairs whose .flo already exists")
    parser.add_argument("--narap", type=int, default=2,
                        help="solver batch budget (parity flag; chunk = 2x "
                        "this pairs)")
    parser.add_argument("--size", nargs=2, type=int, default=None,
                        help="[width] [height] to resize+crop all frames to")
    parser.add_argument("--fd", type=int, default=1,
                        help="frame distance between the pair")
    parser.add_argument("--matcher", choices=["native", "binary", "file"],
                        default="native")
    parser.add_argument("--dm_bin", default=None,
                        help="DeepMatching binary (with --matcher binary)")
    parser.add_argument("--arap_bin", default=None,
                        help="ignored (solver is built in); parity flag")
    # Accepted no-ops: the reference parses these but never reads the parsed
    # values either (para_gen.py:615-618 — no uses of rm_cnstr/rm_wmask/
    # rm_tmp_cmd/img_pattern anywhere in its tree).
    parser.add_argument("--rm-cnstr", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rm-wmask", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rm-tmp-cmd", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--img-pattern", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--schedule", choices=["parity", "fast"],
                        default="parity")
    parser.add_argument("--mode", choices=["simple", "batched", "sharded"],
                        default="simple",
                        help="batched buckets segments across pairs into one "
                        "compiled program per bucket shape; sharded "
                        "additionally shards bucket batches over all visible "
                        "devices ('data' mesh axis)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--shard", default=None, metavar="I/N",
                        help="multi-host split: this host processes pairs "
                        "I, I+N, I+2N, ... of the sorted scan (e.g. 0/4)")
    parser.add_argument("--warmup", action="store_true",
                        help="compile the standard bucket solver programs "
                        "before processing (hides the one-time XLA "
                        "compiles on cold caches)")
    parser.add_argument("--match_downscale", type=int, default=1,
                        choices=[1, 2, 4],
                        help="run the native matcher on a 2x2^k-pooled "
                        "image: ~4x/octave cheaper, slightly coarser "
                        "matches (the constraint filter + solver absorb "
                        "the precision loss)")
    parser.add_argument("--exec_pack", default=None, metavar="DIR",
                        help="executable-pack directory (sets ARAP_EXEC_PACK)"
                        ": canvas solver executables are serialized here and "
                        "loaded by later processes WITHOUT recompiling — "
                        "combine with --warmup in one builder process, then "
                        "start the --shard worker farm against the same DIR "
                        "(utils/aot.py)")
    parser.add_argument("--mask_gate", choices=["count", "refsum"],
                        default="count",
                        help="empty-mask skip semantics: 'count' skips pairs "
                        "with <=10 object PIXELS (default; deliberate "
                        "deviation); 'refsum' replicates the reference's "
                        "mask.sum()>10 pixel-VALUE sum (para_gen.py:251)")
    a = parser.parse_args(argv)
    assert 0 < a.fd < 20, "Invalid fd number!"
    if a.exec_pack:
        os.environ["ARAP_EXEC_PACK"] = a.exec_pack
    return PipelineFlags(
        input=a.input.rstrip(osp.sep),
        output=a.output.rstrip(osp.sep),
        bg_dir=a.bg_dir,
        gpu=a.gpu,
        multseg=a.multseg,
        resume=a.resume,
        narap=a.narap,
        size=tuple(a.size) if a.size else None,
        fd=a.fd,
        matcher=a.matcher,
        dm_bin=a.dm_bin,
        schedule=a.schedule,
        seed=a.seed,
        mode=a.mode,
        warmup=a.warmup,
        shard=tuple(int(x) for x in a.shard.split("/")) if a.shard else None,
        match_downscale=a.match_downscale,
        mask_gate=a.mask_gate,
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return main_pipeline(parse_args(argv))


if __name__ == "__main__":
    main()

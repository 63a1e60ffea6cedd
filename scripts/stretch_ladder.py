"""Deformation ladder: matcher coverage/accuracy vs LOCAL STRETCH, and the
cat512 arm-B through-solve with the extended affine-hypothesis bank.

Settles the DeepMatching-replacement question with data (the DM binary is
unobtainable in this environment — zero egress; get_deepmatching.sh's wget
fails): DM's split-and-rescore quadtree is built for large non-rigid stretch,
so we measure exactly that axis on our engine. Parametric warps
x' = x + dx + A·sin(2πx/λ) sweep peak local stretch A·2π/λ from 10% to 60%;
coverage (fraction of interior stride cells with a surviving match) and
median match EPE vs the analytic truth are reported for

  - the production default (rotation hypotheses only), and
  - STRETCH_HYPOTHESES (rotations + iso/aniso scale seeds — the
    DM-deformation-tolerance analogue in this matcher's architecture).

Then the cat512 fixture (the one real-imagery case; artist warp with ~50%
local stretch and 139 px extremes) runs arm B of the through-solve A/B
(scripts/matcher_ab.py) with both banks.

Run on the GPU:  python scripts/stretch_ladder.py          (~10 min with compiles)
Quick CPU:   JAX_PLATFORMS=cpu python scripts/stretch_ladder.py --fast
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


from arap_flow.io import flo
from arap_flow.io.image import load_rgb, load_mask
from arap_flow.models.arap import ArapDeformer
from arap_flow.ops.matching import (
    DEFAULT_ROTATIONS, STRETCH_HYPOTHESES, match_images,
)
from arap_flow.ops.solver import SolverConfig

from matcher_ab import _filter, _texture, _warp_bilinear


def ladder_case(stretch: float, H=256, W=384, lam=80.0, dx=30.0, seed=5):
    """x' = x + dx + A·sin(2πx/λ) with peak local stretch = A·2π/λ."""
    amp = stretch * lam / (2 * np.pi)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd_x = xx + dx + amp * np.sin(2 * np.pi * xx / lam)
    fwd_y = yy.copy()
    inv_x = xx - dx
    for _ in range(40):  # fixed point of the (contractive) inverse
        inv_x = xx - dx - amp * np.sin(2 * np.pi * inv_x / lam)
    im1 = _texture(H, W, seed)
    im2 = _warp_bilinear(im1, inv_x, yy)
    return im1, im2, fwd_x, fwd_y


def measure(im1, im2, fwd_x, fwd_y, rotations, stride=4, margin=16,
            radius=64, subpatch=False):
    H, W = im1.shape[:2]
    m = match_images(im1, im2, radius=radius, stride=stride,
                     rotations=rotations, subpatch=subpatch)
    x1 = m[:, 0].astype(int)
    y1 = m[:, 1].astype(int)
    keep = ((x1 >= margin) & (x1 < W - margin)
            & (y1 >= margin) & (y1 < H - margin))
    m, x1, y1 = m[keep], x1[keep], y1[keep]
    n_cells = ((H - 2 * margin) // stride) * ((W - 2 * margin) // stride)
    cov = len(m) / max(n_cells, 1)
    if len(m) == 0:
        return cov, np.nan, np.nan
    err = np.hypot(m[:, 2] - m[:, 0] - (fwd_x[y1, x1] - x1),
                   m[:, 3] - m[:, 1] - (fwd_y[y1, x1] - y1))
    return cov, float(np.median(err)), float(np.percentile(err, 90))


def main():
    import jax

    fast = "--fast" in sys.argv
    print("devices:", jax.devices(), flush=True)

    if "--subpatch" in sys.argv:
        # A/B the DeepMatching-style split-and-rescore coarse search
        # (ops/matching._search_subpatch) against the rigid-patch default.
        # MEASURED NEGATIVE (2026-08-18, CPU, this script): coverage drops at
        # every stretch level (30%: 0.76→0.67, 50%: 0.47→0.34, 60%:
        # 0.48→0.29, 80%: 0.27→0.12) with no accuracy gain — averaging four
        # relaxed half-size children blurs the correlation peak on this
        # matcher's already-coarse top level, and the affine stretch
        # hypotheses cover the within-patch deformation axis better. The
        # mode stays opt-in-off; see docs/PARITY.md.
        print(f"\n{'stretch':>8s} | {'rigid cov/med':>15s} | "
              f"{'subpatch cov/med':>17s} | {'sub+stretchhyp':>15s}")
        for s in (0.30, 0.50, 0.60, 0.80):
            im1, im2, fx, fy = ladder_case(s)
            cd, md, _ = measure(im1, im2, fx, fy, DEFAULT_ROTATIONS)
            cs, ms, _ = measure(im1, im2, fx, fy, DEFAULT_ROTATIONS,
                                subpatch=True)
            ch, mh, _ = measure(im1, im2, fx, fy, STRETCH_HYPOTHESES,
                                subpatch=True)
            print(f"{s:8.0%} | {cd:6.2f} {md:5.1f}   | {cs:6.2f} {ms:5.1f}"
                  f"     | {ch:6.2f} {mh:5.1f}", flush=True)
        return

    print(f"\n{'stretch':>8s} | {'default: cov  med  p90':>24s} | "
          f"{'stretch-hyp: cov  med  p90':>27s}")
    break_default = break_stretch = None
    for s in (0.10, 0.20, 0.30, 0.40, 0.50, 0.60):
        im1, im2, fx, fy = ladder_case(s)
        cov_d, med_d, p90_d = measure(im1, im2, fx, fy, DEFAULT_ROTATIONS)
        cov_s, med_s, p90_s = measure(im1, im2, fx, fy, STRETCH_HYPOTHESES)
        print(f"{s:8.0%} | {cov_d:7.2f} {med_d:5.1f} {p90_d:6.1f}     | "
              f"{cov_s:7.2f} {med_s:5.1f} {p90_s:7.1f}", flush=True)
        if break_default is None and (cov_d < 0.25 or not med_d < 3.0):
            break_default = s
        if break_stretch is None and (cov_s < 0.25 or not med_s < 3.0):
            break_stretch = s
    print(f"break point (coverage<25% or med>=3px): "
          f"default at {break_default if break_default else '>60%'}, "
          f"stretch-hypotheses at {break_stretch if break_stretch else '>60%'}")

    # ----------------------------------------------------- cat512 arm B
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    rgb1 = load_rgb(d / "cat512_iRGB.png")
    amask = load_mask(d / "cat512_iMsk.png")
    rgb2 = load_rgb(d / "cat512_wRGB.png")
    wmsk = load_mask(d / "cat512_wMsk.png")
    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")
    gmag = np.hypot(gu, gv)
    obj = amask == 0

    cfg = SolverConfig() if not fast else SolverConfig(
        num_anneal=4, gn_iters=2, max_pcg_iters=50, pcg_iters=50.0)
    deformer = ArapDeformer(cfg)
    for name, rset in (("default", DEFAULT_ROTATIONS),
                       ("stretch-hyp", STRETCH_HYPOTHESES)):
        t0 = time.time()
        matches = match_images(rgb1, rgb2, radius=100, stride=4,
                               rotations=rset)
        tm = time.time() - t0
        cons = _filter(matches, obj, wmsk > 0, max_dist=100)
        if len(cons) < 4:
            print(f"cat512 [{name}]: only {len(cons)} constraints — skip")
            continue
        x1, y1 = cons[:, 0].astype(int), cons[:, 1].astype(int)
        merr = np.hypot(cons[:, 2] - cons[:, 0] - gu[y1, x1],
                        cons[:, 3] - cons[:, 1] - gv[y1, x1])
        res = deformer.deform(rgb1, amask, cons)
        epe = np.hypot(res.flow[:, :, 0] - gu, res.flow[:, :, 1] - gv)
        print(f"cat512 [{name}]: {len(cons)} constraints "
              f"(match {tm:.1f}s), match-err med {np.median(merr):.2f}px "
              f"max {merr.max():.1f}px, coverage to "
              f"|flow|={gmag[y1, x1].max():.0f}px "
              f"(object p50 {np.percentile(gmag[obj], 50):.0f} / "
              f"max {gmag[obj].max():.0f}); through-solve EPE "
              f"mean {epe.mean():.3f}px", flush=True)


if __name__ == "__main__":
    main()

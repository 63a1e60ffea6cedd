"""Exhaustive window design for the device rasterizer, driven by the exact
winner-priority map on the golden cat512 warp: for EVERY covered pixel, where
does the true last-write-wins winner sit relative to the max-seed and to a
min-combining seed?  Evaluates candidate-set designs (union of a rectangle
around each seed) by exact miss count.

Run: JAX_PLATFORMS=cpu python scripts/raster_window_design.py
"""
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp

from arap_flow.io import flo
from arap_flow.io.image import load_rgb, load_mask
from arap_flow.native.host_raster import rasterize_warp_exact, warp_from_flow
from arap_flow.ops.rasterize import _seed_map


def fill_dilate(seed, n, combine, empty):
    """Fill-only dilation with the given combiner (numpy mirror of
    ops.rasterize._seed_map's pool)."""
    H, W = seed.shape
    s = seed.copy()
    for _ in range(n):
        nbr = s.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                sh = np.full_like(s, empty)
                ys = slice(max(dy, 0), H + min(dy, 0))
                yd = slice(max(-dy, 0), H + min(-dy, 0))
                xs = slice(max(dx, 0), W + min(dx, 0))
                xd = slice(max(-dx, 0), W + min(-dx, 0))
                sh[yd, xd] = s[ys, xs]
                nbr = combine(nbr, sh)
        s = np.where(seed_empty_mask(s, empty), nbr, s)
    return s


def seed_empty_mask(s, empty):
    return s == empty


def main():
    w = pathlib.Path("/root/reference/ARAP/warping")
    rgb = load_rgb(w / "cat512_iRGB.png")
    mask = load_mask(w / "cat512_iMsk.png")
    u, v = flo.flow_read(w / "cat512_iFlo.flo")
    flow = np.dstack([u, v]).astype(np.float32)
    H, W = mask.shape
    warp_hw2 = warp_from_flow(flow)

    _, emask, eprio = rasterize_warp_exact(warp_hw2, rgb, mask, return_prio=True)
    covered = eprio >= 0
    qidx = eprio[covered] // 2          # winning quad linear index over (W-1)
    wqy, wqx = qidx // (W - 1), qidx % (W - 1)

    warp2hw = warp_hw2.transpose(2, 0, 1)
    m = mask == 0
    m4 = np.zeros((H, W), bool)
    m4[:-1, :-1] = m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]

    # max-seed (exactly ops.rasterize._seed_map)
    smax = np.asarray(_seed_map(jnp.asarray(warp2hw), jnp.asarray(m4), 3))

    # min-seed: scatter source index with min-combining, fill-dilate
    src_idx = np.arange(H * W, dtype=np.int64).reshape(H, W)
    lx = np.clip(np.round(warp2hw[0]).astype(np.int64), 0, W - 1)
    ly = np.clip(np.round(warp2hw[1]).astype(np.int64), 0, H - 1)
    BIG = np.int64(1 << 40)
    smin = np.full(H * W, BIG, np.int64)
    vals = np.where(m4, src_idx, BIG)
    np.minimum.at(smin, (ly.ravel() * W + lx.ravel()), vals.ravel())
    smin = smin.reshape(H, W)
    smin = fill_dilate(smin, 3, np.minimum, BIG)

    ys, xs = np.nonzero(covered)
    sM = smax[covered]
    sm = smin[covered]
    okM = sM >= 0
    okm = sm < BIG
    My, Mx = np.where(okM, sM // W, -(10 ** 6)), np.where(okM, sM % W, -(10 ** 6))
    my, mx = np.where(okm, sm // W, -(10 ** 6)), np.where(okm, sm % W, -(10 ** 6))
    dyM, dxM = wqy - My, wqx - Mx
    dym, dxm = wqy - my, wqx - mx

    n = covered.sum()
    print(f"covered pixels: {n}; no max-seed: {(~okM).sum()}, "
          f"no min-seed: {(~okm).sum()}")

    def in_rect(dy, dx, y0, y1, x0, x1):
        return (dy >= y0) & (dy <= y1) & (dx >= x0) & (dx <= x1)

    # marginal histogram of max-seed offsets (for intuition)
    from collections import Counter
    cnt = Counter(zip(dyM.tolist(), dxM.tolist()))
    print("\ntop max-seed offsets:")
    for (dy, dx), c in cnt.most_common(16):
        print(f"  ({dy:3d},{dx:3d}): {c}")

    designs = [
        # (label, max-rect (y0,y1,x0,x1) or None, min-rect or None)
        ("current w3 (max dy-2..0, dx-2..0)", (-2, 0, -2, 0), None),
        ("w4 anchored (max -2..1 both)", (-2, 1, -2, 1), None),
        ("w5 anchor3 (max -3..1 both)", (-3, 1, -3, 1), None),
        ("max rect dy-2..0 dx-1..1", (-2, 0, -1, 1), None),
        ("max rect dy-3..0 dx-2..1", (-3, 0, -2, 1), None),
        ("min only dy0..2 dx0..2", None, (0, 2, 0, 2)),
        ("min only dy-1..2 dx-1..2", None, (-1, 2, -1, 2)),
        ("max w3 + min 2x2 (dy0..1 dx0..1)", (-2, 0, -2, 0), (0, 1, 0, 1)),
        ("max w3 + min 3x3 (dy-1..1 dx-1..1)", (-2, 0, -2, 0), (-1, 1, -1, 1)),
        ("max w3 + min 3x3 (dy0..2 dx0..2)", (-2, 0, -2, 0), (0, 2, 0, 2)),
        ("max dy-2..0 dx-1..1 + min dy0..2 dx0..2", (-2, 0, -1, 1), (0, 2, 0, 2)),
        ("max 2x3 dy-1..0 dx-2..0 + min dy-1..2 dx-1..2", (-1, 0, -2, 0),
         (-1, 2, -1, 2)),
    ]
    # exhaustive small-rect search: best miss count per quad budget
    print("\ngrid search (maxRect x minRect), best per quad count:")
    total_px = H * W
    best = {}
    for my0 in (-3, -2, -1):
        for my1 in (0, 1):
            for mx0 in (-2, -1):
                for mx1 in (0, 1):
                    for ny0 in (-1, 0):
                        for ny1 in (0, 1):
                            for nx0 in (-1, 0):
                                for nx1 in (0, 1):
                                    hit = in_rect(dyM, dxM, my0, my1, mx0, mx1)
                                    hit |= in_rect(dym, dxm, ny0, ny1, nx0, nx1)
                                    nq = ((my1 - my0 + 1) * (mx1 - mx0 + 1)
                                          + (ny1 - ny0 + 1) * (nx1 - nx0 + 1))
                                    miss = int((~hit).sum())
                                    if nq not in best or miss < best[nq][0]:
                                        best[nq] = (miss, (my0, my1, mx0, mx1),
                                                    (ny0, ny1, nx0, nx1))
    for nq in sorted(best):
        miss, rM, rm = best[nq]
        print(f"  quads={nq:3d} miss={miss:5d} "
              f"agree>={(1 - miss / total_px) * 100:.4f}%  max={rM} min={rm}")

    print("\ndesign evaluation (misses / covered, agreement incl. "
          "never-covered-pixel symmetry):")
    for label, rectM, rectm in designs:
        hit = np.zeros(n, bool)
        nq = 0
        if rectM is not None:
            hit |= in_rect(dyM, dxM, *rectM)
            nq += (rectM[1] - rectM[0] + 1) * (rectM[3] - rectM[2] + 1)
        if rectm is not None:
            hit |= in_rect(dym, dxm, *rectm)
            nq += (rectm[1] - rectm[0] + 1) * (rectm[3] - rectm[2] + 1)
        miss = int((~hit).sum())
        print(f"  {label:48s} quads={nq:3d} miss={miss:5d} "
              f"agree>={(1 - miss / total_px) * 100:.4f}%")


if __name__ == "__main__":
    main()

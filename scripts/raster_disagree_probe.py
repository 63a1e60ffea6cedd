"""Probe: where does the true last-write-wins winner sit relative to the seed
on the golden cat512 warp?  Informs the window/anchor needed for >=99.95%
device/exact raster agreement (round-4 item).

Run on CPU: JAX_PLATFORMS=cpu python scripts/raster_disagree_probe.py
"""
import pathlib
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


import jax.numpy as jnp

from arap_flow.io import flo
from arap_flow.io.image import load_rgb, load_mask
from arap_flow.native.host_raster import rasterize_warp_exact
from arap_flow.ops.rasterize import make_warp, rasterize_flow, _seed_map


def agreement(wmask, emask, wrgb, ergb):
    mask_agree = float(((wmask > 0) == (emask > 0)).mean())
    both = (wmask > 0) & (emask > 0)
    rgb_close = float(
        ((np.abs(wrgb.astype(int) - ergb.astype(int)).max(axis=0) <= 1) | ~both).mean()
    )
    return mask_agree, rgb_close


def main():
    w = pathlib.Path("/root/reference/ARAP/warping")
    rgb = load_rgb(w / "cat512_iRGB.png")
    mask = load_mask(w / "cat512_iMsk.png")
    u, v = flo.flow_read(w / "cat512_iFlo.flo")
    flow = np.stack([u, v]).astype(np.float32)
    H, W = mask.shape

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    warp_hw2 = np.dstack([flow[0] + xx, flow[1] + yy]).astype(np.float32)
    ergb_hw, emask = rasterize_warp_exact(warp_hw2, rgb, mask)
    ergb = ergb_hw.transpose(2, 0, 1)
    rgb = rgb.transpose(2, 0, 1).astype(np.float32)

    # new default dual-seed design
    drgb, dmask = rasterize_flow(
        jnp.asarray(flow), jnp.asarray(rgb), jnp.asarray(mask)
    )
    ma, ra = agreement(np.asarray(dmask), emask, np.asarray(drgb), ergb)
    print(f"DEFAULT dual-seed: mask {ma*100:.4f}% rgb±1 {ra*100:.4f}% "
          f"({int(((np.asarray(dmask)>0)!=(emask>0)).sum())} px differ)", flush=True)

    rows = []
    for window, anchor, dilate in (
        (3, 2, 3), (4, 2, 3), (5, 3, 3), (5, 4, 3), (7, 5, 3), (9, 6, 4),
        (3, 2, 4), (4, 3, 3), (4, 2, 4),
    ):
        drgb, dmask = rasterize_flow(
            jnp.asarray(flow), jnp.asarray(rgb), jnp.asarray(mask),
            window=window, dilate=dilate, anchor=anchor,
        )
        drgb = np.asarray(drgb)
        dmask = np.asarray(dmask)
        ma, ra = agreement(dmask, emask, drgb, ergb)
        n_dis = int(((dmask > 0) != (emask > 0)).sum())
        rows.append((window, anchor, dilate, ma, ra, n_dis))
        print(f"window={window} anchor={anchor} dilate={dilate}: "
              f"mask {ma*100:.4f}% rgb±1 {ra*100:.4f}% ({n_dis} px differ)",
              flush=True)

    # Where do the window-3 disagreements sit relative to the seed?
    warp = np.asarray(make_warp(jnp.asarray(flow)))
    m = mask == 0
    m4 = np.zeros((H, W), bool)
    m4[:-1, :-1] = m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]
    seeds = np.asarray(_seed_map(jnp.asarray(warp), jnp.asarray(m4), 3))

    # oracle winner from the big window run
    drgb3, dmask3 = rasterize_flow(
        jnp.asarray(flow), jnp.asarray(rgb), jnp.asarray(mask),
        window=3, dilate=3, anchor=2,
    )
    dmask3 = np.asarray(dmask3)
    dis = np.argwhere((dmask3 > 0) != (emask > 0))
    print(f"\nwindow-3 disagreements: {len(dis)} px; "
          f"emask=255 at {int((emask[dis[:,0],dis[:,1]]>0).sum())} of them")

    # classify: does the pixel have a seed at all? and for missed-coverage
    # pixels, how far is the nearest drawable quad whose warped bbox contains
    # the pixel?
    def lk_accept_np(p0, p1, p2, sx, sy):
        X0, Y0 = p0[0] - sx, p0[1] - sy
        X1, Y1 = p1[0] - sx, p1[1] - sy
        X2, Y2 = p2[0] - sx, p2[1] - sy
        d01 = X0 * Y1 - Y0 * X1
        d12 = X1 * Y2 - Y1 * X2
        d20 = X2 * Y0 - Y2 * X0
        if d01 < 0 and d12 < 0 and d20 < 0:
            return False
        ssum = d01 + d12 + d20
        if ssum == 0:
            return False
        return d01 / ssum >= 0 and d12 / ssum >= 0 and d20 / ssum >= 0

    cnt = Counter()
    offs = []
    for y, x in dis:
        s = seeds[y, x]
        if s < 0:
            cnt["no-seed"] += 1
            continue
        sy, sx = divmod(int(s), W)
        # search exhaustively for quads whose triangles ACCEPT this pixel
        found = None
        for oy in range(-10, 11):
            for ox in range(-10, 11):
                qy, qx = sy + oy, sx + ox
                if not (0 <= qy < H - 1 and 0 <= qx < W - 1) or not m4[qy, qx]:
                    continue
                p00 = warp[:, qy, qx]
                p01 = warp[:, qy, qx + 1]
                p10 = warp[:, qy + 1, qx]
                p11 = warp[:, qy + 1, qx + 1]
                acc = (lk_accept_np(p00, p01, p10, x, y)
                       or lk_accept_np(p10, p01, p11, x, y))
                if acc and (found is None or (qy, qx) > found):
                    found = (qy, qx)
        if found is None:
            cnt["no-accepting-quad-within-10"] += 1
        else:
            dy, dx = found[0] - sy, found[1] - sx
            cnt[f"winner at ({dy},{dx})"] += 1
            offs.append((dy, dx))
    for k, n in cnt.most_common(30):
        print(f"  {k}: {n}")
    if offs:
        offs = np.array(offs)
        print("offset ranges: dy", offs[:, 0].min(), offs[:, 0].max(),
              "dx", offs[:, 1].min(), offs[:, 1].max())


if __name__ == "__main__":
    main()

"""Matcher quality A/B: through-solve EPE from NATIVE-matcher constraints vs
ground-truth ("file") constraints, on the cat512 fixture and three synthetic
deformation cases.

This answers the DeepMatching-replacement question end-to-end (reference
contract: para_gen.py:227-240): do constraints produced by the NCC-pyramid
matcher drive the ARAP solver to the same flow as constraints from a trusted
source?

Cases:
  1. cat512      — real imagery. Arm A: the shipped 9-marker
                   cat512_iCstr.txt (the input that produced the golden
                   .flo). Arm B: native matches iRGB -> wRGB (the golden
                   warp product), segment-filtered. EPE vs cat512_iFlo.flo.
  2. rotation    — 12 deg rotation of a textured ellipse (known flow).
  3. scale       — 1.12x scale about the object center.
  4. non-rigid   — smooth sinusoidal displacement field (fixed-point
                   inverted to synthesize frame 2 exactly).
For 2-4, arm A samples the analytic flow on a stride grid (what a perfect
matcher would emit); arm B runs the native matcher. Both arms solve with the
IDENTICAL full parity schedule and are scored against the analytic flow over
the solve region.

Run on the GPU: python scripts/matcher_ab.py          (~6 solves + 2 matcher programs)
Quick CPU:  JAX_PLATFORMS=cpu python scripts/matcher_ab.py --fast
"""

import sys
import time
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


from arap_flow.io import flo
from arap_flow.io.constraints import read_constraint_file
from arap_flow.io.image import load_rgb, load_mask
from arap_flow.models.arap import ArapDeformer
from arap_flow.ops.matching import match_images
from arap_flow.ops.solver import SolverConfig


# ---------------------------------------------------------------- synthetic


def _texture(H, W, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((H // 4 + 2, W // 4 + 2))
    up = np.kron(base, np.ones((4, 4)))[:H, :W]
    g = up + rng.standard_normal((H, W)) * 0.3
    g = (g - g.min()) / (np.ptp(g) + 1e-9) * 255
    return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)


def _warp_bilinear(im, mapx, mapy):
    """im2[y, x] = im1[mapy, mapx] (inverse map, bilinear, edge clamp)."""
    H, W = im.shape[:2]
    x0 = np.clip(np.floor(mapx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(mapy).astype(int), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = np.clip(mapx - x0, 0, 1)
    fy = np.clip(mapy - y0, 0, 1)
    if im.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    out = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    return out.astype(im.dtype)


def _ellipse_mask(H, W, ry=0.30, rx=0.33):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = H / 2, W / 2
    return ((yy - cy) ** 2 / (ry * H) ** 2 + (xx - cx) ** 2 / (rx * W) ** 2) <= 1.0


def _synthetic_case(kind, H=256, W=384, seed=11):
    """Returns (rgb1, rgb2, obj_mask(bool), fwd_x, fwd_y): frame pair, object
    region, and the analytic forward map (where each source pixel lands)."""
    im1 = _texture(H, W, seed=seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = H / 2, W / 2
    if kind == "rotation":
        th = np.deg2rad(12.0)
        c, s = np.cos(th), np.sin(th)
        fwd_x = c * (xx - cx) - s * (yy - cy) + cx
        fwd_y = s * (xx - cx) + c * (yy - cy) + cy
        inv_x = c * (xx - cx) + s * (yy - cy) + cx
        inv_y = -s * (xx - cx) + c * (yy - cy) + cy
    elif kind == "scale":
        sc = 1.12
        fwd_x = cx + sc * (xx - cx)
        fwd_y = cy + sc * (yy - cy)
        inv_x = cx + (xx - cx) / sc
        inv_y = cy + (yy - cy) / sc
    elif kind == "nonrigid":
        A, kx, ky = 7.0, 2 * np.pi / W, 2 * np.pi / H

        def disp(px, py):
            dx = A * np.sin(ky * py * 2.0) * np.cos(kx * px)
            dy = A * np.cos(ky * py) * np.sin(kx * px * 2.0)
            return dx, dy

        dx, dy = disp(xx, yy)
        fwd_x, fwd_y = xx + dx, yy + dy
        # invert t(p) = p + d(p) by fixed point: p_{k+1} = q - d(p_k)
        inv_x, inv_y = xx.copy(), yy.copy()
        for _ in range(20):
            dx, dy = disp(inv_x, inv_y)
            inv_x, inv_y = xx - dx, yy - dy
    else:
        raise ValueError(kind)
    im2 = _warp_bilinear(im1, inv_x, inv_y)
    return im1, im2, _ellipse_mask(H, W), fwd_x, fwd_y


def _filter(matches, obj1, obj2, max_dist):
    """In-bounds, 0 < dist < max_dist, source on object, lands on object.
    Same predicate as io.constraints.filter_matches (para_gen.py:216-223)
    with a case-appropriate displacement bound (cat512's shipped markers
    reach 96.6 px — the pipeline's 60 px rule is a para_gen policy, not an
    arap_deform one)."""
    m = np.asarray(matches, np.float64)[:, :4].astype(np.int64) \
        if len(matches) else np.zeros((0, 4), np.int64)
    if len(m) == 0:
        return m.astype(np.int32)
    H, W = obj1.shape
    x1, y1, x2, y2 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    inb = (x1 >= 0) & (y1 >= 0) & (x2 >= 0) & (y2 >= 0) \
        & (x1 < W) & (x2 < W) & (y1 < H) & (y2 < H)
    xi1, yi1 = np.where(inb, x1, 0), np.where(inb, y1, 0)
    xi2, yi2 = np.where(inb, x2, 0), np.where(inb, y2, 0)
    d2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    keep = inb & (d2 > 0) & (d2 < max_dist ** 2) & obj1[yi1, xi1] & obj2[yi2, xi2]
    return m[keep].astype(np.int32)


def _gt_constraints(obj, fwd_x, fwd_y, stride=16):
    """Arm A for synthetic cases: the analytic flow sampled on a stride grid
    and rounded to ints (constraint files are integer tuples)."""
    H, W = obj.shape
    ys, xs = np.mgrid[stride // 2:H:stride, stride // 2:W:stride]
    ys, xs = ys.ravel(), xs.ravel()
    keep = obj[ys, xs]
    ys, xs = ys[keep], xs[keep]
    tx = np.round(fwd_x[ys, xs]).astype(np.int32)
    ty = np.round(fwd_y[ys, xs]).astype(np.int32)
    m = np.stack([xs, ys, tx, ty], 1).astype(np.int32)
    d2 = (m[:, 2] - m[:, 0]) ** 2 + (m[:, 3] - m[:, 1]) ** 2
    return m[d2 > 0]


def _epe(flow, gt_u, gt_v, region):
    e = np.hypot(flow[:, :, 0] - gt_u, flow[:, :, 1] - gt_v)
    return float(e[region].mean()), float(np.percentile(e[region], 99))


def main():
    import jax

    fast = "--fast" in sys.argv
    print("devices:", jax.devices())
    cfg = SolverConfig() if not fast else SolverConfig(
        num_anneal=4, gn_iters=2, max_pcg_iters=50, pcg_iters=50.0)
    deformer = ArapDeformer(cfg)
    rows = []

    # ------------------------------------------------------------- cat512
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    rgb1 = load_rgb(d / "cat512_iRGB.png")
    amask = load_mask(d / "cat512_iMsk.png")  # 0 = object (solve region)
    rgb2 = load_rgb(d / "cat512_wRGB.png")
    wmsk = load_mask(d / "cat512_wMsk.png")
    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")
    full = np.ones_like(amask, bool)

    cons_file = read_constraint_file(d / "cat512_iCstr.txt")
    t0 = time.time()
    res_a = deformer.deform(rgb1, amask, cons_file)
    ta = time.time() - t0
    epe_a = _epe(res_a.flow, gu, gv, full)

    t0 = time.time()
    matches = match_images(rgb1, rgb2, radius=100, stride=4)
    tm = time.time() - t0
    cons_b = _filter(matches, amask == 0, wmsk > 0, max_dist=100)
    print(f"cat512: {len(matches)} matches -> {len(cons_b)} constraints "
          f"(match {tm:.1f}s)")
    res_b = deformer.deform(rgb1, amask, cons_b)
    epe_b = _epe(res_b.flow, gu, gv, full)
    rows.append(("cat512 (vs golden .flo)", epe_a, ta, len(cons_file),
                 epe_b, len(cons_b)))

    # cat512 is REPORTED, not gated: its golden flow is an artist warp whose
    # 9 hand-picked markers drive extremes (|flow| p50 = 47 px, max 139 px,
    # local stretch ~50%) that are not photometrically recoverable from the
    # warp product — no correlation matcher sees texture that the warp
    # destroyed. Report matcher quality + coverage honestly instead.
    gmag = np.hypot(gu, gv)
    obj = amask == 0
    mb = cons_b
    if len(mb):
        x1, y1 = mb[:, 0].astype(int), mb[:, 1].astype(int)
        merr = np.hypot(mb[:, 2] - mb[:, 0] - gu[y1, x1],
                        mb[:, 3] - mb[:, 1] - gv[y1, x1])
        mg = gmag[y1, x1]
        print(f"cat512 matcher quality: med {np.median(merr):.2f}px, "
              f"max {merr.max():.1f}px vs golden; coverage caps at "
              f"|flow|={mg.max():.0f}px while the object p50 is "
              f"{np.percentile(gmag[obj], 50):.0f}px "
              f"(max {gmag[obj].max():.0f}px)")

    # ---------------------------------------------------------- synthetic
    for kind in ("rotation", "scale", "nonrigid"):
        im1, im2, obj, fwd_x, fwd_y = _synthetic_case(kind)
        H, W = obj.shape
        amask_s = np.where(obj, 0, 255).astype(np.uint8)
        gt_u = (fwd_x - np.arange(W)[None, :]).astype(np.float32)
        gt_v = (fwd_y - np.arange(H)[:, None]).astype(np.float32)

        cons_a = _gt_constraints(obj, fwd_x, fwd_y)
        res_a = deformer.deform(im1, amask_s, cons_a)
        epe_a = _epe(res_a.flow, gt_u, gt_v, obj)

        matches = match_images(im1, im2, radius=64, stride=4)
        obj2 = _warp_bilinear(obj.astype(np.float32), *_inv_maps(fwd_x, fwd_y,
                                                                 obj)) > 0.5
        cons_b = _filter(matches, obj, obj2, max_dist=64)
        print(f"{kind}: {len(matches)} matches -> {len(cons_b)} constraints")
        if len(cons_b) < 10:
            rows.append((kind, epe_a, 0.0, len(cons_a), (np.inf, np.inf), 0))
            continue
        res_b = deformer.deform(im1, amask_s, cons_b)
        epe_b = _epe(res_b.flow, gt_u, gt_v, obj)
        rows.append((kind, epe_a, 0.0, len(cons_a), epe_b, len(cons_b)))

    print()
    print(f"{'case':26s} {'EPE file/GT (mean,p99)':24s} {'EPE native':24s} "
          f"{'ratio':>6s} {'nA':>5s} {'nB':>6s}")
    ok = True
    for name, ea, ta, na, eb, nb in rows:
        ratio = eb[0] / max(ea[0], 1e-9)
        # pass bar (controlled synthetic cases): through-solve EPE within 2x
        # of the GT-constraint arm OR within 0.5 px absolute (an EPE floor:
        # arm-A constraints are themselves int-rounded, so 2x of a tiny
        # number is not a meaningful matcher bar). cat512 is reported only —
        # see the coverage analysis printed above.
        gated = not name.startswith("cat512")
        good = eb[0] <= 2.0 * ea[0] or eb[0] < 0.5
        if gated:
            ok &= good
        status = ("PASS" if good else "FAIL") if gated else "report"
        print(f"{name:26s} {ea[0]:7.4f} / {ea[1]:7.3f}       "
              f"{eb[0]:7.4f} / {eb[1]:7.3f}       {ratio:6.2f} {na:5d} {nb:6d}"
              f"  {status}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def _inv_maps(fwd_x, fwd_y, obj):
    """Inverse maps by fixed point (for warping the object mask to frame 2)."""
    H, W = obj.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx, dy = fwd_x - xx, fwd_y - yy
    inv_x, inv_y = xx.copy(), yy.copy()
    for _ in range(20):
        ix = np.clip(inv_x, 0, W - 1).astype(int)
        iy = np.clip(inv_y, 0, H - 1).astype(int)
        inv_x = xx - dx[iy, ix]
        inv_y = yy - dy[iy, ix]
    return inv_x, inv_y


if __name__ == "__main__":
    raise SystemExit(main())

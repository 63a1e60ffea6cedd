"""End-to-end pipeline benchmark on a synthetic DAVIS-like tree.

Builds N frame pairs at 854×480 with two textured moving objects — object 1
rigid, object 2 NON-RIGID (rigid translation + an interior sinusoidal
deformation with analytic flow, synth_nonrigid.py; the reference's operating
regime is deforming objects, para_gen.py:216-223) — then runs the full
para_gen pipeline (native matcher → constraint filter → ARAP solves →
rasterization → composition → .flo/PNG writes) and reports pairs/sec for both
execution modes. check_flow_accuracy gates seg 1 by median translation and
seg 2 by per-pixel EPE against the analytic non-rigid flow.

    python scripts/pipeline_bench.py [n_pairs]
"""

import os
import os.path as osp
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from arap_flow.io.image import load_mask, save_image
from synth_nonrigid import (bounce as _bounce, draw_nonrigid, make_textures,
                            nr_check_epe)

# object 2's ellipse semi-axes and non-rigid amplitude: peak interior
# deformation ~0.55*amp ≈ 3.3 px per frame pair (|Δphase| = 1.0)
NR_RY, NR_RX, NR_AMP = 60, 90, 6.0


def object_positions(t):
    """Top-left anchors of the two bench objects at frame t (textures ride
    the anchors, so per-pair object motion = positions(t+1) - positions(t))."""
    return (
        (_bounce(t, 6, 90, 270), _bounce(t, 9, 120, 540)),
        (_bounce(t + 60, 4, 120, 330), _bounce(t + 43, 7, 180, 660)),
    )


def make_dataset(root, n_frames, H=480, W=854, seed=0):
    """DAVIS-style tree of PNG frames and masks (orgRGB/seq0, orgMasks/seq0)
    with the two bench objects, generated from `seed`."""
    tex, bg = make_textures(H, W, seed)
    os.makedirs(osp.join(root, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        (y0, x0), (y1, x1) = object_positions(t)
        ob1 = ((yy - y0 - 90) / 90.0) ** 2 + ((xx - x0 - 140) / 140.0) ** 2 < 1
        img[ob1] = tex[(yy[ob1] - y0) % H, (xx[ob1] - x0) % W]
        mask[ob1] = 1
        draw_nonrigid(img, mask, tex, 2, y1 + NR_RY, x1 + NR_RX,
                      NR_RY, NR_RX, NR_AMP, t)
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def main():
    import jax

    from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    print("devices:", jax.devices())
    root = "/tmp/arap_pipe_bench"
    shutil.rmtree(root, ignore_errors=True)
    make_dataset(osp.join(root, "data"), n_pairs + 1)

    # each mode runs twice: first pass pays (or cache-hits) the compiles,
    # second pass is the warm steady-state number. ds2 = the half-resolution
    # matcher (--match_downscale 2): ~4x cheaper matching, accuracy still
    # gated by check_flow_accuracy below.
    cases = (("simple", "cold", 1), ("simple", "warm", 1),
             ("simple-ds2", "cold", 2), ("simple-ds2", "warm", 2),
             ("batched-ds2", "cold", 2), ("batched-ds2", "warm", 2),
             ("batched", "cold", 1), ("batched", "warm", 1))
    # ARAP_BENCH_CASES=batched,simple runs only the named mode families
    only = os.environ.get("ARAP_BENCH_CASES")
    if only:
        keep = {s.strip() for s in only.split(",")}
        cases = tuple(c for c in cases if c[0] in keep)
    for name, run, ds in cases:
        mode = name.split("-")[0]
        out = osp.join(root, f"out_{name}_{run}")
        flags = PipelineFlags(
            input=osp.join(root, "data"), output=out, fd=1, multseg=True,
            seed=0, mode=mode, match_downscale=ds,
            narap=int(os.environ.get("ARAP_BENCH_NARAP", "2")),
        )
        t0 = time.time()
        triples = main_pipeline(flags)
        t = time.time() - t0
        print(
            f"mode={name} ({run}): {len(triples)} pairs in {t:.1f}s "
            f"-> {len(triples) / t:.3f} pairs/s end-to-end",
            flush=True,
        )
        # non-rigid threshold: 0.8 px at full-res matching; the ds2 mode's
        # documented contract is coarser matches for ~4x cheaper matching —
        # its measured non-rigid cost is 0.45 -> 0.84 px median interior EPE
        # (round 5), gated at 1.2 so a further regression still fails
        check_flow_accuracy(out, osp.join(root, "data"),
                            nr_thresh=0.8 if ds == 1 else 1.2)


def check_flow_accuracy(out_dir, data_dir, nr_thresh=0.8):
    """Correctness gate on the bench products, pair (0, 1): seg 1 translates
    rigidly (median flow must match its displacement within 1 px); seg 2 is
    NON-RIGID (translation + analytic sinusoidal interior deformation) and is
    gated by median per-pixel EPE < `nr_thresh` px against the analytic flow
    (0.8 for full-res matching; 1.2 for --match_downscale 2, whose measured
    non-rigid cost is 0.45 -> 0.84 px) — a matcher/filter/solver regression
    that only hurts non-rigid recovery now fails this gate. Segment ids come
    from the ORIGINAL annotation mask (the pipeline's saved inpMasks are
    binary ARAP masks)."""
    import numpy as np

    from arap_flow.io import flo as flo_io

    flo_path = osp.join(out_dir, "Flow", "seq0", "00000.flo")
    msk_path = osp.join(data_dir, "orgMasks", "seq0", "00000.png")
    if not (osp.exists(flo_path) and osp.exists(msk_path)):
        print("  flow check: products missing, skipped")
        return
    u, v = flo_io.flow_read(flo_path)
    mask = load_mask(msk_path)
    p0, p1 = object_positions(0), object_positions(1)
    ok = True
    # seg 1: rigid median check
    du, dv = float(p1[0][1] - p0[0][1]), float(p1[0][0] - p0[0][0])
    sel = mask == 1
    if sel.sum() >= 100:
        mu, mv = float(np.median(u[sel])), float(np.median(v[sel]))
        good = abs(mu - du) < 1.0 and abs(mv - dv) < 1.0
        ok &= good
        print(f"  flow check seg1: median ({mu:+.2f}, {mv:+.2f}) "
              f"expected ({du:+.0f}, {dv:+.0f}) "
              f"{'OK' if good else 'MISMATCH'}")
    # seg 2: non-rigid EPE-vs-analytic check
    c0 = (p0[1][0] + NR_RY, p0[1][1] + NR_RX)
    c1 = (p1[1][0] + NR_RY, p1[1][1] + NR_RX)
    good, msg = nr_check_epe(u, v, mask, 2, c0, c1, NR_RY, NR_RX, NR_AMP, 0,
                             thresh=nr_thresh, label="seg2")
    ok &= good
    print(msg)
    if not ok:
        raise SystemExit("pipeline flow accuracy check FAILED")


if __name__ == "__main__":
    main()

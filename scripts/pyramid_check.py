"""Validate + time the coarse-to-fine pyramid solve on the cat512 golden
fixture vs the flat full-resolution schedule.

    python scripts/pyramid_check.py
"""

import sys
import time
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from arap_flow.io import flo
from arap_flow.io.constraints import add_border_pins, read_constraint_file
from arap_flow.io.image import load_mask
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S
from arap_flow.ops.pyramid import solve_pyramid


def main():
    import jax

    print("devices:", jax.devices())
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    mask = load_mask(d / "cat512_iMsk.png")
    cons = read_constraint_file(d / "cat512_iCstr.txt")
    H, W = mask.shape
    cons = add_border_pins(cons, W, H)
    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")

    def epe_of(f):
        return np.sqrt((f[0] - gu) ** 2 + (f[1] - gv) ** 2)

    # flat reference schedule
    ops = E.build_operands(mask, cons)
    cfg = S.SolverConfig()
    x, flow = S.solve(ops, cfg)
    f = np.asarray(flow)
    ts = []
    for _ in range(2):
        t0 = time.time()
        x, flow = S.solve(ops, cfg)
        f = np.asarray(flow)
        ts.append(time.time() - t0)
    e = epe_of(f)
    print(f"flat 19x8x400:      t={min(ts):.3f}s EPE mean={e.mean():.4f} "
          f"p99={np.percentile(e, 99):.3f}")

    for fine_anneal in (1, 2, 4):
        x, flow = solve_pyramid(mask, cons, cfg, fine_anneal=fine_anneal)
        f = np.asarray(flow)
        ts = []
        for _ in range(2):
            t0 = time.time()
            x, flow = solve_pyramid(mask, cons, cfg, fine_anneal=fine_anneal)
            f = np.asarray(flow)
            ts.append(time.time() - t0)
        e = epe_of(f)
        print(f"pyramid fine={fine_anneal}:     t={min(ts):.3f}s "
              f"EPE mean={e.mean():.4f} p99={np.percentile(e, 99):.3f}",
              flush=True)


if __name__ == "__main__":
    main()

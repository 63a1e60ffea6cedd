"""Solver schedule sweep on the cat512 golden fixture: time / PCG-iteration
count / EPE-vs-reference for a grid of budgets and tolerances.

The PCG budget and tolerances are traced, so all points with the same
(num_anneal, gn_iters, max_pcg) share one compiled executable.

    python scripts/sweep_schedule.py
"""

import sys
import time
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from arap_flow.io import flo
from arap_flow.io.constraints import add_border_pins, read_constraint_file
from arap_flow.io.image import load_mask, load_rgb
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S


def main():
    import jax

    print("devices:", jax.devices())
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    mask = load_mask(d / "cat512_iMsk.png")
    cons = read_constraint_file(d / "cat512_iCstr.txt")
    H, W = mask.shape
    cons = add_border_pins(cons, W, H)
    ops = E.build_operands(mask, cons)
    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")

    def run(cfg, tag):
        # timed to the D2H fetch (np.asarray) of the flow
        t0 = time.time()
        x, flow, iters = S.solve_stats(ops, cfg)
        f = np.asarray(flow)
        t_first = time.time() - t0
        ts = []
        for _ in range(3):
            t0 = time.time()
            x, flow, iters = S.solve_stats(ops, cfg)
            f = np.asarray(flow)
            ts.append(time.time() - t0)
        t = min(ts)
        epe = np.sqrt((f[0] - gu) ** 2 + (f[1] - gv) ** 2)
        print(
            f"{tag:34s} t={t:6.3f}s (first {t_first:6.1f}s) "
            f"pcg_total={float(iters):7.0f} "
            f"EPE mean={epe.mean():.4f} p99={np.percentile(epe,99):.3f} "
            f"max={epe.max():.2f}",
            flush=True,
        )

    # all these share ONE executable:
    base = dict(num_anneal=19, gn_iters=8, max_pcg_iters=400)
    run(S.SolverConfig(**base), "parity 19x8x400")
    for n in (200, 100, 50, 25):
        run(S.SolverConfig(**base, pcg_iters=float(n)), f"fixed pcg={n}")
    for rz in (1e-1, 3e-2, 1e-2, 1e-3):
        run(S.SolverConfig(**base, rz_tolerance=rz), f"rz_tol={rz}")
    run(S.SolverConfig(**base, q_tolerance=1e-4), "q_tol=1e-4")
    run(
        S.SolverConfig(**base, pcg_iters=100.0, rz_tolerance=1e-2),
        "pcg<=100 + rz 1e-2",
    )
    # cheaper structure points (recompile each):
    run(S.SolverConfig(num_anneal=19, gn_iters=4, max_pcg_iters=400,
                       rz_tolerance=1e-2), "gn=4 rz 1e-2")
    run(S.SolverConfig(num_anneal=10, gn_iters=8, max_pcg_iters=400,
                       rz_tolerance=1e-2), "anneal=10 rz 1e-2")


if __name__ == "__main__":
    main()

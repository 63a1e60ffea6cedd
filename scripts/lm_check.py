"""Validate the LM (trust-region) solver variant on the cat512 golden fixture.

The reference's optional LMGPU solver (CombinedSolverBase.h:74-81) is expected
to land near the GN solution on this well-conditioned problem.

    python scripts/lm_check.py
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
from arap_flow.ops.lm import LMConfig, lm_solve


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

    cfg = LMConfig()  # 19 anneal × ≤8 LM outer × ≤400 PCG, ζ=1e-4
    t0 = time.time()
    x, flow = lm_solve(ops, cfg)
    f = np.asarray(flow)
    print(f"first (compile+run): {time.time() - t0:.1f}s")
    t0 = time.time()
    x, flow = lm_solve(ops, cfg)
    f = np.asarray(flow)
    print(f"run: {time.time() - t0:.2f}s")
    epe = np.sqrt((f[0] - gu) ** 2 + (f[1] - gv) ** 2)
    print(f"LM EPE vs golden .flo: mean {epe.mean():.4f} "
          f"p99 {np.percentile(epe, 99):.3f} max {epe.max():.2f}")
    # regression bound, NOT golden parity: the golden .flo is a truncated-GN
    # product and LM's trust-region trajectory legitimately differs
    # (documented 1.52 px, docs/PARITY.md); 2.0 px catches LM breakage
    ok = epe.mean() < 2.0
    print("PASS" if ok else "FAIL (LM regression bound 2.0 px)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""f64 golden record: the full cat512 parity schedule in double precision
(the _opt_double_precision switch, /root/reference/ARAP/API/src/precision.t:1-6,
Opt.h:10-30 — the reference provides f64 exactly to validate that f32
truncation is immaterial). Runs on any backend, e.g. the CPU:

    JAX_PLATFORMS=cpu python scripts/golden_f64.py
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from arap_flow.io import flo
from arap_flow.io.constraints import add_border_pins, read_constraint_file
from arap_flow.io.image import load_mask
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S


def main():
    import jax

    print("devices:", jax.devices(), flush=True)
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    mask = load_mask(d / "cat512_iMsk.png")
    cons = read_constraint_file(d / "cat512_iCstr.txt")
    H, W = mask.shape
    cons = add_border_pins(cons, W, H)
    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")
    cfg = S.SolverConfig()  # full 19 x 8 x 400 parity schedule

    with jax.enable_x64():
        ops = E.build_operands(mask, cons, dtype=np.float64)
        t0 = time.time()
        x, flow = S.solve(ops, cfg)
        f = np.asarray(flow)
        print(f"f64 solve: {time.time() - t0:.1f}s", flush=True)
    epe = np.sqrt((f[0] - gu) ** 2 + (f[1] - gv) ** 2)
    print(f"f64 EPE vs golden .flo: mean {epe.mean():.4f}px  "
          f"p99 {np.percentile(epe, 99):.4f}px  max {epe.max():.4f}px")
    ok = epe.mean() < 0.1
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    # exit code must reflect the gate (golden_cat512.py pattern) — automation
    # checking return codes must not record a printed FAIL as success
    raise SystemExit(main())

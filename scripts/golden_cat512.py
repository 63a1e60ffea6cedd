"""Golden end-to-end validation: run the full reference schedule on the cat512
deformation fixture and compare against the shipped outputs.

Run on the GPU:    python scripts/golden_cat512.py
Run on CPU:    JAX_PLATFORMS=cpu python scripts/golden_cat512.py  (slow)

Expected parity: EPE < 0.1 px vs ARAP/warping/cat512_iFlo.flo (the reference
solver's output for these inputs), warped mask/RGB agreement vs cat512_w*.
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
from arap_flow.ops.solver import SolverConfig


def main():
    import jax

    print("devices:", jax.devices())
    d = pathlib.Path("/root/reference/ARAP/deformation")
    w = pathlib.Path("/root/reference/ARAP/warping")
    rgb = load_rgb(d / "cat512_iRGB.png")
    mask = load_mask(d / "cat512_iMsk.png")
    cons = read_constraint_file(d / "cat512_iCstr.txt")

    cfg_name = sys.argv[1] if len(sys.argv) > 1 else "parity"
    if cfg_name == "parity":
        cfg = SolverConfig()  # 19 × 8 × 400, no early exit
    else:
        cfg = SolverConfig(num_anneal=19, gn_iters=8, pcg_iters=400,
                           q_tolerance=1e-4)
    print("config:", cfg)

    deformer = ArapDeformer(cfg)
    t0 = time.time()
    res = deformer.deform(rgb, mask, cons)
    t_first = time.time() - t0
    print(f"first call (compile+run): {t_first:.1f}s")

    t0 = time.time()
    res = deformer.deform(rgb, mask, cons)
    t_run = time.time() - t0
    print(f"second call (run): {t_run:.2f}s")

    gu, gv = flo.flow_read(w / "cat512_iFlo.flo")
    epe = np.sqrt(
        (res.flow[:, :, 0] - gu) ** 2 + (res.flow[:, :, 1] - gv) ** 2
    )
    print(f"EPE vs golden .flo: mean {epe.mean():.4f}px  p99 "
          f"{np.percentile(epe, 99):.4f}px  max {epe.max():.4f}px")

    gmask = load_mask(d / "cat512_wMsk.png")
    magree = ((res.warped_mask > 0) == (gmask > 0)).mean()
    grgb = load_rgb(d / "cat512_wRGB.png")
    cov = gmask > 0
    rdiff = np.abs(res.warped_rgb.astype(int) - grgb.astype(int)).max(-1)
    print(f"warped mask agreement: {magree:.5f}")
    print(f"warped RGB within ±2 on covered: {(rdiff[cov] <= 2).mean():.5f}")

    ok = epe.mean() < 0.1 and magree > 0.99
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

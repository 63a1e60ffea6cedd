"""Demo: deform the cat512 golden fixture end-to-end and report EPE.

    python examples/demo_cat512.py [--out DIR]

Loads the reference-shipped inputs (RGB, mask, 9 constraint markers), runs the
full ARAP schedule on the GPU (or CPU), writes flow + warped outputs, and—if
the golden .flo is present—prints the end-point error against it.
"""

import argparse
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from arap_flow.io import flo
from arap_flow.io.constraints import read_constraint_file
from arap_flow.io.image import load_mask, load_rgb, save_image
from arap_flow.models.arap import ArapDeformer
from arap_flow.ops.solver import SolverConfig

FIXTURES = "/root/reference/ARAP/deformation"
GOLDEN_FLO = "/root/reference/ARAP/warping/cat512_iFlo.flo"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/arap_demo")
    ap.add_argument("--fixtures", default=FIXTURES)
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)

    rgb = load_rgb(osp.join(a.fixtures, "cat512_iRGB.png"))
    mask = load_mask(osp.join(a.fixtures, "cat512_iMsk.png"))
    cons = read_constraint_file(osp.join(a.fixtures, "cat512_iCstr.txt"))
    print(f"{mask.shape} frame, {len(cons)} constraints")

    res = ArapDeformer(SolverConfig()).deform(rgb, mask, cons)
    flo.flow_write(osp.join(a.out, "cat512.flo"), res.flow)
    save_image(osp.join(a.out, "cat512_wRGB.png"), res.warped_rgb)
    save_image(osp.join(a.out, "cat512_wMsk.png"), res.warped_mask)
    print("wrote", a.out)

    if osp.exists(GOLDEN_FLO):
        gu, gv = flo.flow_read(GOLDEN_FLO)
        epe = np.sqrt((res.flow[..., 0] - gu) ** 2 + (res.flow[..., 1] - gv) ** 2)
        print(f"EPE vs reference solver output: mean {epe.mean():.4f} px")


if __name__ == "__main__":
    main()

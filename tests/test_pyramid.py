"""Coarse-to-fine pyramid solve: smoke + recovers simple motion (experimental
mode; accuracy tradeoffs documented in ops/pyramid.py)."""

import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops.pyramid import coarsen_problem, solve_pyramid
from arap_flow.ops.solver import SolverConfig
from arap_flow.ops.energy import ArapWeights


def test_pyramid_recovers_translation():
    H, W = 32, 40
    mask = np.zeros((H, W), np.uint8)
    ys, xs = np.mgrid[4:H-4:4, 4:W-4:4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 4, ys.ravel() + 2], 1)
    cons = add_border_pins(cons.astype(np.int32), W, H)
    cfg = SolverConfig(num_anneal=4, gn_iters=2, max_pcg_iters=80,
                       pcg_iters=80.0)
    x, flow = solve_pyramid(mask, cons, cfg, fine_anneal=2)
    f = np.asarray(flow)
    inner = (slice(8, H - 8), slice(8, W - 8))
    assert abs(np.median(f[0][inner]) - 4.0) < 0.5
    assert abs(np.median(f[1][inner]) - 2.0) < 0.5


def test_coarsen_problem():
    mask = np.full((20, 30), 255, np.uint8)
    mask[4:16, 6:24] = 0
    cons = np.array([[10, 8, 12, 9]], np.int32)
    ops_c, (H2, W2) = coarsen_problem(mask, cons, ArapWeights())
    assert (H2, W2) == (10, 15)
    assert np.asarray(ops_c.mask).sum() > 0
    assert float(ops_c.fitmask[4, 5]) == 1.0  # (10,8)//2 = (5,4)


def test_cli_dispatcher(capsys):
    from arap_flow.__main__ import main

    assert main([]) == 1
    assert main(["--help"]) == 0

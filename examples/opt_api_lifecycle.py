"""Demo: drive the Opt C-API facade exactly like the reference solver harness.

    python examples/opt_api_lifecycle.py [--solver gaussNewtonGPU|LMGPU]

This is executable migration documentation (docs/MIGRATION.md): the loop below
is the reference's `CombinedSolverBase::singleSolve` + `OptSolver::solve`
(CombinedSolverBase.h:99-120, OptSolver.h:72-91) written against
`arap_flow.compat` — define a problem, plan it for the image dims, bind
the seven ARAP parameter slots in declaration order (arap_plan.t:2-8), anneal
the constraint image across outer iterations (CombinedSolver.h:199-242), and
step the solver, reading the cost back per step. The unknown buffers (Offset,
Angle) are mutated in place, as the Opt API does.

Runs in a few seconds on CPU: `JAX_PLATFORMS=cpu python ...`
"""

import argparse
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from arap_flow import compat as opt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="gaussNewtonGPU",
                    choices=["gaussNewtonGPU", "LMGPU"],
                    help="the two kinds CombinedSolverBase registers "
                    "(CombinedSolverBase.h:74-81)")
    ap.add_argument("--num_iter", type=int, default=6,
                    help="outer (annealing) iterations; reference uses 19")
    ap.add_argument("--nonlinear_iter", type=int, default=2)
    ap.add_argument("--linear_iter", type=int, default=60)
    a = ap.parse_args()

    H, W = 40, 56

    # --- problem data: a square object pulled 6 px right at its center ----
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1).copy()   # unknown slot 0 (warped pos)
    angle = np.zeros((H, W), np.float32)     # unknown slot 1 (local rotation)
    urshape = offset.copy()                  # slot 2 (rest positions)
    mask = np.zeros((H, W), np.float32)      # slot 4 (0 = solve)

    # constraint image, slot 3: (-1,-1) = unconstrained (arap_plan.t:21-23)
    target = np.full((H, W, 2), -1.0, np.float32)
    src = np.array([W // 2, H // 2], np.float32)
    dst = src + (6.0, 0.0)
    # border pinned to identity, as arap_deform does (main.cpp:95-101)
    for x in range(W):
        target[0, x] = (x, 0)
        target[H - 1, x] = (x, H - 1)
    for y in range(H):
        target[y, 0] = (0, y)
        target[y, W - 1] = (W - 1, y)

    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", a.solver)
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", a.nonlinear_iter)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", a.linear_iter)

    # w_fitSqrt/w_regSqrt, slots 5-6 (CombinedSolver.h:173-174 squares them)
    w_fit_sqrt, w_reg_sqrt = np.float32(10.0), np.float32(np.sqrt(0.01))

    for i in range(a.num_iter):
        # preNonlinearSolve: anneal the constraint toward the target
        # (CombinedSolver.h:199-201, 223-242 — alpha = (i+1)/numIter)
        alpha = (i + 1) / a.num_iter
        cons = target.copy()
        cy, cx = int(src[1]), int(src[0])
        cons[cy, cx] = src + alpha * (dst - src)

        params = [offset, angle, urshape, cons, mask, w_fit_sqrt, w_reg_sqrt]
        # manual Init/Step loop (what Opt_ProblemSolve runs internally —
        # OptUtils.h:47-64 profiled solves use exactly this form); each step
        # mutates the bound offset/angle buffers in place
        opt.Opt_ProblemInit(state, plan, params)
        steps = 0
        while opt.Opt_ProblemStep(state, plan, params):
            steps += 1
        cost = opt.Opt_ProblemCurrentCost(state, plan)
        print(f"outer {i + 1}/{a.num_iter}: alpha={alpha:.2f} "
              f"steps={steps + 1} cost={cost:.5f}")

    moved = offset[cy, cx] - src
    print(f"center pixel displacement: ({moved[0]:+.2f}, {moved[1]:+.2f}) px "
          f"(target +6.00, +0.00)")
    flow_mag = np.hypot(offset[..., 0] - gx, offset[..., 1] - gy)
    print(f"dense |flow|: max {flow_mag.max():.2f} px, "
          f"mean {flow_mag.mean():.3f} px")
    opt.Opt_PlanFree(state, plan)
    opt.Opt_ProblemDelete(state, prob)
    assert abs(moved[0] - 6.0) < 1.0, "constraint not reached"
    print("ok")


if __name__ == "__main__":
    main()

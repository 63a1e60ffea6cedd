"""Opt C-API compatibility facade.

The reference exposes its solver behind a 10-function C API
(ARAP/API/release/include/Opt.h:35-71), consumed by OptSolver.h:43-91:
NewState → ProblemDefine → ProblemPlan → [SetSolverParameter] →
ProblemSolve | (ProblemInit; ProblemStep*; ProblemCurrentCost) → PlanFree →
ProblemDelete. Problem parameters arrive as an order-significant list
(NamedParameters.h:34-47): for the ARAP plan, slots 0-6 are Offset, Angle,
UrShape, Constraints, Mask, w_fitSqrt, w_regSqrt (arap_plan.t:2-8).

This module reproduces that lifecycle over the JAX solver so code written
against the Opt API maps 1:1. The "plan file" argument selects the built-in
ARAP energy (there is no kernel generator to run — XLA is the JIT); numpy
arrays stand in for device pointers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import numpy as np

from ..ops import energy as E
from ..ops import solver as S


@jax.jit
def _lm_init_impl(x, ops, cimg):
    """ssq = diag(JtJ) capture + initial cost, as ONE compiled program
    (eager jnp ops each compile separately; lm_step recomputes neither)."""
    _, ssq = E.jtf_and_diag(x, ops, cimg)
    return ssq, E.cost(x, ops, cimg)


@partial(jax.jit, static_argnames=("static_key",))
def _gn_step_impl(x, ops, cimg, dyn, static_key):
    """One GN iteration + cost as one compiled program (the Opt_ProblemStep
    granularity for 'gaussNewtonGPU'). Static/dynamic SolverConfig split —
    lIterations sweeps stay in one executable."""
    import jax.numpy as jnp

    cfg = S._rebuild_config(dyn, static_key)
    x, _ = S.gn_step(x, ops, cimg, cfg, jnp.float32(cfg.pcg_iters),
                     jnp.float32(0.0), jnp.float32(0.0))
    return x, E.cost(x, ops, cimg)


@dataclass
class OptState:
    problems: dict = field(default_factory=dict)
    plans: dict = field(default_factory=dict)
    next_id: int = 1


@dataclass
class _Problem:
    name: str


@dataclass
class _Plan:
    problem: _Problem
    dims: tuple
    params: dict = field(default_factory=dict)
    solver_params: dict = field(
        # defaults: solverGPUGaussNewton.t:26-39
        default_factory=lambda: {"nIterations": 10, "lIterations": 10}
    )
    state: np.ndarray | None = None
    ops: E.ArapOperands | None = None
    n_iter_done: int = 0
    cost: float = float("nan")
    # LMGPU per-solve state: (ssq, radius, decrease_factor, prev_cost).
    # ssq is captured once per solve (PCGSaveSSq at nIter == 0,
    # solverGPUGaussNewton.t:1043-1045); the trust region persists across
    # ProblemStep calls, matching the step() loop in OptSolver.h:72-91.
    lm_state: tuple | None = None


def Opt_NewState(verbosity: int = 0) -> OptState:
    """Opt.h: create the library state (no embedded Lua/Terra needed here)."""
    return OptState()


def Opt_ProblemDefine(state: OptState, plan_path: str, solver_kind: str) -> _Problem:
    """Opt.h: register a problem. `plan_path` names the energy; only the
    built-in ARAP plan is available (the framework compiles energies with XLA,
    not a DSL). solver_kind: 'gaussNewtonGPU' | 'LMGPU' per
    CombinedSolverBase.h:74-81."""
    if solver_kind not in ("gaussNewtonGPU", "LMGPU"):
        raise ValueError(f"unknown solver kind {solver_kind}")
    p = _Problem(name=solver_kind)
    state.problems[id(p)] = p
    return p


def Opt_ProblemPlan(state: OptState, problem: _Problem, dims) -> _Plan:
    """Opt.h: 'compile' the plan for given dims (W, H). XLA compilation itself
    happens lazily at the first solve, cached per shape."""
    plan = _Plan(problem=problem, dims=tuple(int(d) for d in dims))
    state.plans[id(plan)] = plan
    return plan


def Opt_SetSolverParameter(state: OptState, plan: _Plan, name: str, value) -> None:
    plan.solver_params[name] = (
        float(np.asarray(value).ravel()[0])
        if np.asarray(value).size
        else value
    )


def _bind(plan: _Plan, problem_params: list) -> None:
    """Order-significant parameter binding (NamedParameters ordering for the
    ARAP plan, arap_plan.t:2-8)."""
    offset, angle, urshape, constraints, mask, w_fit_sqrt, w_reg_sqrt = (
        problem_params
    )
    W, H = plan.dims
    mask = np.asarray(mask, np.float32).reshape(H, W)
    cons_img = np.asarray(constraints, np.float32).reshape(H, W, 2)

    weights = E.ArapWeights(
        w_fit=float(np.asarray(w_fit_sqrt) ** 2),
        w_reg=float(np.asarray(w_reg_sqrt) ** 2),
    )
    # build operands directly from the bound images (constraint image already
    # annealed by the caller, CombinedSolver.h:223-242)
    import jax.numpy as jnp

    arap_mask = (mask != 0).astype(np.uint8) * 255
    ops = E.build_operands(np.asarray(arap_mask), np.zeros((0, 4), np.int32),
                           weights)
    fit = ((cons_img[:, :, 0] >= 0) & (cons_img[:, :, 1] >= 0)).astype(
        np.float32
    ) * np.asarray(ops.mask)
    ops = ops._replace(
        con_src=jnp.asarray(cons_img.transpose(2, 0, 1)),
        con_tgt=jnp.asarray(cons_img.transpose(2, 0, 1)),
        fitmask=jnp.asarray(fit),
    )
    plan.ops = ops
    x = np.zeros((3, H, W), np.float32)
    x[:2] = np.asarray(offset, np.float32).reshape(H, W, 2).transpose(2, 0, 1)
    x[2] = np.asarray(angle, np.float32).reshape(H, W)
    plan.state = x


def Opt_ProblemInit(state: OptState, plan: _Plan, problem_params: list) -> None:
    _bind(plan, problem_params)
    plan.n_iter_done = 0
    plan.lm_state = None


def _writeback(plan: _Plan, problem_params: list) -> None:
    """Mutate the caller's bound Offset/Angle buffers in place — in the
    reference the unknowns ARE the bound device images, updated by every
    step (PCGLinearUpdate, solverGPUGaussNewton.t:1115)."""
    offset, angle = problem_params[0], problem_params[1]
    W, H = plan.dims
    views = []
    for name, buf, shape in (("Offset", offset, (H, W, 2)),
                             ("Angle", angle, (H, W))):
        arr = np.asarray(buf)
        # np.asarray must have given us the caller's memory (the ndarray
        # itself, or a view over a buffer-protocol object) — a silent copy
        # (e.g. a Python list or a jax array was bound) would make every
        # step a no-op from the caller's point of view. Non-contiguous but
        # writable bindings (F-order, strided views) are fine as long as
        # the reshape below aliases the caller's buffer rather than copying.
        bad = (arr is not buf and arr.base is None) or not arr.flags.writeable
        view = None
        if not bad:
            view = arr.reshape(shape)
            bad = not np.shares_memory(view, arr)  # reshape made a copy
        if bad:
            raise TypeError(
                f"{name} binding must be a writable numpy buffer (got "
                f"{type(buf).__name__}): the Opt API updates the bound "
                "unknowns in place every step (PCGLinearUpdate, "
                "solverGPUGaussNewton.t:1115) — bind numpy arrays for "
                "slots 0-1"
            )
        views.append(view)
    views[0][...] = plan.state[:2].transpose(1, 2, 0)
    views[1][...] = plan.state[2]


def Opt_ProblemStep(state: OptState, plan: _Plan, problem_params: list) -> int:
    """One nonlinear iteration; returns nonzero while iterations remain
    (Opt.h / o.t:2548-2551 loop contract). Routes on the solver kind the
    problem was defined with: 'gaussNewtonGPU' runs one GN iteration,
    'LMGPU' one trust-region LM iteration (CombinedSolverBase.h:74-81
    registers both behind the identical C-API lifecycle)."""
    import jax.numpy as jnp

    if plan.state is None:
        _bind(plan, problem_params)
    n = int(plan.solver_params.get("nIterations", 10))
    if plan.n_iter_done >= n:
        return 0
    l_iters = float(plan.solver_params.get("lIterations", 10))
    x = jnp.asarray(plan.state)
    cimg = plan.ops.con_tgt
    # static-cap / traced-budget split (solver.py SolverConfig contract):
    # the compiled programs key on a FIXED cap (400 = the reference app's
    # lIterations, main.cpp:215-221; bumped only for larger requests), while
    # the actual lIterations budget is a traced float — SetSolverParameter
    # sweeps of lIterations reuse one executable instead of recompiling.
    cap = 400 if l_iters <= 400 else int(np.ceil(l_iters))
    if plan.problem.name == "LMGPU":
        from ..ops import lm as L

        cfg = L.LMConfig(pcg_iters=cap)
        if plan.lm_state is None:
            ssq, c0 = _lm_init_impl(x, plan.ops, cimg)
            plan.lm_state = (ssq, jnp.float32(cfg.init_radius),
                             jnp.float32(2.0), c0)
        ssq, radius, dec, prev_cost = plan.lm_state
        x, radius, dec, cst, done = L.lm_step(
            x, plan.ops, cimg, ssq, radius, dec, prev_cost, cfg,
            pcg_budget=jnp.float32(max(l_iters, 1.0)),
        )
        plan.state = np.asarray(x)
        plan.cost = float(cst)
        plan.lm_state = (ssq, radius, dec, cst)
        plan.n_iter_done += 1
        _writeback(plan, problem_params)
        if bool(done):  # function_tolerance / min-radius termination
            plan.n_iter_done = n
            return 0
    else:
        # raw l_iters as the traced budget: lIterations=0 is a no-op PCG
        # (zero inner iterations, x unchanged) exactly as the original GN
        # facade behaved; the LM path clamps to 1 because its trust-region
        # update needs a step to evaluate
        cfg = S.SolverConfig(
            num_anneal=1, gn_iters=1, max_pcg_iters=cap,
            pcg_iters=l_iters,
        )
        x, cst = _gn_step_impl(x, plan.ops, cimg, cfg.dynamic, cfg.static_key)
        plan.state = np.asarray(x)
        plan.cost = float(cst)
        plan.n_iter_done += 1
        _writeback(plan, problem_params)
    return 1 if plan.n_iter_done < n else 0


def Opt_ProblemSolve(state: OptState, plan: _Plan, problem_params: list) -> None:
    """Init + step until done (OptSolver.h:72-91 uses exactly this loop);
    every step writes the unknowns back into the caller's buffers."""
    Opt_ProblemInit(state, plan, problem_params)
    while Opt_ProblemStep(state, plan, problem_params):
        pass


def Opt_ProblemCurrentCost(state: OptState, plan: _Plan) -> float:
    return plan.cost


def Opt_PlanFree(state: OptState, plan: _Plan) -> None:
    state.plans.pop(id(plan), None)


def Opt_ProblemDelete(state: OptState, problem: _Problem) -> None:
    state.problems.pop(id(problem), None)

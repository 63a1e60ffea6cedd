"""Tests for the generic autodiff GN solver, the LM variant, and the Opt C-API
compatibility facade."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import generic as G
from arap_flow.ops import solver as S
from arap_flow.ops.lm import LMConfig, lm_solve


def _problem(H=14, W=18, seed=0):
    arap_mask = np.zeros((H, W), np.uint8)
    rng = np.random.default_rng(seed)
    cons = np.array([[4, 5, 6, 7], [11, 4, 12, 6]], np.int32)
    # seed actually varies the problem (targets jitter by up to ±1 px);
    # seed=0 keeps the historical fixed problem
    if seed:
        cons = cons.copy()
        cons[:, 2:] += rng.integers(-1, 2, cons[:, 2:].shape)
    cons = add_border_pins(cons, W, H)
    ops = E.build_operands(arap_mask, cons)
    cimg = E.anneal_constraints(ops, 1.0)
    return ops, cimg


def test_generic_matches_specialized_arap():
    """The autodiff-generic GN must reproduce the hand-derived ARAP solver."""
    ops, cimg = _problem()
    rfun = lambda x: E.residuals(x, ops, cimg)
    diag_fn = lambda x: E.jtf_and_diag(x, ops, cimg)[1]
    x0 = E.init_state(ops)

    xg = jax.jit(
        lambda x: G.gn_solve(rfun, x, gn_iters=3, pcg_iters=80, diag_fn=diag_fn)
    )(x0)

    cfg = S.SolverConfig(num_anneal=1, gn_iters=3, max_pcg_iters=80,
                         pcg_iters=80.0)
    # run the specialised path manually for identical structure
    x = x0
    for _ in range(3):
        x, _ = S.gn_step(x, ops, cimg, cfg, 80.0, 0.0, 0.0)
    np.testing.assert_allclose(np.asarray(xg), np.asarray(x), atol=1e-4)


def test_generic_cost_jtf_jtjp():
    ops, cimg = _problem(seed=1)
    rng = np.random.default_rng(2)
    rfun = lambda x: E.residuals(x, ops, cimg)
    x = E.init_state(ops) + 0.2 * jnp.asarray(
        rng.standard_normal((3, *ops.mask.shape)), jnp.float32
    )
    np.testing.assert_allclose(
        float(G.cost(rfun, x)), float(E.cost(x, ops, cimg)), rtol=1e-6
    )
    g = G.jtf(rfun, x)
    g2, _ = E.jtf_and_diag(x, ops, cimg)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g2), atol=2e-5)
    p = jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    s, c = E.trig(x)
    np.testing.assert_allclose(
        np.asarray(G.make_jtj_apply(rfun, x)(p)),
        np.asarray(E.apply_jtj(p, ops, s, c)),
        atol=3e-5,
    )


def test_lm_converges_like_gn():
    """On a well-behaved problem LM must reach (approximately) the GN solution."""
    ops, cimg = _problem()
    cfg_gn = S.SolverConfig(num_anneal=4, gn_iters=4, max_pcg_iters=150,
                            pcg_iters=150.0)
    x_gn, flow_gn = S.solve(ops, cfg_gn)
    cfg_lm = LMConfig(num_anneal=4, max_outer=6, pcg_iters=150)
    x_lm, flow_lm = lm_solve(ops, cfg_lm)
    c_gn = float(E.cost(x_gn, ops, cimg))
    c_lm = float(E.cost(x_lm, ops, cimg))
    assert c_lm <= c_gn * 1.5 + 1e-3, (c_lm, c_gn)
    # flows agree to sub-pixel on the constrained region
    d = np.abs(np.asarray(flow_gn) - np.asarray(flow_lm))
    assert d.mean() < 0.15, d.mean()


def _opt_lifecycle_params(H, W):
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1).copy()
    angle = np.zeros((H, W), np.float32)
    urshape = offset.copy()
    constraints = np.full((H, W, 2), -1.0, np.float32)
    constraints[5, 7] = (9.0, 6.0)  # pull pixel (7,5) to (9,6)
    for x in range(W):
        constraints[0, x] = (x, 0)
        constraints[H - 1, x] = (x, H - 1)
    for y in range(H):
        constraints[y, 0] = (0, y)
        constraints[y, W - 1] = (W - 1, y)
    mask = np.zeros((H, W), np.float32)
    return [offset, angle, urshape, constraints, mask,
            np.float32(10.0), np.float32(0.1)]


def _run_lifecycle(solver_kind, H=12, W=16, n_iter=4, l_iter=60):
    """Drive the Opt.h step loop with the given solver kind; returns
    (offset, angle, per-step cost list)."""
    from arap_flow import compat as opt

    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", solver_kind)
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", n_iter)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", l_iter)
    params = _opt_lifecycle_params(H, W)
    opt.Opt_ProblemInit(state, plan, params)
    costs = []
    while True:
        more = opt.Opt_ProblemStep(state, plan, params)
        costs.append(opt.Opt_ProblemCurrentCost(state, plan))
        if not more:
            break
    result = np.asarray(plan.state)
    # Opt semantics: the unknowns ARE the bound buffers — every ProblemStep
    # must have written offset/angle back in place (PCGLinearUpdate mutates
    # the bound device images, solverGPUGaussNewton.t:1115), so the manual
    # Init/Step loop needs no extra ProblemSolve to read results
    np.testing.assert_array_equal(
        params[0], result[:2].transpose(1, 2, 0))
    np.testing.assert_array_equal(params[1], result[2])
    opt.Opt_PlanFree(state, plan)
    opt.Opt_ProblemDelete(state, prob)
    return result, costs


def test_opt_api_lm_routes_to_lm_solver():
    """'LMGPU' through the facade must run the trust-region solver, not GN:
    the step-cost trajectories differ, and the LM lifecycle reproduces
    ops.lm._lm_inner exactly on the same problem
    (CombinedSolverBase.h:74-81 / OptSolver.h:72-91 semantics)."""
    from arap_flow.ops.lm import _lm_inner

    H, W, n_iter, l_iter = 12, 16, 4, 60
    x_gn, costs_gn = _run_lifecycle("gaussNewtonGPU", H, W, n_iter, l_iter)
    x_lm, costs_lm = _run_lifecycle("LMGPU", H, W, n_iter, l_iter)
    # different solvers → different trajectories (LM damps the first steps)
    assert not np.allclose(costs_gn[: len(costs_lm)], costs_lm), (
        costs_gn, costs_lm)
    assert all(np.isfinite(c) for c in costs_lm)

    # the facade's LM must match lm._lm_inner on identical operands
    params = _opt_lifecycle_params(H, W)
    cons_img = params[3]
    arap_mask = np.zeros((H, W), np.uint8)
    ops = E.build_operands(arap_mask, np.zeros((0, 4), np.int32),
                           E.ArapWeights(w_fit=100.0, w_reg=0.01))
    fit = ((cons_img[:, :, 0] >= 0) & (cons_img[:, :, 1] >= 0)).astype(
        np.float32) * np.asarray(ops.mask)
    ops = ops._replace(
        con_src=jnp.asarray(cons_img.transpose(2, 0, 1)),
        con_tgt=jnp.asarray(cons_img.transpose(2, 0, 1)),
        fitmask=jnp.asarray(fit),
    )
    x0 = jnp.asarray(np.concatenate(
        [params[0].transpose(2, 0, 1), params[1][None]], 0))
    x_ref = _lm_inner(x0, ops, ops.con_tgt,
                      LMConfig(max_outer=n_iter, pcg_iters=l_iter))
    np.testing.assert_allclose(x_lm, np.asarray(x_ref), atol=1e-5)


def test_opt_api_liter_sweep_no_recompile():
    """Opt_SetSolverParameter('lIterations', v) sweeps must NOT mint a new
    executable per value: the facade keys its programs on a fixed 400 cap
    (the reference app's lIterations, main.cpp:215-221) and passes the
    actual budget as a traced float — 40-230 s/compile on the production
    platform makes a recompile-per-value facade unusable."""
    from arap_flow.compat.opt_api import _gn_step_impl
    from arap_flow.ops.lm import lm_step

    _run_lifecycle("gaussNewtonGPU", l_iter=50)
    _run_lifecycle("LMGPU", l_iter=50)
    gn_progs = _gn_step_impl._cache_size()
    lm_progs = lm_step._cache_size()
    x70, c70 = _run_lifecycle("gaussNewtonGPU", l_iter=70)
    _run_lifecycle("LMGPU", l_iter=70)
    assert _gn_step_impl._cache_size() == gn_progs, "GN recompiled on lIterations change"
    assert lm_step._cache_size() == lm_progs, "LM recompiled on lIterations change"
    # and the budget is actually honored: a deeper PCG changes the result
    x4, c4 = _run_lifecycle("gaussNewtonGPU", l_iter=4)
    assert not np.allclose(x70, x4), "lIterations budget had no effect"


def test_opt_api_writeback_rejects_unwritable_bindings():
    """Binding slot 0/1 as anything numpy cannot write through (list, jax
    array) must raise at the first step instead of silently dropping the
    in-place unknown update the Opt API contract promises."""
    import pytest

    from arap_flow import compat as opt

    H, W = 8, 10
    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", "gaussNewtonGPU")
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 1)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 5)
    params = _opt_lifecycle_params(H, W)
    params[0] = params[0].tolist()  # a list binding cannot be written back
    with pytest.raises(TypeError, match="Offset.*writable"):
        opt.Opt_ProblemSolve(state, plan, params)


def test_opt_api_writeback_accepts_noncontiguous_view():
    """A writable but NON-contiguous binding (a strided row-slice view of a
    larger buffer) must be written back through, not rejected: the guard is
    'does the reshape alias the caller's memory', not C-contiguity."""
    from arap_flow import compat as opt

    H, W = 8, 10
    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", "gaussNewtonGPU")
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 1)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 5)
    params = _opt_lifecycle_params(H, W)
    base = np.zeros((2 * H, W, 2), np.float32)
    view = base[::2]  # non-contiguous, writable, shares memory with base
    assert not view.flags.c_contiguous
    view[...] = params[0]
    params[0] = view
    opt.Opt_ProblemSolve(state, plan, params)
    # the solve wrote through the strided view into the caller's base buffer
    np.testing.assert_array_equal(base[::2],
                                  np.asarray(plan.state)[:2].transpose(1, 2, 0))
    assert not np.allclose(base[::2], 0.0)


def test_opt_api_gn_zero_literations_is_noop():
    """lIterations=0 on the GN path runs zero PCG iterations: the unknowns
    come back unchanged (the original facade contract; LM clamps to 1 by
    design because its trust-region update needs a trial step)."""
    from arap_flow import compat as opt

    H, W = 8, 10
    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", "gaussNewtonGPU")
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 2)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 0)
    params = _opt_lifecycle_params(H, W)
    before = params[0].copy(), params[1].copy()
    opt.Opt_ProblemSolve(state, plan, params)
    np.testing.assert_array_equal(params[0], before[0])
    np.testing.assert_array_equal(params[1], before[1])


def test_opt_api_lifecycle():
    """Full Opt.h lifecycle drives a solve and writes the unknowns back."""
    from arap_flow import compat as opt

    H, W = 12, 16
    state = opt.Opt_NewState()
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", "gaussNewtonGPU")
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 4)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 80)

    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1).copy()
    angle = np.zeros((H, W), np.float32)
    urshape = offset.copy()
    constraints = np.full((H, W, 2), -1.0, np.float32)
    constraints[5, 7] = (9.0, 6.0)  # pull pixel (7,5) to (9,6)
    # pin the border to itself
    for x in range(W):
        constraints[0, x] = (x, 0)
        constraints[H - 1, x] = (x, H - 1)
    for y in range(H):
        constraints[y, 0] = (0, y)
        constraints[y, W - 1] = (W - 1, y)
    mask = np.zeros((H, W), np.float32)
    params = [offset, angle, urshape, constraints, mask,
              np.float32(10.0), np.float32(0.1)]

    opt.Opt_ProblemSolve(state, plan, params)
    cost = opt.Opt_ProblemCurrentCost(state, plan)
    assert np.isfinite(cost)
    # the constrained pixel moved toward its target
    moved = offset[5, 7] - np.array([7.0, 5.0])
    assert moved[0] > 1.0 and moved[1] > 0.4, offset[5, 7]
    opt.Opt_PlanFree(state, plan)
    opt.Opt_ProblemDelete(state, prob)

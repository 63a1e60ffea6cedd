"""LM (trust-region) solver parity internals: residual-drift reset, CtC
Jacobi scaling/clamping, and the CERES accept/reject trajectory
(solverGPUGaussNewton.t LM paths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import lm as L
from arap_flow.ops import solver as S


def _problem(H=24, W=32, seed=0, spread=4):
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[3 : H - 3, 4 : W - 4] = 0
    ys, xs = np.mgrid[5 : H - 5 : 5, 6 : W - 6 : 7]
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-spread, spread + 1, xs.size),
         ys.ravel() + rng.integers(-spread, spread + 1, xs.size)], 1
    ).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    return E.build_operands(arap_mask, cons)


def test_finalize_diagonal_clamp_and_inert():
    ops = _problem()
    cimg = E.anneal_constraints(ops, 1.0)
    x = E.init_state(ops)
    _, diag = E.jtf_and_diag(x, ops, cimg)
    cfg = L.LMConfig()
    radius = jnp.float32(1e4)
    ctc, pre = L._finalize_diagonal(diag, diag, radius, cfg)
    d = np.asarray(diag)
    c = np.asarray(ctc)
    p = np.asarray(pre)
    active = d > 0
    # inactive (excluded) unknowns are exactly inert
    assert (c[~active] == 0).all() and (p[~active] == 0).all()
    # unclamped case (ssq == diag → bounds are [1e-6, 1e32]·(1/diag)/radius):
    # diag/radius sits inside for well-scaled problems
    np.testing.assert_allclose(c[active], d[active] / float(radius), rtol=1e-6)
    # preconditioner = 1/(CtC + diag)
    np.testing.assert_allclose(
        p[active], 1.0 / (c[active] + d[active]), rtol=1e-6
    )
    # clamping engages for a tiny radius (CtC = diag/radius would exceed
    # max_lm_diagonal·invS²/radius)
    tiny = jnp.float32(1e-40)
    ctc2, _ = L._finalize_diagonal(diag, diag, tiny, cfg)
    c2 = np.asarray(ctc2)
    maxval = cfg.max_lm_diagonal * (1.0 / d[active]) / float(tiny)
    assert (c2[active] <= maxval * (1 + 1e-5)).all()


def test_residual_reset_bounds_drift():
    """The reset recomputes r = b − Aδ from scratch; with exact arithmetic the
    trajectory is identical, so delta with/without reset must agree closely,
    and the reset run's true residual must not be worse."""
    ops = _problem(seed=3)
    cimg = E.anneal_constraints(ops, 1.0)
    x = E.init_state(ops)
    s, c = E.trig(x)
    g, diag = E.jtf_and_diag(x, ops, cimg)
    cfg = L.LMConfig(pcg_iters=120, q_tolerance=0.0)
    ctc, pre = L._finalize_diagonal(diag, diag, jnp.float32(1e4), cfg)

    d_reset = L._pcg_damped(ops, s, c, g, ctc, pre, cfg)
    cfg_none = cfg._replace(residual_reset_period=10 ** 9)
    d_none = L._pcg_damped(ops, s, c, g, ctc, pre, cfg_none)
    assert np.abs(np.asarray(d_reset) - np.asarray(d_none)).max() < 1e-3

    def true_res(delta):
        return float(jnp.linalg.norm(
            -g - L._damped_apply(delta, ops, s, c, ctc)
        ))

    assert true_res(d_reset) <= true_res(d_none) * 1.5


def test_lm_cost_monotone_and_matches_gn():
    """Within each anneal step the accepted LM cost is monotone
    non-increasing, and the final LM flow lands near GN's (same energy)."""
    ops = _problem(H=32, W=48, seed=1, spread=3)
    cfg = L.LMConfig(num_anneal=4, max_outer=5, pcg_iters=150)
    x, flow, costs = L.lm_solve_instrumented(ops, cfg)
    costs = np.asarray(costs).reshape(cfg.num_anneal, cfg.max_outer)
    for a in range(cfg.num_anneal):
        steps = costs[a]
        assert (np.diff(steps) <= 1e-4 * np.abs(steps[:-1]) + 1e-6).all(), (
            a, steps,
        )

    gn_cfg = S.SolverConfig(
        num_anneal=4, gn_iters=5, max_pcg_iters=150, pcg_iters=150.0,
    )
    _, gn_flow = S.solve(ops, gn_cfg)
    d = np.abs(np.asarray(flow) - np.asarray(gn_flow))
    assert np.median(d) < 0.05 and d.max() < 1.0

    cimg = E.anneal_constraints(ops, 1.0)
    lm_cost = float(E.cost(x, ops, cimg))
    gn_cost = float(E.cost(S.solve(ops, gn_cfg)[0], ops, cimg))
    assert lm_cost <= gn_cost * 1.05 + 1e-6


def test_lm_solve_finite_and_converged():
    ops = _problem(seed=7)
    cfg = L.LMConfig(num_anneal=3, max_outer=4, pcg_iters=100)
    x, flow = L.lm_solve(ops, cfg)
    assert bool(jnp.isfinite(x).all()) and bool(jnp.isfinite(flow).all())
    # constraints approximately satisfied at alpha=1 on a smooth problem
    cimg = E.anneal_constraints(ops, 1.0)
    assert float(E.cost(x, ops, cimg)) < float(
        E.cost(E.init_state(ops), ops, cimg)
    )

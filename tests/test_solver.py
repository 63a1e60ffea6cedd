"""Solver correctness tests: PCG vs direct dense solve, energy descent, and
closed-form deformation recoveries (translation / rotation)."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S


def _tiny_problem(H=9, W=11, seed=0):
    rng = np.random.default_rng(seed)
    arap_mask = np.zeros((H, W), np.uint8)
    arap_mask[0, :] = 255  # some excluded pixels
    cons = np.array([[3, 4, 5, 5], [7, 2, 6, 3]], np.int32)
    cons = add_border_pins(cons, W, H)
    ops = E.build_operands(arap_mask, cons)
    x = E.init_state(ops)
    x = x + 0.3 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    cimg = E.anneal_constraints(ops, 1.0)
    return ops, x, cimg


def test_pcg_matches_direct_solve():
    """With enough iterations PCG must reproduce the exact Newton step
    (JtJ δ = −JtF solved densely via the autodiff Jacobian)."""
    ops, x, cimg = _tiny_problem()
    s, c = E.trig(x)
    jtf, diag = E.jtf_and_diag(x, ops, cimg)
    delta, _ = S.pcg_solve(ops, s, c, jtf, diag, 600)

    rfun = lambda xx: E.residuals(xx, ops, cimg).ravel()
    J = np.asarray(jax.jacfwd(rfun)(x).reshape(-1, x.size), np.float64)
    A = J.T @ J
    g = np.asarray(jtf, np.float64).ravel()
    # excluded/unconstrained-free rows: A is singular on inert pixels (all-zero
    # rows); restrict to active coordinates
    active = np.abs(A).sum(1) > 0
    d_exact = np.zeros_like(g)
    d_exact[active] = np.linalg.solve(A[np.ix_(active, active)], -g[active])
    np.testing.assert_allclose(
        np.asarray(delta, np.float64).ravel()[active], d_exact[active],
        rtol=2e-3, atol=2e-3,
    )


def test_gn_descends_energy():
    ops, x, cimg = _tiny_problem(seed=2)
    cfg = S.SolverConfig(num_anneal=1, gn_iters=1, pcg_iters=150)
    costs = [float(E.cost(x, ops, cimg))]
    for _ in range(5):
        x, _ = S.gn_step(x, ops, cimg, cfg, cfg.pcg_iters, 0.0, 0.0)
        costs.append(float(E.cost(x, ops, cimg)))
    assert costs[-1] < costs[0] * 1e-2, costs
    assert all(b <= a * 1.01 for a, b in zip(costs, costs[1:])), costs


def test_recovers_translation():
    """All constraints translated by (2, 3): the zero-energy solution is a rigid
    translation; flow must be ≈ (2, 3) on the whole solve region, angle ≈ 0."""
    H, W = 24, 32
    arap_mask = np.zeros((H, W), np.uint8)
    ys, xs = np.mgrid[2:H-2:4, 2:W-2:4]
    cons = np.stack(
        [xs.ravel(), ys.ravel(), xs.ravel() + 2, ys.ravel() + 3], axis=1
    ).astype(np.int32)
    ops = E.build_operands(arap_mask, cons)
    cfg = S.SolverConfig(num_anneal=6, gn_iters=4, pcg_iters=200)
    x, flow = S.solve(ops, cfg)
    np.testing.assert_allclose(np.asarray(flow[0]), 2.0, atol=1e-2)
    np.testing.assert_allclose(np.asarray(flow[1]), 3.0, atol=1e-2)
    np.testing.assert_allclose(np.asarray(x[2]), 0.0, atol=1e-2)


def test_recovers_rotation():
    """Constraints rotated by θ about the grid centre: ARAP admits the exact
    rigid rotation (angle = θ everywhere, zero energy)."""
    H, W = 24, 24
    theta = 0.15
    arap_mask = np.zeros((H, W), np.uint8)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys, xs = np.mgrid[3:H-3:3, 3:W-3:3]
    xr = np.cos(theta) * (xs - cx) - np.sin(theta) * (ys - cy) + cx
    yr = np.sin(theta) * (xs - cx) + np.cos(theta) * (ys - cy) + cy
    cons = np.stack(
        [xs.ravel(), ys.ravel(), np.round(xr).ravel(), np.round(yr).ravel()],
        axis=1,
    ).astype(np.int32)
    ops = E.build_operands(arap_mask, cons)
    cfg = S.SolverConfig(num_anneal=8, gn_iters=4, pcg_iters=250)
    x, flow = S.solve(ops, cfg)
    # rounded integer targets put a sub-pixel floor on accuracy
    assert abs(float(jnp.mean(x[2])) - theta) < 0.02
    exp_u = xr - xs
    # compare at constraint sites
    got_u = np.asarray(flow[0])[ys, xs]
    assert np.abs(got_u - exp_u).mean() < 0.5


def test_qexit_matches_full_pcg_closely():
    ops, x, cimg = _tiny_problem(seed=3)
    s, c = E.trig(x)
    jtf, diag = E.jtf_and_diag(x, ops, cimg)
    d_full, _ = S.pcg_solve(ops, s, c, jtf, diag, 500)
    d_fast, n_fast = S.pcg_solve(ops, s, c, jtf, diag, 500, q_tolerance=1e-6)
    # the ζ test stops once the quadratic model stops improving; in f32 that
    # leaves ~1% of the step unresolved (polished by later GN iterations)
    err = float(jnp.max(jnp.abs(d_full - d_fast)))
    assert err < 0.05 * float(jnp.max(jnp.abs(d_full))), err


def test_batch_matches_single():
    ops1, _, _ = _tiny_problem(seed=4)
    ops2, _, _ = _tiny_problem(seed=5)
    batched = jax.tree.map(lambda a, b: jnp.stack([a, b]), ops1, ops2)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=50)
    xs, flows = S.solve_batch(batched, cfg)
    x1, f1 = S.solve(ops1, cfg)
    np.testing.assert_allclose(np.asarray(xs[0]), np.asarray(x1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(flows[0]), np.asarray(f1), atol=1e-5)

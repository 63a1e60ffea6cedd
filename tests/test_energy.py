"""Validate the hand-derived ARAP stencil operators against jax autodiff oracles.

The reference generates these operators by symbolic autodiff (o.t:2425-2460);
here the closed forms in ops/energy.py must agree with jax.grad / jvp / vjp of
the plain residual function to float32 precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arap_flow.ops import energy as E
from arap_flow.io.constraints import add_border_pins


def _problem(H=13, W=17, seed=0, with_constraints=True):
    rng = np.random.default_rng(seed)
    # irregular mask: a blob of solve pixels (mask==0) on excluded background
    arap_mask = np.full((H, W), 255, np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((yy - H / 2) ** 2 / (H / 3) ** 2 + (xx - W / 2) ** 2 / (W / 3) ** 2) < 1.0
    arap_mask[blob] = 0
    # a few random constraints inside the blob + border pins
    cons = []
    if with_constraints:
        ys, xs = np.where(arap_mask == 0)
        for k in rng.choice(len(ys), size=4, replace=False):
            cons.append(
                [xs[k], ys[k], xs[k] + rng.integers(-3, 4), ys[k] + rng.integers(-3, 4)]
            )
    cons = add_border_pins(np.array(cons, np.int32).reshape(-1, 4), W, H)
    ops = E.build_operands(arap_mask, cons)
    x = E.init_state(ops)
    # perturb the state so derivatives are generic
    x = x + 0.5 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    cimg = E.anneal_constraints(ops, 0.7)
    return ops, x, cimg


def test_jtf_matches_grad():
    ops, x, cimg = _problem()
    jtf, _ = E.jtf_and_diag(x, ops, cimg)
    grad = jax.grad(lambda xx: E.cost(xx, ops, cimg))(x)
    np.testing.assert_allclose(np.asarray(jtf), np.asarray(grad), rtol=2e-5, atol=2e-5)


def test_apply_jtj_matches_vjp_jvp():
    ops, x, cimg = _problem(seed=1)
    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    s, c = E.trig(x)
    ours = E.apply_jtj(p, ops, s, c)

    rfun = lambda xx: E.residuals(xx, ops, cimg)
    _, jp = jax.jvp(rfun, (x,), (p,))
    _, vjp = jax.vjp(rfun, x)
    (oracle,) = vjp(jp)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(oracle), rtol=3e-5, atol=3e-5)


def test_diag_matches_explicit_jacobian():
    ops, x, cimg = _problem(H=8, W=9, seed=2)
    _, diag = E.jtf_and_diag(x, ops, cimg)
    rfun = lambda xx: E.residuals(xx, ops, cimg).ravel()
    J = jax.jacfwd(rfun)(x).reshape(-1, x.size)
    oracle = (J * J).sum(0).reshape(x.shape)
    np.testing.assert_allclose(np.asarray(diag), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_excluded_pixels_inert():
    """Excluded pixels (mask != 0) must have zero gradient and zero JtJ coupling
    (Exclude(...), arap_plan.t:11; solverGPUGaussNewton.t:371-396)."""
    ops, x, cimg = _problem(seed=4)
    excluded = np.asarray(ops.mask) == 0
    jtf, _ = E.jtf_and_diag(x, ops, cimg)
    assert np.abs(np.asarray(jtf)[:, excluded]).max() == 0
    # a perturbation supported only on excluded pixels produces zero JtJ·p
    p = jnp.asarray(excluded[None] * np.ones_like(x), jnp.float32)
    s, c = E.trig(x)
    out = E.apply_jtj(p, ops, s, c)
    assert np.abs(np.asarray(out)).max() == 0


def test_cost_zero_at_rest_without_constraints():
    """With x = rest state and no active constraints, every residual is zero."""
    H, W = 10, 12
    arap_mask = np.zeros((H, W), np.uint8)  # everything solve region
    ops = E.build_operands(arap_mask, np.zeros((0, 4), np.int32))
    x = E.init_state(ops)
    cimg = E.anneal_constraints(ops, 1.0)
    assert float(E.cost(x, ops, cimg)) == 0.0


def test_fit_term_value():
    """Single constraint on a fully-solvable grid: cost = ½ wf² |o−c|² at rest."""
    H, W = 6, 7
    arap_mask = np.zeros((H, W), np.uint8)
    cons = np.array([[3, 2, 5, 4]], np.int32)
    ops = E.build_operands(arap_mask, cons)
    x = E.init_state(ops)
    cimg = E.anneal_constraints(ops, 1.0)
    # o = (3,2), c = (5,4): ½·100·(4+4) = 400
    np.testing.assert_allclose(float(E.cost(x, ops, cimg)), 400.0, rtol=1e-6)


def test_compact_operands_match_full():
    """expand_operands(build_compact(...)) reproduces build_operands(...) on
    every solver-relevant plane, and the solve is bitwise identical."""
    import jax

    from arap_flow.ops import solver as S

    H, W = 24, 40
    rng = np.random.default_rng(3)
    mask = np.full((H, W), 255, np.uint8)
    mask[4:-4, 6:-6] = 0
    cons = np.array(
        [
            [8, 8, 11, 9],
            [20, 10, 18, 12],
            [8, 8, 12, 10],   # duplicate source: later wins
            [30, 12, -3, 5],  # negative target (crop-shift artifact)
            [2, 2, 5, 5],     # source on an excluded pixel
        ],
        np.int32,
    )
    full = E.build_operands(mask, cons)
    comp = jax.jit(E.expand_operands)(E.build_compact(mask, cons))

    for name in ("mask", "vmasks", "degree", "fitmask", "grid", "wf2", "wr2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(comp, name)), np.asarray(getattr(full, name)),
            err_msg=name,
        )
    # constraint planes must agree wherever the fit term reads them
    act = np.asarray(full.fitmask) == 1.0
    for name in ("con_src", "con_tgt"):
        a = np.asarray(getattr(comp, name))
        b = np.asarray(getattr(full, name))
        np.testing.assert_array_equal(a[:, act], b[:, act], err_msg=name)

    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=30,
                         pcg_iters=30.0)
    _, flow_full = S.solve(full, cfg)
    _, flow_comp = S.solve(jax.jit(E.expand_operands)(
        E.build_compact(mask, cons)), cfg)
    np.testing.assert_array_equal(np.asarray(flow_comp), np.asarray(flow_full))

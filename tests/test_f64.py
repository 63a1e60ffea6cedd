"""Double-precision switch (precision.t / _opt_double_precision parity,
Opt.h:10-30): build_operands(dtype=float64) + the dtype-following solver."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S


def _mask_cons(H=24, W=32, seed=0):
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[3 : H - 3, 4 : W - 4] = 0
    ys, xs = np.mgrid[5 : H - 5 : 5, 6 : W - 6 : 7]
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-3, 4, xs.size),
         ys.ravel() + rng.integers(-3, 4, xs.size)], 1
    ).astype(np.int32)
    return arap_mask, add_border_pins(cons, W, H)


def test_f64_operands_and_solve_match_f32():
    mask, cons = _mask_cons()
    cfg = S.SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                         pcg_iters=60.0)
    ops32 = E.build_operands(mask, cons)
    x32, flow32 = S.solve(ops32, cfg)
    assert x32.dtype == jnp.float32

    with jax.enable_x64():
        ops64 = E.build_operands(mask, cons, dtype=np.float64)
        assert ops64.grid.dtype == jnp.float64
        x64, flow64 = S.solve(ops64, cfg)
        assert x64.dtype == jnp.float64 and flow64.dtype == jnp.float64
        cimg64 = E.anneal_constraints(ops64, 1.0)
        c64 = float(E.cost(x64, ops64, cimg64))

    # same truncated trajectory in both precisions, up to f32 rounding
    # accumulated over the CG recurrence (measured ~7e-3 max on this problem —
    # well under the 0.1px parity budget)
    d = np.abs(np.asarray(flow64, np.float64) - np.asarray(flow32, np.float64))
    assert d.max() < 0.05 and np.median(d) < 1e-3

    cimg32 = E.anneal_constraints(ops32, 1.0)
    c32 = float(E.cost(x32, ops32, cimg32))
    assert abs(c64 - c32) <= 1e-3 * max(abs(c64), 1.0)


def test_f64_energy_operators_consistent():
    """JtF/diag/JtJ·p keep their algebraic identities in f64."""
    mask, cons = _mask_cons(seed=2)
    with jax.enable_x64():
        ops = E.build_operands(mask, cons, dtype=np.float64)
        cimg = E.anneal_constraints(ops, 1.0)
        rng = np.random.default_rng(3)
        x = E.init_state(ops) + 0.2 * jnp.asarray(
            rng.standard_normal((3, *ops.mask.shape))
        )
        assert x.dtype == jnp.float64
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, ops, cimg)
        assert jtf.dtype == jnp.float64

        # gradient check vs jax AD of the cost
        g = jax.grad(lambda xx: E.cost(xx, ops, cimg))(x)
        np.testing.assert_allclose(np.asarray(jtf), np.asarray(g),
                                   rtol=1e-9, atol=1e-9)

        # JtJ·p symmetric positive semi-definite sample check
        p = jnp.asarray(rng.standard_normal((3, *ops.mask.shape)))
        q = jnp.asarray(rng.standard_normal((3, *ops.mask.shape)))
        ap = E.apply_jtj(p, ops, s, c)
        aq = E.apply_jtj(q, ops, s, c)
        assert ap.dtype == jnp.float64
        np.testing.assert_allclose(
            float(jnp.sum(q * ap)), float(jnp.sum(p * aq)), rtol=1e-10
        )
        assert float(jnp.sum(p * ap)) >= -1e-9

"""sparse_jacobian (dumpJ analogue, o.t:2318-2344) as an independent oracle
for the hand-derived stencil operators."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E


def _problem(H=12, W=16, seed=0):
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 3 : W - 3] = 0
    cons = np.array([[5, 4, 7, 5], [10, 6, 11, 8]], np.int32)
    cons = add_border_pins(cons, W, H)
    ops = E.build_operands(arap_mask, cons)
    cimg = E.anneal_constraints(ops, 1.0)
    x = E.init_state(ops) + 0.3 * jnp.asarray(
        rng.standard_normal((3, H, W)), jnp.float32
    )
    return ops, cimg, x


def _dense_j(ops, cimg, x):
    H, W = x.shape[-2:]
    rows, cols, vals = E.sparse_jacobian(x, ops, cimg)
    J = np.zeros((10 * H * W, 3 * H * W), np.float64)
    np.add.at(J, (rows, cols), vals)
    return J


def test_jp_matches_jvp():
    ops, cimg, x = _problem()
    J = _dense_j(ops, cimg, x)
    rng = np.random.default_rng(1)
    p = rng.standard_normal(x.shape).astype(np.float32)
    _, jvp_out = jax.jvp(
        lambda xx: E.residuals(xx, ops, cimg), (x,), (jnp.asarray(p),)
    )
    np.testing.assert_allclose(
        J @ p.ravel(), np.asarray(jvp_out).ravel(), rtol=2e-4, atol=2e-4
    )


def test_jtr_matches_vjp_and_jtf():
    ops, cimg, x = _problem(seed=2)
    J = _dense_j(ops, cimg, x)
    r = np.asarray(E.residuals(x, ops, cimg))
    jtf, diag = E.jtf_and_diag(x, ops, cimg)
    # JtF = Jᵀ r (gradient of ½Σr²)
    np.testing.assert_allclose(
        (J.T @ r.ravel()).reshape(x.shape), np.asarray(jtf),
        rtol=2e-4, atol=2e-4,
    )
    # diag(JᵀJ) matches the closed-form preconditioner diagonal
    np.testing.assert_allclose(
        np.einsum("ij,ij->j", J, J).reshape(x.shape), np.asarray(diag),
        rtol=2e-4, atol=2e-4,
    )


def test_jtjp_matches_apply_jtj():
    ops, cimg, x = _problem(seed=3)
    J = _dense_j(ops, cimg, x)
    s, c = E.trig(x)
    rng = np.random.default_rng(4)
    p = rng.standard_normal(x.shape).astype(np.float32)
    ref = (J.T @ (J @ p.ravel())).reshape(x.shape)
    got = np.asarray(E.apply_jtj(jnp.asarray(p), ops, s, c))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_structure_masked_rows_absent():
    ops, cimg, x = _problem(seed=5)
    H, W = x.shape[-2:]
    rows, cols, vals = E.sparse_jacobian(x, ops, cimg)
    assert (vals != 0).all()
    # no residual row may touch an excluded pixel's unknowns
    m = np.asarray(ops.mask).ravel() == 0  # excluded
    assert not m[cols % (H * W)].any()

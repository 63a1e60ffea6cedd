"""Graph-domain energies: the explicit edge-list ARAP formulation must match
the stencil formulation, and solve on the generic GN machinery."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import generic as G
from arap_flow.ops import graph as GR


def _setup(H=12, W=15):
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2:10, 3:12] = 0
    cons = np.array([[5, 4, 7, 5], [9, 8, 8, 7]], np.int32)
    ops = E.build_operands(arap_mask, cons)
    return arap_mask, cons, ops


def test_graph_residuals_match_stencil():
    """Σr² over explicit edges == Σr² of the stencil reg term."""
    H, W = 12, 15
    arap_mask, cons, ops = _setup(H, W)
    rng = np.random.default_rng(0)
    x_img = E.init_state(ops) + 0.3 * jnp.asarray(
        rng.standard_normal((3, H, W)), jnp.float32
    )
    cimg = E.anneal_constraints(ops, 1.0)

    # stencil reg energy = total − fit part
    r_all = E.residuals(x_img, ops, cimg)
    reg_energy = float(jnp.sum(r_all[:8] ** 2))

    edges = GR.grid_edges(arap_mask)
    x_flat = x_img.reshape(3, -1)
    ur = ops.grid.reshape(2, -1)
    r_g = GR.arap_graph_residuals(
        x_flat, jnp.asarray(edges), ur, jnp.sqrt(ops.wr2)
    )
    np.testing.assert_allclose(
        float(jnp.sum(r_g ** 2)), reg_energy, rtol=1e-5
    )


def test_graph_solve_via_generic_gn():
    """The edge-list formulation solves with the generic GN and reaches the
    same solution as the image-domain solver."""
    H, W = 12, 15
    arap_mask, cons, ops = _setup(H, W)
    cons_p = add_border_pins(cons, W, H)
    ops_p = E.build_operands(arap_mask, cons_p)
    cimg = E.anneal_constraints(ops_p, 1.0)

    edges = jnp.asarray(GR.grid_edges(arap_mask))
    ur = ops_p.grid.reshape(2, -1)
    # active constraint verts from the operand images
    fit = np.asarray(ops_p.fitmask).ravel()
    verts = jnp.asarray(np.where(fit > 0)[0], jnp.int32)
    tgts = jnp.asarray(
        np.asarray(cimg).reshape(2, -1)[:, np.asarray(verts)].T
    )

    def residual_fn(x_flat):
        return (
            GR.arap_graph_residuals(x_flat, edges, ur, jnp.sqrt(ops_p.wr2)),
            GR.fit_graph_residuals(x_flat, verts, tgts, jnp.sqrt(ops_p.wf2)),
        )

    x0 = E.init_state(ops_p).reshape(3, -1)
    xg = jax.jit(
        lambda x: G.gn_solve(residual_fn, x, gn_iters=4, pcg_iters=120)
    )(x0)

    # image-domain reference
    from arap_flow.ops import solver as S

    cfg = S.SolverConfig(num_anneal=1, gn_iters=4, max_pcg_iters=120,
                         pcg_iters=120.0)
    x_img = E.init_state(ops_p)
    for _ in range(4):
        x_img, _ = S.gn_step(x_img, ops_p, cimg, cfg, 120.0, 0.0, 0.0)

    active = np.asarray(ops_p.mask).ravel() > 0
    d = np.abs(np.asarray(xg)[:, active] - np.asarray(x_img).reshape(3, -1)[:, active])
    assert d.max() < 5e-3, d.max()

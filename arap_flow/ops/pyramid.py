"""Coarse-to-fine (multigrid warm-start) ARAP solving — EXPERIMENTAL.

Measured on the cat512 golden fixture (scripts/pyramid_check.py):
fine=1 → EPE 0.62 px vs the flat schedule's 0.064 px; fine=2 → 0.39 px.
The annealed trajectory at full resolution matters for reference parity,
so this mode does NOT meet parity-accuracy targets — kept as an opt-in for
consumers who can accept ~0.5 px EPE.


The reference anneals constraints over 19 full-resolution solves
(CombinedSolver.h:199-201) purely to keep Gauss-Newton in the right basin for
large displacements. A half-resolution solve reaches the same basin at ~1/4
the cost per iteration; the fine level then needs only the final-α polish.

Schedule: full annealed schedule on the ×½ problem → upsample the flow (×2,
bilinear) and angle as the fine init → `fine_anneal` annealed steps (default 1,
i.e. α=1 only) × gn × pcg at full resolution.

This changes the optimisation trajectory, so it is an OPT-IN speed mode
(`pyramid=True`); accuracy must be validated per use case — the cat512 golden
EPE check lives in scripts/pyramid_check.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import energy as E
from . import solver as S


def coarsen_problem(
    arap_mask: np.ndarray, constraints: np.ndarray, weights: E.ArapWeights
):
    """Half-resolution operands: mask coarsened by 'any solve pixel', constraint
    coords halved (later duplicates win, as in build_operands)."""
    H, W = arap_mask.shape
    H2, W2 = H // 2, W // 2
    m = (arap_mask == 0)[: H2 * 2, : W2 * 2]
    m2 = m.reshape(H2, 2, W2, 2).any((1, 3))
    coarse_mask = np.where(m2, 0, 255).astype(np.uint8)
    cons = np.asarray(constraints, np.int64).reshape(-1, 4) // 2
    cons = cons[(cons[:, 0] < W2) & (cons[:, 1] < H2)]
    return E.build_operands(coarse_mask, cons.astype(np.int32), weights), (H2, W2)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("H", "W"))
def _upsample_flow(flow_c: jnp.ndarray, angle_c: jnp.ndarray, H: int, W: int):
    """×2 bilinear upsample of coarse flow (values doubled) and angle."""
    fc = jax.image.resize(flow_c, (2, H, W), "bilinear") * 2.0
    ac = jax.image.resize(angle_c, (H, W), "bilinear")
    return fc, ac


def solve_pyramid(
    arap_mask: np.ndarray,
    constraints: np.ndarray,
    cfg: S.SolverConfig,
    weights: E.ArapWeights = E.ArapWeights(),
    fine_anneal: int = 1,
):
    """Two-level coarse-to-fine solve; returns (x (3,H,W), flow (2,H,W)) on the
    fine grid. `cfg` applies to the coarse level; the fine level runs
    `fine_anneal` anneal steps with the same gn/pcg counts."""
    H, W = arap_mask.shape
    ops_f = E.build_operands(arap_mask, constraints, weights)
    ops_c, (H2, W2) = coarsen_problem(arap_mask, constraints, weights)

    x_c, flow_c = S.solve(ops_c, cfg)

    fine_cfg = cfg._replace(num_anneal=fine_anneal)
    # the upsample + init assembly runs INSIDE the fine-solve jit: eager jnp
    # ops each compile separately, and eager-produced inputs can
    # re-fingerprint the fine executable
    x = _fine_solve_from_coarse(flow_c, x_c[2], ops_f, fine_cfg.dynamic,
                                fine_cfg.static_key)
    return x, x[:2] - ops_f.grid


from functools import partial


@partial(jax.jit, static_argnames=("static_key",))
def _fine_solve_from_coarse(flow_c, angle_c, ops, dyn, static_key):
    """Upsample the coarse solution and run the fine anneal, all as ONE
    compiled program (see solve_pyramid)."""
    H, W = ops.mask.shape
    flow_f, angle_f = _upsample_flow(flow_c, angle_c, H, W)
    x0 = jnp.concatenate([ops.grid + flow_f, angle_f[None]])
    # zero init outside the solve region (excluded pixels stay at rest)
    x0 = jnp.where(ops.mask[None] > 0, x0,
                   jnp.concatenate([ops.grid,
                                    jnp.zeros((1, H, W), jnp.float32)]))
    return _fine_solve(x0, ops, dyn, static_key)


def _fine_solve(x0, ops, dyn, static_key):
    cfg = S._rebuild_config(dyn, static_key)
    pcg_iters = jnp.float32(cfg.pcg_iters)
    q_tol = jnp.float32(cfg.q_tolerance)
    rz_tol = jnp.float32(cfg.rz_tolerance)

    def outer(i, x):
        alpha = (i + 1.0) / cfg.num_anneal
        cimg = E.anneal_constraints(ops, alpha)

        def inner(_, xx):
            xx, _it = S.gn_step(xx, ops, cimg, cfg, pcg_iters, q_tol, rz_tol)
            return xx

        return jax.lax.fori_loop(0, cfg.gn_iters, inner, x)

    return jax.lax.fori_loop(0, cfg.num_anneal, outer, x0)

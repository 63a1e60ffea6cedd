"""Explicit graph-connectivity energies (the OptGraph analogue).

The reference declares a hyper-graph parameter type — per-edge vertex index
lists uploaded to the GPU (OptGraph.h:48-76, createGraphFromNeighborLists) —
which the ARAP plan never uses (its energy is stencil-structured). This module
provides the same capability in JAX: residuals over an explicit edge
list, evaluated with gathers and differentiated by jax (via ops/generic.py),
so irregular-connectivity least-squares problems (meshes, sparse grids) run on
the same GN/PCG machinery.

Edges are (E, 2) int32 vertex-index pairs into flattened pixel/vertex arrays;
`arap_graph_residuals` reproduces the ARAP regularisation term from an edge
list, which tests verify against the stencil formulation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def grid_edges(arap_mask: np.ndarray) -> np.ndarray:
    """4-neighbor edge list over the solve region (directed, both ways) —
    exactly the stencil's residual set (arap_plan.t:14-19) as explicit graph
    edges. Returns (E, 2) int32 of flat indices."""
    H, W = arap_mask.shape
    m = arap_mask == 0
    idx = np.arange(H * W).reshape(H, W)
    edges = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        ys, xs = np.where(m)
        yj, xj = ys + dy, xs + dx
        ok = (yj >= 0) & (yj < H) & (xj >= 0) & (xj < W)
        ok_idx = np.where(ok)[0]
        ok2 = m[yj[ok_idx], xj[ok_idx]]
        keep = ok_idx[ok2]
        edges.append(
            np.stack([idx[ys[keep], xs[keep]], idx[yj[keep], xj[keep]]], 1)
        )
    return np.concatenate(edges, 0).astype(np.int32)


def arap_graph_residuals(
    x: jnp.ndarray,
    edges: jnp.ndarray,
    urshape: jnp.ndarray,
    w_reg_sqrt,
) -> jnp.ndarray:
    """Per-edge ARAP regularisation residuals from an explicit edge list.

    x: (3, N) unknowns [ox, oy, angle] over flattened vertices;
    urshape: (2, N); edges: (E, 2). Returns (E, 2) residuals
    r_e = w * ((o_i − o_j) − R(a_i)(u_i − u_j)) — the graph-domain counterpart
    of the stencil term (arap_plan.t:15-16)."""
    i = edges[:, 0]
    j = edges[:, 1]
    ox = x[0]
    oy = x[1]
    a = x[2]
    s = jnp.sin(a[i])
    c = jnp.cos(a[i])
    dux = urshape[0, i] - urshape[0, j]
    duy = urshape[1, i] - urshape[1, j]
    rx = (ox[i] - ox[j]) - (c * dux - s * duy)
    ry = (oy[i] - oy[j]) - (s * dux + c * duy)
    return w_reg_sqrt * jnp.stack([rx, ry], 1)


def fit_graph_residuals(
    x: jnp.ndarray,
    verts: jnp.ndarray,
    targets: jnp.ndarray,
    w_fit_sqrt,
) -> jnp.ndarray:
    """Point-constraint residuals over an explicit vertex list: (K, 2) of
    w * (o_v − target) (the graph counterpart of the fit term, arap_plan.t:21-23)."""
    v = verts
    rx = x[0, v] - targets[:, 0]
    ry = x[1, v] - targets[:, 1]
    return w_fit_sqrt * jnp.stack([rx, ry], 1)

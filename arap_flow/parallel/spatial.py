"""Spatially-sharded ARAP solve: image rows split across the mesh's 'space'
axis with ppermute halo exchange.

This is the context/sequence-parallel analogue for this workload (SURVEY.md
§2.7, §5 "long-context"): the 4-neighbor stencil (arap_plan.t:14) needs a 1-row
halo per JtJ/JtF apply, exchanged over ICI with `lax.ppermute`; the PCG dot
products become `lax.psum` reductions. Excluded/ghost rows are provably inert
(zero masks), so padding local blocks with zero ghosts and cropping after each
stencil apply reproduces the single-chip solve exactly (up to the reduction
order of psum).

Intended for frames that exceed one chip's HBM; the default pipeline path is
pure data parallelism (parallel/mesh.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import energy as E
from ..ops import solver as S
from ..ops.energy import ArapOperands


def _halo(a: jnp.ndarray, axis: str) -> jnp.ndarray:
    """Add 1-row ghost halos on dim -2, filled from mesh neighbors over ICI
    (zeros at the global boundary — matching the stencil's zero padding)."""
    n = lax.axis_size(axis)
    if n == 1:
        pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (0, 0)]
        return jnp.pad(a, pad)
    top = lax.ppermute(
        a[..., -1:, :], axis, [(i, i + 1) for i in range(n - 1)]
    )
    bot = lax.ppermute(a[..., :1, :], axis, [(i, i - 1) for i in range(1, n)])
    return jnp.concatenate([top, a, bot], axis=-2)


def _pad_rows(a: jnp.ndarray) -> jnp.ndarray:
    pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (0, 0)]
    return jnp.pad(a, pad)


def _pad_ops(ops: ArapOperands) -> ArapOperands:
    """Zero ghost rows on every operand plane (ghost outputs are cropped; ghost
    operand values are never read for interior outputs)."""
    return jax.tree.map(
        lambda leaf: _pad_rows(leaf) if leaf.ndim >= 2 else leaf, ops
    )


def _psum_dot(a, b, axis):
    return lax.psum(jnp.sum(a * b), axis)


def _pcg_spatial(ops_pad, s, c, jtf, diag, cfg: S.SolverConfig, axis: str,
                 pcg_iters=None):
    """Jacobi-PCG with halo-exchanged JtJ applies and psum reductions.

    All state lives unpadded (local rows); only JtJ inputs get halos.
    `pcg_iters` overrides cfg.pcg_iters (the per-anneal-step budget of the
    non-uniform schedule)."""
    b = -jtf
    pre = S.guarded_invert(diag)
    r0 = b
    z0 = pre * r0
    p0 = z0
    rz0 = _psum_dot(r0, z0, axis)
    iters = cfg.pcg_iters if pcg_iters is None else pcg_iters
    budget = jnp.minimum(jnp.float32(cfg.max_pcg_iters), jnp.float32(iters))
    q_tol = jnp.float32(cfg.q_tolerance)
    rz_tol = jnp.float32(cfg.rz_tolerance)

    def apply_a(p):
        ph = _halo(p, axis)
        sh = _halo(s, axis)
        ch = _halo(c, axis)
        return E.apply_jtj(ph, ops_pad, sh, ch)[..., 1:-1, :]

    def cond(state):
        i, _, _, _, rz, _, converged = state
        return jnp.logical_and(i < budget, jnp.logical_not(converged))

    def body(state):
        i, delta, r, p, rz, q_prev, _ = state
        ap = apply_a(p)
        pap = _psum_dot(p, ap, axis)
        alpha = jnp.where(pap > 0.0, rz / pap, 0.0)
        delta = delta + alpha * p
        r = r - alpha * ap
        z = pre * r
        rz_new = _psum_dot(z, r, axis)
        beta = jnp.where(rz > 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        q = 0.5 * _psum_dot(delta, r + b, axis)
        zeta = (i + 1.0) * (q - q_prev) / jnp.where(q == 0.0, 1.0, q)
        conv = jnp.logical_or(
            jnp.logical_and(q_tol > 0.0, zeta < q_tol),
            jnp.logical_and(rz_tol > 0.0, rz_new < rz_tol * rz_tol * rz0),
        )
        return i + 1.0, delta, r, p, rz_new, q, conv

    state = (jnp.float32(0.0), jnp.zeros_like(jtf), r0, p0, rz0,
             jnp.float32(0.0), jnp.array(False))
    state = lax.while_loop(cond, body, state)
    return state[1]


def _solve_one_spatial(ops: ArapOperands, cfg: S.SolverConfig, axis: str):
    """Full annealed GN solve on spatially-sharded rows (one problem).

    Honors the non-uniform schedule (pcg_iters_early/anneal_split) exactly
    like anneal_solve_stats / _solve_batch_kernel_impl — the spatial path
    must not silently diverge from the data-parallel paths for the same cfg.
    """
    ops_pad = _pad_ops(ops)
    x0 = E.init_state(ops)
    pcg_late = jnp.float32(cfg.pcg_iters)
    pcg_early = jnp.float32(cfg.pcg_iters_early)
    split = jnp.float32(cfg.anneal_split)

    def gn(x, cimg_pad, iters):
        xh = _halo(x, axis)
        sh, ch = E.trig(xh)
        jtf, diag = E.jtf_and_diag(xh, ops_pad, cimg_pad)
        jtf = jtf[..., 1:-1, :]
        diag = diag[..., 1:-1, :]
        s = sh[..., 1:-1, :]
        c = ch[..., 1:-1, :]
        delta = _pcg_spatial(ops_pad, s, c, jtf, diag, cfg, axis,
                             pcg_iters=iters)
        return x + delta

    def outer(i, x):
        alpha = (i + 1.0) / cfg.num_anneal
        cimg_pad = E.anneal_constraints(ops_pad, alpha)
        iters = jnp.where(
            jnp.logical_and(pcg_early > 0.0, i.astype(jnp.float32) < split),
            pcg_early, pcg_late,
        )
        return lax.fori_loop(
            0, cfg.gn_iters, lambda _, xx: gn(xx, cimg_pad, iters), x
        )

    x = lax.fori_loop(0, cfg.num_anneal, outer, x0)
    return x, S.flow_from_state(x, ops)


def _leaf_spec(leaf) -> P:
    if leaf.ndim >= 3:
        return P("data", *([None] * (leaf.ndim - 3)), "space", None)
    return P("data")


from functools import lru_cache


@lru_cache(maxsize=None)
def _solve_spatial_fn(mesh: Mesh, static_key, leaf_ndims: tuple):
    """Cached jit(shard_map) for the spatial solve: keyed on the mesh, the
    STATIC half of SolverConfig, and the operand leaf ranks — dynamic floats
    stay traced, so schedule sweeps reuse ONE executable (a per-call closure
    would re-trace and recompile every invocation, and it baked
    pcg_iters/q_tolerance as constants in violation of the SolverConfig
    static/dynamic split)."""
    def spec_for(nd):
        if nd >= 3:
            return P("data", *([None] * (nd - 3)), "space", None)
        return P("data")

    # ArapOperands is a flat NamedTuple of array leaves: field order ==
    # tree-leaf order, so the spec pytree rebuilds from the ranks alone
    in_specs = ArapOperands(*(spec_for(nd) for nd in leaf_ndims))
    out_spec = P("data", None, "space", None)
    n_dyn = len(S.SolverConfig().dynamic)
    dyn_specs = tuple(P() for _ in range(n_dyn))  # replicated scalars

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_specs, dyn_specs),
        out_specs=(out_spec, out_spec),
        check_vma=False,
    )
    def run(ops_local, dyn):
        cfg = S._rebuild_config(dyn, static_key)
        return jax.vmap(
            lambda o: _solve_one_spatial(o, cfg, "space")
        )(ops_local)

    return jax.jit(run)


def solve_spatial(ops_batched: ArapOperands, cfg: S.SolverConfig, mesh: Mesh):
    """Batched solve with batch over 'data' and rows over 'space'.

    ops_batched: operands with a leading batch axis on every leaf (batch
    divisible by the data-axis size; H divisible by the space-axis size).
    Returns (states (B,3,H,W), flows (B,2,H,W)).
    """
    leaf_ndims = tuple(l.ndim for l in jax.tree.leaves(ops_batched))
    fn = _solve_spatial_fn(mesh, cfg.static_key, leaf_ndims)
    dyn = jax.tree.map(jnp.float32, cfg.dynamic)
    return fn(ops_batched, dyn)

"""Gauss-Newton + preconditioned-conjugate-gradient ARAP solver, fully fused.

Replacement for the Opt-generated GN/PCG solver (solverGPUGaussNewton.t):
the reference launches ~19×8×(3+400×3) CUDA kernels per frame (SURVEY.md
§3.2); here the whole annealed schedule — 19 constraint anneal steps × 8 GN
iterations × ≤400 PCG iterations — is ONE jitted XLA program with `lax`
control flow and deterministic reductions (the reference's float atomicAdd
dot products are non-deterministic; ours are not). XLA fuses each PCG
iteration into a few stencil/axpy kernels plus reductions — the reference's
own PCGStep1/2/3 design, without the per-launch host driver.

Algorithm parity map:
- PCGInit1 (solverGPUGaussNewton.t:361-396): r₀ = −JtF, M⁻¹ = CERES guarded
  invert of diag(JtJ) (:323-351), p₀ = M⁻¹ r₀.
- PCGStep1/2/3 (:423-551): α = rz/⟨p, JtJ p⟩ (guarded: 0 if denom ≤ 0),
  δ += αp, r −= α·JtJp, z = M⁻¹r, β = rz_new/rz (guarded), p = z + βp.
- PCGLinearUpdate (:553-558): x += δ.
- Outer annealing: constraints lerp source→target with α=(i+1)/numIter
  (CombinedSolver.h:199-201, 223-242).
- Optional early exits (the reference enables a ζ test only for LM,
  :1093-1102): Q-based ζ and/or relative-residual rz tolerance.

Design note: loop *structure* (anneal / GN counts, PCG cap) is static config;
the PCG budget and tolerances are **traced scalars**, so one compiled
executable serves every schedule sweep point. Everything vmaps over a leading
batch axis.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .energy import (
    ArapOperands,
    anneal_constraints,
    apply_jtj,
    cost,
    init_state,
    jtf_and_diag,
    trig,
)


class SolverConfig(NamedTuple):
    """Solver schedule (replaces CombinedSolverParameters.h:3-15 + the Opt
    name-keyed solver parameters, solverGPUGaussNewton.t:26-39).

    Static structure: num_anneal, gn_iters, max_pcg_iters.
    Dynamic knobs (traced; changing them does NOT recompile): pcg_iters
    (budget ≤ cap), q_tolerance (ζ early exit; reference default 1e-4,
    LM-only), rz_tolerance (relative preconditioned-residual exit —
    ||r·z|| < rz_tol² · ||r₀·z₀||; our addition, 0 = off).

    Defaults are the reference application settings (main.cpp:215-221).
    """

    num_anneal: int = 19
    gn_iters: int = 8
    max_pcg_iters: int = 400
    pcg_iters: float = 400.0
    q_tolerance: float = 0.0
    rz_tolerance: float = 0.0
    # non-uniform schedule: anneal steps < anneal_split use pcg_iters_early
    # (0 = uniform). Early anneal steps only steer the basin; full depth is
    # needed only near α = 1.
    pcg_iters_early: float = 0.0
    anneal_split: float = 0.0

    @property
    def static_key(self):
        return (self.num_anneal, self.gn_iters, self.max_pcg_iters)

    @property
    def dynamic(self):
        """Traced knobs (floats) — jit-safe companion of static_key."""
        return (
            float(self.pcg_iters),
            float(self.q_tolerance),
            float(self.rz_tolerance),
            float(self.pcg_iters_early),
            float(self.anneal_split),
        )


def _rebuild_config(dyn, static_key) -> "SolverConfig":
    return SolverConfig(
        num_anneal=static_key[0],
        gn_iters=static_key[1],
        max_pcg_iters=static_key[2],
        pcg_iters=dyn[0],
        q_tolerance=dyn[1],
        rz_tolerance=dyn[2],
        pcg_iters_early=dyn[3],
        anneal_split=dyn[4],
    )


def guarded_invert(diag: jnp.ndarray) -> jnp.ndarray:
    """CERES-style guarded Jacobi inverse: 1/(1+√d)² (solverGPUGaussNewton.t:323-332).

    Also well-defined on excluded pixels (d = 0 → 1), which carry zero residual.
    """
    return 1.0 / jnp.square(1.0 + jnp.sqrt(diag))


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Whole-state dot product (the PCG scan reductions, util.t:611-649)."""
    return jnp.sum(a * b)


def pcg_solve(
    ops: ArapOperands,
    s: jnp.ndarray,
    c: jnp.ndarray,
    jtf: jnp.ndarray,
    diag: jnp.ndarray,
    max_iters: int,
    pcg_iters=None,
    q_tolerance=0.0,
    rz_tolerance=0.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Solve JtJ δ = −JtF with Jacobi-preconditioned CG.

    Returns (δ (3, H, W), iterations executed). `pcg_iters`, `q_tolerance`,
    `rz_tolerance` may be traced scalars.
    """
    b = -jtf
    pre = guarded_invert(diag)
    r0 = b
    z0 = pre * r0
    p0 = z0
    rz0 = _dot(r0, z0)
    delta0 = jnp.zeros_like(jtf)
    budget = jnp.minimum(
        jnp.float32(max_iters),
        jnp.float32(pcg_iters if pcg_iters is not None else max_iters),
    )
    q_tol = jnp.float32(q_tolerance)
    rz_tol = jnp.float32(rz_tolerance)

    def cond(state):
        i, _, _, _, rz, _, converged = state
        return jnp.logical_and(i < budget, jnp.logical_not(converged))

    def body(state):
        i, delta, r, p, rz, q_prev, _ = state
        ap = apply_jtj(p, ops, s, c)
        pap = _dot(p, ap)
        alpha = jnp.where(pap > 0.0, rz / pap, 0.0)
        delta = delta + alpha * p
        r = r - alpha * ap
        z = pre * r
        rz_new = _dot(z, r)
        beta = jnp.where(rz > 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        # Q-based ζ test (solverGPUGaussNewton.t:479-481, 1093-1102):
        # Q = ½ δ·(r + b) approximates the model-cost decrease; break when the
        # normalised per-iteration gain drops below q_tolerance (signed, as in
        # the reference).
        q = 0.5 * _dot(delta, r + b)
        zeta = (i + 1.0) * (q - q_prev) / jnp.where(q == 0.0, 1.0, q)
        conv_q = jnp.logical_and(q_tol > 0.0, zeta < q_tol)
        conv_rz = jnp.logical_and(rz_tol > 0.0, rz_new < rz_tol * rz_tol * rz0)
        return i + 1.0, delta, r, p, rz_new, q, jnp.logical_or(conv_q, conv_rz)

    state = (
        jnp.float32(0.0),
        delta0,
        r0,
        p0,
        rz0,
        jnp.zeros((), rz0.dtype),  # q carry follows the solve dtype
        jnp.array(False),
    )
    state = lax.while_loop(cond, body, state)
    return state[1], state[0]


def gn_step(x, ops, cimg, cfg: SolverConfig, pcg_iters, q_tol, rz_tol):
    """One Gauss-Newton iteration: linearise at x, PCG-solve, update.

    Returns (x', pcg iterations used)."""
    s, c = trig(x)
    jtf, diag = jtf_and_diag(x, ops, cimg)
    delta, iters = pcg_solve(
        ops, s, c, jtf, diag, cfg.max_pcg_iters, pcg_iters, q_tol, rz_tol
    )
    return x + delta, iters


def anneal_solve_stats(ops: ArapOperands, cfg: SolverConfig):
    """Full solve: constraint annealing outer loop over GN (parity with
    CombinedSolverBase::singleSolve, CombinedSolverBase.h:99-120, driving
    setConstraintImage(α=(i+1)/numIter), CombinedSolver.h:199-201).

    Returns (x (3,H,W), total PCG iterations)."""
    x0 = init_state(ops)
    pcg_late = jnp.float32(cfg.pcg_iters)
    pcg_early = jnp.float32(cfg.pcg_iters_early)
    split = jnp.float32(cfg.anneal_split)
    q_tol = jnp.float32(cfg.q_tolerance)
    rz_tol = jnp.float32(cfg.rz_tolerance)

    def outer(i, carry):
        x, tot = carry
        alpha = (i + 1.0) / cfg.num_anneal
        cimg = anneal_constraints(ops, alpha)
        pcg_iters = jnp.where(
            jnp.logical_and(pcg_early > 0.0, i.astype(jnp.float32) < split),
            pcg_early, pcg_late,
        )

        def inner(_, carry2):
            x2, tot2 = carry2
            x2, it = gn_step(x2, ops, cimg, cfg, pcg_iters, q_tol, rz_tol)
            return x2, tot2 + it

        return lax.fori_loop(0, cfg.gn_iters, inner, (x, tot))

    return lax.fori_loop(0, cfg.num_anneal, outer, (x0, jnp.float32(0.0)))


def anneal_solve(ops: ArapOperands, cfg: SolverConfig) -> jnp.ndarray:
    return anneal_solve_stats(ops, cfg)[0]


def flow_from_state(x: jnp.ndarray, ops: ArapOperands) -> jnp.ndarray:
    """Dense flow (2, H, W) = warpField − grid (CombinedSolver.h:352-366)."""
    return x[:2] - ops.grid


@partial(jax.jit, static_argnames=("static_key",))
def _solve_impl(ops, dyn, static_key):
    cfg = _rebuild_config(dyn, static_key)
    x, iters = anneal_solve_stats(ops, cfg)
    return x, flow_from_state(x, ops), iters


def solve(ops: ArapOperands, cfg: SolverConfig):
    """Jitted full solve; returns (state (3,H,W), flow (2,H,W)). One compiled
    program per (shape, loop structure); tolerances/budget are traced."""
    x, flow, _ = _solve_impl(ops, cfg.dynamic, cfg.static_key)
    return x, flow


def solve_stats(ops: ArapOperands, cfg: SolverConfig):
    """Like solve() but also returns total PCG iterations executed."""
    return _solve_impl(ops, cfg.dynamic, cfg.static_key)


@partial(jax.jit, static_argnames=("static_key",))
def _solve_batch_impl(ops, dyn, static_key):
    cfg = _rebuild_config(dyn, static_key)

    def one(o):
        x, iters = anneal_solve_stats(o, cfg)
        return x, flow_from_state(x, o), iters

    return jax.vmap(one)(ops)


def solve_batch(ops: ArapOperands, cfg: SolverConfig):
    """Batched solve over the leading axis of every operand leaf; returns
    (states (B,3,H,W), flows (B,2,H,W)). Replaces the reference's one-CUDA-
    process-per-problem task farm (para_gen.py:560-567) with on-device
    batching; each problem keeps its own energy weights."""
    xs, flows, _ = _solve_batch_impl(ops, cfg.dynamic, cfg.static_key)
    return xs, flows


def solve_instrumented(ops: ArapOperands, cfg: SolverConfig):
    """Solve while recording the energy after every GN iteration.

    Returns (x, flow, costs (num_anneal*gn_iters,)). The profiling analogue of
    launchProfiledSolve + SolverIteration (OptUtils.h:47-64, SolverIteration.h).
    """
    x0 = init_state(ops)
    n = cfg.num_anneal * cfg.gn_iters
    pcg_iters = jnp.float32(cfg.pcg_iters)
    q_tol = jnp.float32(cfg.q_tolerance)
    rz_tol = jnp.float32(cfg.rz_tolerance)

    def outer(i, carry):
        x, costs = carry
        alpha = (i + 1.0) / cfg.num_anneal
        cimg = anneal_constraints(ops, alpha)

        def inner(j, carry2):
            x2, costs2 = carry2
            x2, _ = gn_step(x2, ops, cimg, cfg, pcg_iters, q_tol, rz_tol)
            costs2 = costs2.at[i * cfg.gn_iters + j].set(cost(x2, ops, cimg))
            return x2, costs2

        return lax.fori_loop(0, cfg.gn_iters, inner, (x, costs))

    x, costs = lax.fori_loop(0, cfg.num_anneal, outer, (x0, jnp.zeros((n,))))
    return x, flow_from_state(x, ops), costs

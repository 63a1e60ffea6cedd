"""The ARAP image-deformation energy and its Gauss-Newton operators.

This module is the replacement for the whole Opt DSL derivative factory
(reference: arap_plan.t energy spec; o.t:2425-2460 generates cost/evalJTF/applyJTJ
from it via symbolic autodiff). Here the derivatives are hand-derived closed-form
stencil expressions — pure jnp, fused by XLA — and validated against jax autodiff
oracles in tests/test_energy.py.

Problem (arap_plan.t:1-23): per pixel i on a W×H grid, unknowns Offset o_i ∈ R²
(warped position) and Angle a_i ∈ R. Constants: UrShape u_i (= integer grid
coords), Constraints c_i (target position or (-1,-1)), Mask (0 = solve, else
excluded), weights w_fitSqrt, w_regSqrt.

Residuals:
- reg, for each 4-neighbor j of i where both i,j are in-bounds and unmasked:
    r_ij = w_reg_sqrt * ((o_i − o_j) − R(a_i)(u_i − u_j))          ∈ R²
- fit, where c_i ≥ 0 componentwise:
    r_i  = w_fit_sqrt * (o_i − c_i)                                ∈ R²

cost = ½ Σ r² (o.t:2375-2384). Since u is the integer grid, u_i − u_j = −(dx, dy)
for neighbor direction (dy, dx), so with s = sin a_i, c = cos a_i:

    e_dir(i) = (o_i − o_j) + (dx·c − dy·s, dx·s + dy·c)            [R(a_i)(u_i−u_j) folded in]
    t_dir(i) = ∂(−R(a_i)(u_i−u_j))/∂a = (−dx·s − dy·c, dx·c − dy·s)

JtF (gradient), diag(JtJ) (Jacobi preconditioner, o.t:2152-2157) and the
matrix-free JtJ·p apply (o.t:2029-2089) follow by summing each pixel's own
residuals plus its neighbors' residuals that reference it:

    JtF_o(i)  = wr² Σ_dir v_dir [e_dir(i) − ẽ_dir(i)] + wf² fit_i (o_i − c_i)
    JtF_a(i)  = wr² Σ_dir v_dir t_dir(i)·e_dir(i)
    diag_o(i) = 2 wr² deg(i) + wf² fit_i            (same for x and y)
    diag_a(i) = wr² deg(i)                          (|t_dir| = 1)
    (JtJp)_o(i) = wr² Σ_dir v_dir [2(po_i − po_j) + pa_i t_dir(i) + pa_j t_dir(j)]
                  + wf² fit_i po_i
    (JtJp)_a(i) = wr² Σ_dir v_dir [t_dir(i)·(po_i − po_j) + pa_i]

where ẽ_dir(i) is the neighbor's opposite-direction residual evaluated at
j = i + dir, v_dir(i) = mask_i · mask_j (zero-padded = InBounds), and
deg(i) = Σ_dir v_dir(i).

Array layout: unknowns are a single (3, H, W) float32 array x = [ox, oy, angle]
(W the minor, contiguous dimension). All operators are batchable with vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .stencil import DIRS, shift


class ArapWeights(NamedTuple):
    """Energy weights; defaults mirror CombinedSolver.h:173-174 (w_fit=100, w_reg=0.01;
    the solver receives their square roots, arap_plan.t:7-8)."""

    w_fit: float = 100.0
    w_reg: float = 0.01


class ArapOperands(NamedTuple):
    """Per-solve constant operands (the reference's problem parameter images,
    CombinedSolver.h:179-185), precomputed once per problem.

    mask:      (H, W) float32 ∈ {0,1}; 1 = solve region (reference Mask == 0).
    vmasks:    (4, H, W) float32; v_dir = mask · shift(mask, dir) for DIRS order.
    degree:    (H, W) float32; Σ_dir v_dir.
    con_src:   (2, H, W) float32; constraint source position (x1, y1) per pixel.
    con_tgt:   (2, H, W) float32; constraint target position (x2, y2) per pixel.
    fitmask:   (H, W) float32 ∈ {0,1}; 1 where a constraint is active
               (constraint present AND mask==solve, CombinedSolver.h:234).
    grid:      (2, H, W) float32; UrShape = integer pixel coordinates (x, y)
               (CombinedSolver.h:210-213).
    wf2, wr2:  squared weights (w_fit, w_reg) as 0-d float32 arrays.
    """

    mask: jnp.ndarray
    vmasks: jnp.ndarray
    degree: jnp.ndarray
    con_src: jnp.ndarray
    con_tgt: jnp.ndarray
    fitmask: jnp.ndarray
    grid: jnp.ndarray
    wf2: jnp.ndarray
    wr2: jnp.ndarray


def make_grid(H: int, W: int) -> jnp.ndarray:
    """UrShape image: (2, H, W) with channel 0 = x (column), 1 = y (row)."""
    xs = jnp.arange(W, dtype=jnp.float32)[None, :] * jnp.ones((H, 1), jnp.float32)
    ys = jnp.arange(H, dtype=jnp.float32)[:, None] * jnp.ones((1, W), jnp.float32)
    return jnp.stack([xs, ys])


def build_operands(
    arap_mask,
    constraints,
    weights: ArapWeights = ArapWeights(),
    dtype=None,
) -> ArapOperands:
    """Build solve-time operands from an ARAP mask and a constraint list.

    arap_mask:   (H, W) — 0 = solve region, nonzero = excluded (para_gen.py:514-528
                 convention; the plan excludes Mask != 0, arap_plan.t:11).
    constraints: (N, 4) int — rows (x1, y1, x2, y2); should already include border
                 pins (io.constraints.add_border_pins, main.cpp:95-101). Constraints
                 are only activated on solve-region pixels (CombinedSolver.h:234).
    dtype:       solve precision, float32 (default) or float64 — the
                 _opt_double_precision switch (precision.t, Opt.h:10-30). The
                 solver operators follow the operand dtype; f64 requires
                 jax x64 mode (jax.experimental.enable_x64 or the global
                 jax_enable_x64 flag) and routes to the XLA backend.

    Host-side numpy on purpose: device scatters here would compile a fresh
    program per distinct constraint count (a per-segment recompile in the
    pipeline); only the finished planes are shipped to the device.
    """
    import numpy as _np

    dtype = _np.dtype(dtype or _np.float32)
    arap_mask = _np.asarray(arap_mask)
    H, W = arap_mask.shape
    m = (arap_mask == 0).astype(dtype)

    def _shift_np(a, dy, dx):
        out = _np.zeros_like(a)
        ys = slice(max(dy, 0), H + min(dy, 0))
        yd = slice(max(-dy, 0), H + min(-dy, 0))
        xs = slice(max(dx, 0), W + min(dx, 0))
        xd = slice(max(-dx, 0), W + min(-dx, 0))
        out[yd, xd] = a[ys, xs]
        return out

    vmasks = _np.stack([m * _shift_np(m, dy, dx) for dy, dx in DIRS])
    degree = vmasks.sum(0)

    con_src = _np.zeros((2, H, W), dtype)
    con_tgt = _np.zeros((2, H, W), dtype)
    fit = _np.zeros((H, W), dtype)
    constraints = _np.asarray(constraints, _np.int64).reshape(-1, 4)
    if constraints.shape[0]:
        x1, y1, x2, y2 = (constraints[:, k] for k in range(4))
        # Later duplicates win, matching the reference's sequential overwrite
        # (CombinedSolver.h:230-239) — numpy fancy assignment does exactly that.
        con_src[0, y1, x1] = x1
        con_src[1, y1, x1] = y1
        con_tgt[0, y1, x1] = x2
        con_tgt[1, y1, x1] = y2
        fit[y1, x1] = 1.0
    fit = fit * m

    gx, gy = _np.meshgrid(
        _np.arange(W, dtype=dtype), _np.arange(H, dtype=dtype)
    )
    return ArapOperands(
        mask=jnp.asarray(m),
        vmasks=jnp.asarray(vmasks),
        degree=jnp.asarray(degree),
        con_src=jnp.asarray(con_src),
        con_tgt=jnp.asarray(con_tgt),
        fitmask=jnp.asarray(fit),
        grid=jnp.asarray(_np.stack([gx, gy])),
        wf2=jnp.asarray(_np.asarray(weights.w_fit, dtype)),
        wr2=jnp.asarray(_np.asarray(weights.w_reg, dtype)),
    )


class CompactOperands(NamedTuple):
    """Upload-efficient problem encoding.

    Only the true data ships host→device — everything else is derived on
    device by expand_operands inside the jitted solve program (the full
    ArapOperands is 16 f32 planes):

    mask_u8:     (H, W) uint8 raw ARAP mask (0 = solve region).
    con_tgt_i16: (2, H, W) int16 constraint target (x2, y2) per source pixel;
                 NO_CONSTRAINT (int16 min) = no constraint. Targets may be
                 legitimately negative after crop shifting, hence the extreme
                 sentinel.
    wf2 / wr2:   0-d float32 energy weights.

    8 bytes/pixel (with a u8 RGB plane) vs the expanded form's ~64 — ~8×
    less H2D per problem.

    Leaves are HOST numpy arrays until they cross a jit boundary (see
    build_compact) so executables always see fresh default-layout uploads.
    """

    mask_u8: np.ndarray
    con_tgt_i16: np.ndarray
    wf2: np.ndarray
    wr2: np.ndarray


NO_CONSTRAINT = -32768  # int16 min


def build_compact(
    arap_mask, constraints, weights: ArapWeights = ArapWeights()
) -> CompactOperands:
    """Host-side compact encoding. expand_operands(build_compact(m, c))
    equals build_operands(m, c) on every fitmask-active pixel and on all
    gating planes — constraint values on inactive pixels differ (zeros vs raw
    file values) but are unread by construction (tests/test_energy.py checks
    both the planes and bitwise solve equality)."""
    import numpy as _np

    arap_mask = _np.ascontiguousarray(arap_mask, dtype=_np.uint8)
    H, W = arap_mask.shape
    tgt = _np.full((2, H, W), NO_CONSTRAINT, _np.int16)
    constraints = _np.asarray(constraints, _np.int64).reshape(-1, 4)
    if constraints.shape[0]:
        x1, y1, x2, y2 = (constraints[:, k] for k in range(4))
        # later duplicates win (reference sequential overwrite,
        # CombinedSolver.h:230-239)
        tgt[0, y1, x1] = x2
        tgt[1, y1, x1] = y2
    # HOST numpy leaves on purpose: batching code np.stack's tasks on the
    # host and hands numpy to the jitted programs, so every jit input is a
    # fresh host upload with default layout. Stacking per-task DEVICE arrays
    # with eager jnp ops instead compiles one utility XLA program
    # (concatenate/broadcast_in_dim) per shape and can re-fingerprint the
    # big canvas programs (duplicate compiles of identical signatures).
    return CompactOperands(
        mask_u8=arap_mask,
        con_tgt_i16=tgt,
        wf2=_np.float32(weights.w_fit),
        wr2=_np.float32(weights.w_reg),
    )


def expand_operands(c: CompactOperands) -> ArapOperands:
    """Derive the full ArapOperands on device (call INSIDE the jitted solve
    program — the derived planes never leave the device, and keeping the
    jitted inputs as fresh host uploads preserves executable-cache hits)."""
    H, W = c.mask_u8.shape
    m = (c.mask_u8 == 0).astype(jnp.float32)
    vmasks = jnp.stack([m * shift(m, dy, dx) for dy, dx in DIRS])
    grid = make_grid(H, W)
    fit = (c.con_tgt_i16[0] != NO_CONSTRAINT).astype(jnp.float32) * m
    return ArapOperands(
        mask=m,
        vmasks=vmasks,
        degree=vmasks.sum(0),
        con_src=grid * fit,
        con_tgt=c.con_tgt_i16.astype(jnp.float32) * fit,
        fitmask=fit,
        grid=grid,
        wf2=c.wf2,
        wr2=c.wr2,
    )


def anneal_constraints(ops: ArapOperands, alpha) -> jnp.ndarray:
    """Annealed constraint image: lerp source → target by alpha ∈ (0, 1].

    (2, H, W); parity with setConstraintImage, CombinedSolver.h:223-242. Inactive
    pixels are irrelevant (gated by fitmask).
    """
    return (1.0 - alpha) * ops.con_src + alpha * ops.con_tgt


def init_state(ops: ArapOperands) -> jnp.ndarray:
    """Initial unknowns x = [warpField=grid, angle=0]; resetGPU parity
    (CombinedSolver.h:207-221). Follows the operand dtype (f32/f64 switch)."""
    H, W = ops.mask.shape
    return jnp.concatenate([ops.grid, jnp.zeros((1, H, W), ops.grid.dtype)])


def trig(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(sin a, cos a) planes of the current state — fixed across one GN linear solve."""
    return jnp.sin(x[2]), jnp.cos(x[2])


def _reg_residuals(x: jnp.ndarray, ops: ArapOperands):
    """Per-direction masked regularisation residuals; yields (v_dir, e_dir 2-chan)."""
    o = x[:2]
    s, c = trig(x)
    for k, (dy, dx) in enumerate(DIRS):
        oj = shift(o, dy, dx)
        ex = o[0] - oj[0] + (dx * c - dy * s)
        ey = o[1] - oj[1] + (dx * s + dy * c)
        yield ops.vmasks[k], jnp.stack([ex, ey])


def residuals(x: jnp.ndarray, ops: ArapOperands, cimg: jnp.ndarray) -> jnp.ndarray:
    """All scalar residuals stacked: (10, H, W) = 4 dirs × 2 + fit × 2.

    Masked residuals are exactly zero (Select(valid, e, 0), arap_plan.t:18, 23).
    Used by tests as the autodiff oracle and by `cost`.
    """
    wr = jnp.sqrt(ops.wr2)
    wf = jnp.sqrt(ops.wf2)
    parts = []
    for v, e in _reg_residuals(x, ops):
        parts.append(wr * v * e)
    parts.append(wf * ops.fitmask * (x[:2] - cimg))
    return jnp.concatenate(parts)


def cost(x: jnp.ndarray, ops: ArapOperands, cimg: jnp.ndarray) -> jnp.ndarray:
    """Total energy ½ Σ r² (o.t:2375-2384)."""
    r = residuals(x, ops, cimg)
    return 0.5 * jnp.sum(r * r)


def _t_dir(s, c, dy: int, dx: int):
    """t_dir = ∂(−R(a)(u_i−u_j))/∂a = (−dx·s − dy·c, dx·c − dy·s)."""
    return (-dx) * s - dy * c, dx * c - dy * s


def jtf_and_diag(
    x: jnp.ndarray, ops: ArapOperands, cimg: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gradient JtF and Jacobi diagonal of JtJ, both (3, H, W).

    Replaces the generated evalJTF kernel (o.t:2129-2172). The diagonal is the
    exact Σ (∂r/∂x)² used for the CERES-guarded preconditioner
    (solverGPUGaussNewton.t:323-351).
    """
    o = x[:2]
    s, c = trig(x)
    g_o = jnp.zeros_like(o)
    g_a = jnp.zeros_like(s)
    for k, (dy, dx) in enumerate(DIRS):
        v = ops.vmasks[k]
        oj = shift(o, dy, dx)
        ex = o[0] - oj[0] + (dx * c - dy * s)
        ey = o[1] - oj[1] + (dx * s + dy * c)
        # neighbor's opposite-direction residual evaluated at j = i + dir:
        # ẽ = (o_j − o_i) − R(a_j)(dx, dy)
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        exn = oj[0] - o[0] - (dx * cj - dy * sj)
        eyn = oj[1] - o[1] - (dx * sj + dy * cj)
        tx, ty = _t_dir(s, c, dy, dx)
        g_o = g_o + v * jnp.stack([ex - exn, ey - eyn])
        g_a = g_a + v * (tx * ex + ty * ey)
    jtf = jnp.concatenate(
        [
            ops.wr2 * g_o + ops.wf2 * ops.fitmask * (o - cimg),
            (ops.wr2 * g_a)[None],
        ]
    )
    diag_o = 2.0 * ops.wr2 * ops.degree + ops.wf2 * ops.fitmask
    diag_a = ops.wr2 * ops.degree
    diag = jnp.stack([diag_o, diag_o, diag_a])
    return jtf, diag


def sparse_jacobian(x, ops: ArapOperands, cimg):
    """Explicit sparse Jacobian export — the dumpJ analogue (o.t:2318-2344,
    the reference's optional CSR export for an external cusparse solver).

    Rows index the 10 scalar residual planes of `residuals` (4 dirs × 2
    components + 2 fit components), row = plane·H·W + y·W + x; columns index
    the flattened unknowns, col = channel·H·W + y·W + x with channels
    (offset_x, offset_y, angle). Returns (rows, cols, vals) numpy COO arrays
    with structural zeros (masked residuals) removed. Beyond parity, this is
    an independent oracle for the hand-derived stencil operators — see
    tests/test_dumpj.py (J·p ≡ jvp, JᵀJ·p ≡ apply_jtj, diag(JᵀJ) ≡
    jtf_and_diag).
    """
    import numpy as _np

    x = _np.asarray(x)
    H, W = x.shape[-2:]
    HW = H * W
    s, c = _np.sin(x[2]), _np.cos(x[2])
    wr = float(_np.sqrt(_np.asarray(ops.wr2)))
    wf = float(_np.sqrt(_np.asarray(ops.wf2)))
    vmasks = _np.asarray(ops.vmasks)
    fit = _np.asarray(ops.fitmask)
    pix = _np.arange(HW, dtype=_np.int64).reshape(H, W)

    rows_l, cols_l, vals_l = [], [], []

    def emit(row, col, val):
        rows_l.append(row.ravel())
        cols_l.append(col.ravel())
        vals_l.append(val.ravel())

    yy, xx = _np.mgrid[0:H, 0:W]
    for k, (dy, dx) in enumerate(DIRS):
        v = vmasks[k]
        jy = _np.clip(yy + dy, 0, H - 1)
        jx = _np.clip(xx + dx, 0, W - 1)
        jpix = jy * W + jx
        tx, ty = _t_dir(s, c, dy, dx)
        for comp, t_a in ((0, tx), (1, ty)):
            row = (2 * k + comp) * HW + pix
            emit(row, comp * HW + pix, wr * v)        # ∂/∂o_i
            emit(row, comp * HW + jpix, -wr * v)      # ∂/∂o_j
            emit(row, 2 * HW + pix, wr * v * t_a)     # ∂/∂a_i
    for comp in (0, 1):
        row = (8 + comp) * HW + pix
        emit(row, comp * HW + pix, wf * fit)

    rows = _np.concatenate(rows_l)
    cols = _np.concatenate(cols_l)
    vals = _np.concatenate(vals_l).astype(_np.asarray(x).dtype)
    keep = vals != 0.0
    return rows[keep], cols[keep], vals[keep]


def apply_jtj(
    p: jnp.ndarray,
    ops: ArapOperands,
    s: jnp.ndarray,
    c: jnp.ndarray,
) -> jnp.ndarray:
    """Matrix-free JtJ·p at the linearisation point given by (s, c) = trig(x).

    Replaces the generated applyJTJ gather kernel (o.t:2029-2089). This is the
    hot op: called once per PCG iteration (solverGPUGaussNewton.t PCGStep1).
    """
    po = p[:2]
    pa = p[2]
    out_o = ops.wf2 * ops.fitmask * po
    out_a = jnp.zeros_like(pa)
    acc_o = jnp.zeros_like(po)
    acc_a = out_a
    for k, (dy, dx) in enumerate(DIRS):
        v = ops.vmasks[k]
        poj = shift(po, dy, dx)
        paj = shift(pa, dy, dx)
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        tx, ty = _t_dir(s, c, dy, dx)
        txj, tyj = _t_dir(sj, cj, dy, dx)
        dox = po[0] - poj[0]
        doy = po[1] - poj[1]
        acc_o = acc_o + v * jnp.stack(
            [
                2.0 * dox + pa * tx + paj * txj,
                2.0 * doy + pa * ty + paj * tyj,
            ]
        )
        acc_a = acc_a + v * (tx * dox + ty * doy + pa)
    return jnp.concatenate(
        [out_o + ops.wr2 * acc_o, (ops.wr2 * acc_a)[None]]
    )

"""On-device sparse correspondence matching (DeepMatching replacement).

The reference shells out to the DeepMatching binary (`deepmatching-static im1
im2 -nt 0 -out f -ngh_rad 100`, para_gen.py:227-240) and consumes text lines
``x1 y1 x2 y2 score``. This module produces the same product — sparse,
segment-filterable correspondences with bounded displacement — with an
on-device coarse-to-fine normalized-cross-correlation pyramid:

1. grayscale + Gaussian-ish pyramid (2×2 average pooling);
2. at the coarsest level, exhaustive NCC search over a static offset window
   (the `-ngh_rad` bound shrunk by the pyramid factor) using z-scored patches
   and fused static shifts — run once per ROTATION HYPOTHESIS (a static angle
   set; image 2 is rotated about its center before the search and the winning
   angle is folded back into the seeded flow field), giving DeepMatching-like
   tolerance to large rotations that the ±2/level refinement alone cannot
   track (measured: a 25° rotation collapses the 0-hypothesis matcher to ~30
   wrong matches; with hypotheses the field is recovered);
3. at each finer level, the upsampled flow warps image 2 (one bilinear gather),
   then a ±2 static-offset NCC search refines the estimate (optionally
   iterated: `refine_passes` re-warps at the improved estimate);
4. forward-backward consistency and a minimum-NCC threshold select matches on
   a regular grid (DM emits a quasi-regular grid as well).

Defaults patch=12 / levels=3 are calibrated on the cat512 fixture's extreme
non-rigid warp (96 px marker displacements): vs the shipped golden flow the
matched displacements go from median 7.1 px error / 5 surviving matches at
patch=8, levels=4 to median 1.4 px / 55 matches (scripts/matcher_ab.py
measures the full through-solve A/B). The larger patch carries more context
through the per-level z-scored NCC; the level cap (≥3 patches across the
coarsest level) then bounds levels at typical frame sizes anyway.

The downstream constraint filter (io.constraints.filter_matches, parity with
para_gen.py:216-223) is unchanged, so matcher differences are forgiven by the
dist<60 / segment-consistency rules exactly as they are for DeepMatching.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """(3, H, W) float32 RGB -> (H, W) luma."""
    return 0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]


def _avg_pool2(im: jnp.ndarray) -> jnp.ndarray:
    """2×2 average pool over the last two axes; leading axes batched."""
    H, W = im.shape[-2:]
    H2, W2 = H // 2, W // 2
    lead = im.shape[:-2]
    out = im[..., : H2 * 2, : W2 * 2].reshape(*lead, H2, 2, W2, 2)
    return out.mean((-3, -1))


def _box_sum(im: jnp.ndarray, k: int) -> jnp.ndarray:
    """k×k box sum over the LAST TWO axes, same-size (zero padded), via two
    separable cumsum passes; leading axes are batched.

    Window for output i covers [i − k//2, i + k − 1 − k//2]. The cumsum form
    stays O(elements) whatever k; a lax.reduce_window may expand the k×k
    window naively."""
    a = k // 2
    b = k - 1 - a
    nd = im.ndim

    def along(x, axis):
        pad = [(0, 0)] * nd
        pad[axis] = (a, b)
        xp = jnp.pad(x, pad)
        c = jnp.cumsum(xp, axis=axis)
        zshape = list(c.shape)
        zshape[axis] = 1
        c = jnp.concatenate([jnp.zeros(zshape, c.dtype), c], axis=axis)
        n = x.shape[axis]
        hi = jax.lax.slice_in_dim(c, k, k + n, axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, n, axis=axis)
        return hi - lo

    return along(along(im, nd - 2), nd - 1)


def _zscore(im: jnp.ndarray, k: int, eps: float = 1e-4) -> jnp.ndarray:
    """Patch-normalize: subtract k×k local mean, divide by local std."""
    n = float(k * k)
    mu = _box_sum(im, k) / n
    var = _box_sum(im * im, k) / n - mu * mu
    return (im - mu) / jnp.sqrt(jnp.maximum(var, eps))


def _bilinear(plane: jnp.ndarray, qx: jnp.ndarray, qy: jnp.ndarray) -> jnp.ndarray:
    H, W = plane.shape
    qx = jnp.clip(qx, 0.0, W - 1.0)
    qy = jnp.clip(qy, 0.0, H - 1.0)
    x0 = jnp.floor(qx).astype(jnp.int32)
    y0 = jnp.floor(qy).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = qx - x0
    fy = qy - y0
    flat = plane.ravel()
    # all four corners in ONE gather op
    idx = jnp.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    c = flat[idx]
    return (
        c[0] * (1 - fx) * (1 - fy)
        + c[1] * fx * (1 - fy)
        + c[2] * (1 - fx) * fy
        + c[3] * fx * fy
    )


# element budget for materialising the whole offset window at once via one
# gather (n_off · H · W): coarse pyramid levels fit easily; fine levels
# take the dynamic_slice shift form instead of gathering full-resolution
# shifted planes
_SEARCH_VEC_BUDGET = 48 * 1024 * 1024


def _search(z1: jnp.ndarray, z2: jnp.ndarray, radius: int, patch: int,
            budget_div: int = 1):
    """Exhaustive NCC search: returns (du, dv, score) per pixel, each (H, W).

    score is mean z1·z2 over the patch ∈ [−1, 1]. Two schedules, identical
    results (same raster offset order, first-max tie-breaking):

    - LARGE offset windows on SMALL planes (the coarse pyramid level): one
      gather materialises every shifted image, then a batched box-sum +
      argmax. A sequential scan here is latency-bound — 27²·5 rotations =
      3645 tiny steps dominated the matcher's device time.
    - everything else (the ±2 refine searches at full resolution): a
      lax.scan of dynamic_slice shifts — slices are near-free while
      full-resolution gathers are ~35 M rows/s, and the big per-step
      tensors amortise the scan's step latency. Graph size stays
      radius-independent (an unrolled loop explodes XLA compile time).
    """
    n = float(patch * patch)
    H, W = z1.shape
    z2p = jnp.pad(z2, radius)
    dys, dxs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    n_off = dys.size

    if n_off > 49 and n_off * H * W <= _SEARCH_VEC_BUDGET // max(1, budget_div):
        dy = jnp.asarray(dys.ravel() + radius, jnp.int32)
        dx = jnp.asarray(dxs.ravel() + radius, jnp.int32)
        rows = dy[:, None, None] + jnp.arange(H, dtype=jnp.int32)[None, :, None]
        cols = dx[:, None, None] + jnp.arange(W, dtype=jnp.int32)[None, None, :]
        shifts = z2p[rows, cols]  # (n_off, H, W)
        corr = _box_sum(z1[None] * shifts, patch) / n
        best_idx = jnp.argmax(corr, axis=0)  # first max wins, raster order
        best = jnp.take_along_axis(corr, best_idx[None], axis=0)[0]
        bu = jnp.asarray(dxs.ravel(), jnp.float32)[best_idx]
        bv = jnp.asarray(dys.ravel(), jnp.float32)[best_idx]
        return bu, bv, best

    offs = jnp.asarray(
        np.stack([dys.ravel(), dxs.ravel()], 1), jnp.int32
    )

    def body(carry, off):
        best, bu, bv = carry
        dy, dx = off[0], off[1]
        z2s = jax.lax.dynamic_slice(z2p, (radius + dy, radius + dx), (H, W))
        corr = _box_sum(z1 * z2s, patch) / n
        take = corr > best
        best = jnp.where(take, corr, best)
        bu = jnp.where(take, dx.astype(jnp.float32), bu)
        bv = jnp.where(take, dy.astype(jnp.float32), bv)
        return (best, bu, bv), None

    init = (
        jnp.full(z1.shape, -jnp.inf, jnp.float32),
        jnp.zeros(z1.shape, jnp.float32),
        jnp.zeros(z1.shape, jnp.float32),
    )
    (best, bu, bv), _ = jax.lax.scan(body, init, offs)
    return bu, bv, best


def _search_subpatch(g1: jnp.ndarray, g2: jnp.ndarray, radius: int,
                     patch: int, budget_div: int = 1):
    """DeepMatching-style split-and-rescore coarse search.

    Rigid patch NCC collapses once the deformation WITHIN a patch reaches a
    few pixels — exactly the regime DeepMatching's correlation quadtree is
    built for (the reference's matcher contract, para_gen.py:227-240). This
    is one recursion level of DM's bottom-up aggregation:

      child(o, p)  = ZNCC of the half-size (k/2) sub-patch at p, offset o
      relax(o, p)  = max over |o'−o|∞ ≤ 1 of child(o', p)     (rescore: each
                     sub-patch may deviate ±1 offset from rigid placement)
      parent(o, p) = ¼ Σ_{δ ∈ {±k/4}²} relax(o, p+δ)          (split: the four
                     child centers)

    Takes RAW (un-normalized) planes — children are z-scored at their own
    k/2 scale so each child score is a true ZNCC. Same contract as
    `_search`: returns (du, dv, score) planes, first-max raster-order
    tie-breaking over the offset sweep.

    Materialises the full (side², H, W) child-correlation stack to max-pool
    over OFFSET space, so it is restricted to coarse pyramid levels: if the
    stack exceeds the vectorized-search budget it falls back to the rigid
    search (graceful — identical API, no silent precision cliff: the rigid
    search is the production default anyway).
    """
    kc = max(2, patch // 2)
    h = max(1, kc // 2)  # child-center offset from the parent center
    n = float(kc * kc)
    H, W = g1.shape
    side = 2 * radius + 1
    n_off = side * side
    # budget_div: vmapped hypothesis lanes materialise their child stacks
    # CONCURRENTLY — each lane only gets 1/K of the vectorization budget
    # (same rule as _search's budget_div; OOM otherwise). Extra /3: this
    # path holds several (n_off, H, W) stacks live at once (shifts, child,
    # -inf-padded copy, relax, h-padded relax, parent) vs ~2 for the rigid
    # vectorized search, so the shared budget under-bounds peak memory here
    if n_off * H * W > _SEARCH_VEC_BUDGET // (3 * max(1, budget_div)):
        zz = _zscore(jnp.stack([g1, g2]), patch)
        return _search(zz[0], zz[1], radius, patch,
                       budget_div=budget_div)
    zz = _zscore(jnp.stack([g1, g2]), kc)
    z1, z2 = zz[0], zz[1]
    z2p = jnp.pad(z2, radius)
    dys, dxs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    dy = jnp.asarray(dys.ravel() + radius, jnp.int32)
    dx = jnp.asarray(dxs.ravel() + radius, jnp.int32)
    rows = dy[:, None, None] + jnp.arange(H, dtype=jnp.int32)[None, :, None]
    cols = dx[:, None, None] + jnp.arange(W, dtype=jnp.int32)[None, None, :]
    shifts = z2p[rows, cols]  # (n_off, H, W)
    child = (_box_sum(z1[None] * shifts, kc) / n).reshape(side, side, H, W)
    # rescore: 3×3 max-pool over the offset grid (−inf padding keeps border
    # offsets honest — they only see real neighbors)
    cp = jnp.pad(child, ((1, 1), (1, 1), (0, 0), (0, 0)),
                 constant_values=-jnp.inf)
    relax = child
    for oy in range(3):
        for ox in range(3):
            if oy == 1 and ox == 1:
                continue
            relax = jnp.maximum(relax, cp[oy : oy + side, ox : ox + side])
    # split: average the four children at p ± h (zero padding: a child
    # centered off-plane contributes 0 — border cells are score-damped, and
    # the downstream in-frame/score filters own that region anyway)
    rp = jnp.pad(relax, ((0, 0), (0, 0), (h, h), (h, h)))
    parent = 0.25 * (
        rp[:, :, 0:H, 0:W]
        + rp[:, :, 0:H, 2 * h : 2 * h + W]
        + rp[:, :, 2 * h : 2 * h + H, 0:W]
        + rp[:, :, 2 * h : 2 * h + H, 2 * h : 2 * h + W]
    ).reshape(n_off, H, W)
    best_idx = jnp.argmax(parent, axis=0)  # first max wins, raster order
    best = jnp.take_along_axis(parent, best_idx[None], axis=0)[0]
    bu = jnp.asarray(dxs.ravel(), jnp.float32)[best_idx]
    bv = jnp.asarray(dys.ravel(), jnp.float32)[best_idx]
    return bu, bv, best


def _grid(H: int, W: int):
    gx = jnp.arange(W, dtype=jnp.float32)[None, :] * jnp.ones((H, 1), jnp.float32)
    gy = jnp.arange(H, dtype=jnp.float32)[:, None] * jnp.ones((1, W), jnp.float32)
    return gx, gy


def _pyramid_flow_impl(
    g1: jnp.ndarray,
    g2: jnp.ndarray,
    radius: int = 100,
    patch: int = 12,
    levels: int = 3,
    refine_radius: int = 2,
    rotations: tuple = (0.0,),
    refine_passes: int = 1,
    subpatch: bool = False,
    lanes: int = 1,
):
    """Dense coarse-to-fine NCC flow estimate (trace-level implementation).

    g1, g2: (H, W) float32 grayscale. Returns (flow (2, H, W), score (H, W)).

    `rotations`: static tuple of coarse-level hypotheses — either angles θ
    (radians) or affine triples (θ, sx, sy) mixing rotation with anisotropic
    scale (the DeepMatching-style tolerance to local STRETCH: ~50% local
    stretch destroys rigid-shift patch NCC, but a scaled resample restores
    correlation wherever the warp is locally ≈ affine; the per-level
    warp-and-refine then tracks the seeded field exactly). For each
    hypothesis M = R_θ·diag(sx, sy), image 2 is resampled as
    im2(M(q−c)+c) and searched; where that hypothesis wins on NCC score,
    the seeded target becomes t(p) = M(p + d − c) + c. Runs at the coarsest
    level only: K hypotheses cost K tiny batched searches.

    `subpatch`: run the coarse search with DeepMatching-style split-and-
    rescore (`_search_subpatch`) instead of rigid patch NCC — tolerant to
    spatially-varying deformation WITHIN a patch, beyond what the (global)
    affine hypotheses cover. Composes with `rotations`.

    `lanes`: number of OUTER concurrent vmap lanes this trace runs under
    (bidirectional = 2, multi-pair = 2·B). The coarse XLA search's
    vectorization budget divides by lanes × hypothesis count — every lane
    materialises its own (n_off, Hc, Wc) stack concurrently, so dividing by
    the hypothesis count alone under-bounds memory by the lane factor.
    """
    # both pyramids in one batched op-set (stacking halves the op count)
    pyr = [jnp.stack([g1, g2])]
    for _ in range(levels):
        pyr.append(_avg_pool2(pyr[-1]))
    pyr1 = [p[0] for p in pyr]
    pyr2 = [p[1] for p in pyr]

    coarse_r = max(2, int(np.ceil(radius / (2 ** levels))))
    Hc, Wc = pyr1[-1].shape
    if not subpatch:
        z1 = _zscore(pyr1[-1], patch)
    ccy, ccx = (Hc - 1) / 2.0, (Wc - 1) / 2.0
    gxc, gyc = _grid(Hc, Wc)

    # normalize hypotheses to affine triples (θ, sx, sy); plain angles keep
    # the historical rotation-only form
    hyps = tuple(
        (float(h), 1.0, 1.0) if np.isscalar(h) else
        (float(h[0]), float(h[1]), float(h[2]))
        for h in rotations
    )
    # ALL hypotheses in one batched op-set instead of a per-hypothesis
    # unroll (resample + zscore + search each). The sampling positions are
    # static — one gather builds the whole
    # (K, Hc, Wc) stack — and vmap keeps the search at a constant op count
    # regardless of K. M = R_θ·S: m = [[ca·sx, −sa·sy], [sa·sx, ca·sy]].
    Ms = np.array(
        [
            [
                [np.cos(th) * sx, -np.sin(th) * sy],
                [np.sin(th) * sx, np.cos(th) * sy],
            ]
            for th, sx, sy in hyps
        ]
    )
    gx_np, gy_np = np.meshgrid(np.arange(Wc, dtype=np.float64),
                               np.arange(Hc, dtype=np.float64))
    qx = np.stack([
        m[0, 0] * (gx_np - ccx) + m[0, 1] * (gy_np - ccy) + ccx for m in Ms
    ])
    qy = np.stack([
        m[1, 0] * (gx_np - ccx) + m[1, 1] * (gy_np - ccy) + ccy for m in Ms
    ])
    g2r = _bilinear(pyr2[-1], jnp.asarray(qx, jnp.float32),
                    jnp.asarray(qy, jnp.float32))  # (K, Hc, Wc)
    if subpatch:
        # split-and-rescore needs the materialised offset stack (the rescore
        # max-pools over OFFSET space); coarse levels are small and this
        # mode is the hard-deformation opt-in
        du, dv, sc = jax.vmap(
            lambda g: _search_subpatch(pyr1[-1], g, coarse_r, patch,
                                       budget_div=len(Ms) * max(1, lanes))
        )(g2r)
    else:
        z2 = _zscore(g2r, patch)
        # the vectorized search materialises (n_off, Hc, Wc) PER hypothesis
        # under vmap — divide its budget by K or large banks OOM on frames
        # whose level clamp leaves a big coarse level
        du, dv, sc = jax.vmap(
            lambda z: _search(z1, z, coarse_r, patch,
                              budget_div=len(hyps) * max(1, lanes))
        )(z2)
    # fold each hypothesis back into image-2 coordinates:
    # t(p) = M((p + d) − c) + c (identity reduces to p + d exactly)
    m00 = jnp.asarray(Ms[:, 0, 0], jnp.float32)[:, None, None]
    m01 = jnp.asarray(Ms[:, 0, 1], jnp.float32)[:, None, None]
    m10 = jnp.asarray(Ms[:, 1, 0], jnp.float32)[:, None, None]
    m11 = jnp.asarray(Ms[:, 1, 1], jnp.float32)[:, None, None]
    px = gxc[None] + du
    py = gyc[None] + dv
    ur_all = m00 * (px - ccx) + m01 * (py - ccy) + ccx - gxc[None]
    vr_all = m10 * (px - ccx) + m11 * (py - ccy) + ccy - gyc[None]
    # sequential hypothesis fold (tiny per-plane ops): a non-identity
    # hypothesis must beat the incumbent by a clear NCC margin — resampling
    # can spuriously edge out identity on low-texture patches (near-tie
    # scores), which measurably biases flow on weakly textured frames. Ties
    # go to the earlier (by convention identity-first) hypothesis.
    u, v, score = ur_all[0], vr_all[0], sc[0]
    for r, (theta, sx_, sy_) in enumerate(hyps):
        if r == 0:
            continue
        ident = theta == 0.0 and sx_ == 1.0 and sy_ == 1.0
        take = sc[r] > score + (0.0 if ident else 0.1)
        u = jnp.where(take, ur_all[r], u)
        v = jnp.where(take, vr_all[r], v)
        score = jnp.where(take, sc[r], score)

    uv = jnp.stack([u, v])
    for lvl in range(levels - 1, -1, -1):
        H, W = pyr1[lvl].shape
        # upsample flow ×2 (values double); u/v stay stacked — one op-set
        uv = jnp.repeat(jnp.repeat(uv, 2, -2), 2, -1)[:, :H, :W] * 2.0
        if uv.shape[-2:] != (H, W):
            uv = jnp.pad(
                uv,
                ((0, 0), (0, H - uv.shape[-2]), (0, W - uv.shape[-1])),
                mode="edge",
            )
        if refine_passes == 0:
            # no refine search will overwrite `score` at this level — carry
            # the coarse NCC confidence up alongside the flow, or the return
            # pair is shape-inconsistent (full-res uv, coarse score) and
            # consumers like _device_grid_select mis-index it
            score = jnp.repeat(jnp.repeat(score, 2, -2), 2, -1)[:H, :W]
            if score.shape != (H, W):
                score = jnp.pad(
                    score,
                    ((0, H - score.shape[0]), (0, W - score.shape[1])),
                    mode="edge",
                )
        gx, gy = _grid(H, W)
        # iterated warp-and-search: when the upsampled estimate is off by
        # more than refine_radius (large non-rigid deformation), each pass
        # re-warps at the improved estimate and recovers another
        # ±refine_radius — cheap (the search window is tiny) and measurably
        # tightens large-warp matching
        for _ in range(refine_passes):
            w2 = _bilinear(pyr2[lvl], gx + uv[0], gy + uv[1])
            # z-score the reference and warped planes in one op-set
            zz = _zscore(jnp.stack([pyr1[lvl], w2]), patch)
            du, dv, score = _search(zz[0], zz[1], refine_radius, patch)
            uv = uv + jnp.stack([du, dv])

    return uv, score


@partial(jax.jit, static_argnames=("radius", "patch", "levels",
                                   "refine_radius", "rotations",
                                   "refine_passes", "subpatch"))
def pyramid_flow(g1, g2, radius: int = 100, patch: int = 12, levels: int = 3,
                 refine_radius: int = 2, rotations: tuple = (0.0,),
                 refine_passes: int = 1, subpatch: bool = False):
    return _pyramid_flow_impl(g1, g2, radius, patch, levels, refine_radius,
                              rotations, refine_passes, subpatch)


@partial(jax.jit, static_argnames=("radius", "patch", "levels",
                                   "refine_radius", "rotations",
                                   "refine_passes", "subpatch"))
def pyramid_flow_bidir(g1, g2, radius: int = 100, patch: int = 12,
                       levels: int = 3, refine_radius: int = 2,
                       rotations: tuple = (0.0,), refine_passes: int = 1,
                       subpatch: bool = False):
    """Forward and backward flow in ONE compiled program (vmapped pair) —
    halves matcher compiles and dispatches. `rotations` must be a symmetric
    set (the backward direction sees the inverse rotation)."""
    a = jnp.stack([g1, g2])
    b = jnp.stack([g2, g1])
    return jax.vmap(
        lambda x, y: _pyramid_flow_impl(x, y, radius, patch, levels,
                                        refine_radius, rotations,
                                        refine_passes, subpatch, lanes=2)
    )(a, b)


# default rotation-hypothesis set: ±15°/±30° coarse seeds, symmetric
DEFAULT_ROTATIONS = (0.0, 0.2618, -0.2618, 0.5236, -0.5236)

# extended hypothesis bank for extreme-deformation matching (cat512-class
# warps, scripts/stretch_ladder.py): rotations + isotropic and anisotropic
# scale seeds covering ~±50% local stretch. Inverse-closed (1/1.5 = 0.667),
# so pyramid_flow_bidir's backward pass sees the matching inverses. ~3× the
# coarse-search cost of DEFAULT_ROTATIONS — opt-in, not the pipeline default
# (fd 1-5 video + the dist<60 filter never needs it).
STRETCH_HYPOTHESES = DEFAULT_ROTATIONS + (
    (0.0, 1.25, 1.25), (0.0, 0.8, 0.8),
    (0.0, 1.5, 1.5), (0.0, 0.667, 0.667),
    (0.0, 1.4, 1.0), (0.0, 0.714, 1.0),
    (0.0, 1.0, 1.4), (0.0, 1.0, 0.714),
)


def _device_grid_select(fwd, bwd, score, stride: int):
    """Stride-grid subsample + forward-backward error ON DEVICE.

    The host selection only ever reads the stride grid, while the dense
    fields are ~15 MB/pair at 854×480. Returns (u, v, score, fb_err) as
    (gh, gw) planes: ~30× less D2H."""
    H, W = score.shape
    s2 = stride // 2
    u = fwd[0, s2::stride, s2::stride]
    v = fwd[1, s2::stride, s2::stride]
    sg = score[s2::stride, s2::stride]
    xs = jnp.arange(s2, W, stride, dtype=jnp.float32)[None, :]
    ys = jnp.arange(s2, H, stride, dtype=jnp.float32)[:, None]
    xt = jnp.clip(jnp.round(xs + u), 0, W - 1).astype(jnp.int32)
    yt = jnp.clip(jnp.round(ys + v), 0, H - 1).astype(jnp.int32)
    bu = bwd[0][yt, xt]
    bv = bwd[1][yt, xt]
    fb = jnp.hypot(u + bu, v + bv)
    return u, v, sg, fb


def _match_grid_impl(rgb1, rgb2, stride, radius, patch, levels,
                     refine_radius, rotations, refine_passes, downscale,
                     subpatch=False, lanes=2):
    g1, g2 = to_gray(rgb1.astype(jnp.float32)), to_gray(rgb2.astype(jnp.float32))
    a = jnp.stack([g1, g2])
    b = jnp.stack([g2, g1])
    ds = downscale
    while ds > 1:
        a = _avg_pool2(a)
        b = _avg_pool2(b)
        ds //= 2
    flows, scores = jax.vmap(
        lambda x, y: _pyramid_flow_impl(x, y, radius, patch, levels,
                                        refine_radius, rotations,
                                        refine_passes, subpatch, lanes=lanes)
    )(a, b)
    return _device_grid_select(flows[0], flows[1], scores[0], stride)


@partial(jax.jit, static_argnames=("radius", "patch", "levels",
                                   "refine_radius", "rotations",
                                   "refine_passes", "subpatch", "stride", "downscale"))
def match_grid(rgb1, rgb2, stride: int = 4, radius: int = 100,
               patch: int = 12, levels: int = 3, refine_radius: int = 2,
               rotations: tuple = DEFAULT_ROTATIONS, refine_passes: int = 1,
               downscale: int = 1, subpatch: bool = False):
    """Bidirectional pyramid matching + device-side grid selection in ONE
    compiled program; returns (u, v, score, fb_err) stride-grid planes.

    Accepts uint8 RGB (cast on device): frame uploads are 4× smaller.

    `downscale` (power of 2): the whole match runs on a 2×2-average-pooled
    image — radius/stride/patch/levels and the RETURNED planes are all in
    DOWNSAMPLED units (callers scale displacements back). Halves the
    dominant finest-level refine cost ~4×; precision loss is bounded by the
    downsample factor and checked by the pipeline flow-accuracy gate."""
    return _match_grid_impl(rgb1, rgb2, stride, radius, patch, levels,
                            refine_radius, rotations, refine_passes,
                            downscale, subpatch)


@partial(jax.jit, static_argnames=("radius", "patch", "levels",
                                   "refine_radius", "rotations",
                                   "refine_passes", "subpatch", "stride", "downscale"))
def match_grid_multi(rgb1s, rgb2s, stride: int = 4, radius: int = 100,
                     patch: int = 12, levels: int = 3, refine_radius: int = 2,
                     rotations: tuple = DEFAULT_ROTATIONS,
                     refine_passes: int = 1, downscale: int = 1,
                     subpatch: bool = False):
    """match_grid vmapped over a (B, 3, H, W) pair stack in ONE program
    (one dispatch and one compile for B same-shaped pairs). The vectorized
    search materialises per-pair offset stacks, so its budget divides by
    the vmap lanes. Its speed against per-pair programs is not yet measured
    on the GPU."""
    n_pairs = int(rgb1s.shape[0])  # static at trace time
    return jax.vmap(
        lambda a, b: _match_grid_impl(a, b, stride, radius, patch, levels,
                                      refine_radius, rotations,
                                      refine_passes, downscale, subpatch,
                                      lanes=2 * n_pairs)
    )(rgb1s, rgb2s)


@partial(jax.jit, static_argnames=("radius", "patch", "levels",
                                   "refine_radius", "rotations",
                                   "refine_passes", "subpatch"))
def match_fields(rgb1, rgb2, radius: int = 100, patch: int = 12,
                 levels: int = 3, refine_radius: int = 2,
                 rotations: tuple = DEFAULT_ROTATIONS,
                 refine_passes: int = 1, subpatch: bool = False):
    """Gray conversion + bidirectional pyramid flow in one program.

    Takes (3, H, W) float32 RGB directly off the host (fresh host uploads
    keep default layouts, so the executable's fingerprint is stable)."""
    g1, g2 = to_gray(rgb1), to_gray(rgb2)
    return pyramid_flow_bidir(g1, g2, radius=radius, patch=patch,
                              levels=levels, refine_radius=refine_radius,
                              rotations=rotations,
                              refine_passes=refine_passes, subpatch=subpatch)


def match_images_batched(
    pairs: list,
    radius: int = 100,
    stride: int = 4,
    patch: int = 12,
    levels: int = 3,
    fb_threshold: float = 1.5,
    score_threshold: float = 0.3,
    rotations: tuple = None,
    refine_passes: int = 1,
    subpatch: bool = False,
) -> list:
    """Matching over many (rgb1, rgb2) pairs: a thin sequential loop kept
    for API parity with the reference's batch drivers. Returns a list of
    (N_i, 5) match arrays, same contract as match_images.

    NOTE: the production multi-pair path is match_images_dispatch_multi /
    match_grid_multi (one vmapped program per MATCH_SUBBATCH same-shaped
    pairs). Prefer the dispatch API for throughput work."""
    return [
        match_images(r1, r2, radius=radius, stride=stride, patch=patch,
                     levels=levels, fb_threshold=fb_threshold,
                     score_threshold=score_threshold, rotations=rotations,
                     refine_passes=refine_passes, subpatch=subpatch)
        for r1, r2 in pairs
    ]


def _coherence_keep(keep_grid, u_grid, v_grid, tol=4.0, rel=0.2, rad=3,
                    min_nbrs=3):
    """Local-coherence outlier rejection on the stride grid.

    ARAP motion is locally near-rigid by construction, so a match whose
    displacement deviates from its neighborhood median by more than
    tol + rel·|median| is matcher noise (DeepMatching performs equivalent
    pruning inside its correlation pyramid). Measured on the cat512 golden
    warp: max match error 99.5 px -> 6.6 px at unchanged median. Vectorised:
    the neighborhood is the (2·rad+1)² grid window; cells with fewer than
    min_nbrs valid neighbors are kept (nothing to judge against).
    """
    gh, gw = keep_grid.shape
    uu = np.where(keep_grid, u_grid, np.nan)
    vv = np.where(keep_grid, v_grid, np.nan)
    stacks_u, stacks_v = [], []
    pad_u = np.pad(uu, rad, constant_values=np.nan)
    pad_v = np.pad(vv, rad, constant_values=np.nan)
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            if dy == 0 and dx == 0:
                continue
            stacks_u.append(pad_u[rad + dy : rad + dy + gh,
                                  rad + dx : rad + dx + gw])
            stacks_v.append(pad_v[rad + dy : rad + dy + gh,
                                  rad + dx : rad + dx + gw])
    su = np.stack(stacks_u)
    sv = np.stack(stacks_v)
    nbrs = np.isfinite(su).sum(0)
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN windows
        med_u = np.nanmedian(su, axis=0)
        med_v = np.nanmedian(sv, axis=0)
    dev = np.hypot(uu - med_u, vv - med_v)
    lim = tol + rel * np.hypot(med_u, med_v)
    ok = (nbrs < min_nbrs) | (dev <= lim)  # dev<=lim is False on NaN
    return keep_grid & ok


def _knn_coherence(xs, ys, u, v, keep, k=6, tol=4.0, rel=0.2):
    """Exact k-nearest-neighbor coherence pass for sparse match sets (same
    deviation rule as _coherence_keep). O(n²) on the kept set — used only
    when n ≤ 4000."""
    idx = np.where(keep)[0]
    n = len(idx)
    if n <= k:
        return keep
    sx, sy = xs[idx].astype(np.float64), ys[idx].astype(np.float64)
    du, dv = u[idx], v[idx]
    d2 = (sx[:, None] - sx[None, :]) ** 2 + (sy[:, None] - sy[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    nbr = np.argpartition(d2, k, axis=1)[:, :k]
    med_u = np.median(du[nbr], axis=1)
    med_v = np.median(dv[nbr], axis=1)
    dev = np.hypot(du - med_u, dv - med_v)
    ok = dev <= tol + rel * np.hypot(med_u, med_v)
    out = keep.copy()
    out[idx[~ok]] = False
    return out


def _select_from_grids(u, v, sc, fb_err, H, W, stride, fb_threshold,
                       score_threshold, radius, coherence: bool = True,
                       off: int | None = None, step: int | None = None,
                       roi=None):
    """Host selection from stride-grid planes (gh, gw): thresholds, then two
    local-coherence passes (the median stabilises after the first cleanup).
    `off`/`step` override the grid-plane → full-res coordinate mapping
    (x = off + col·step; defaults reproduce the stride grid) — used by the
    downscaled matching path."""
    gh, gw = u.shape
    if off is None:
        off = stride // 2
    if step is None:
        step = stride
    ys, xs = np.mgrid[0:gh, 0:gw]
    ys = (ys * step + off).ravel()
    xs = (xs * step + off).ravel()
    u, v, sc, fb_err = (a.ravel() for a in (u, v, sc, fb_err))
    x2 = xs + u
    y2 = ys + v
    keep = (
        (fb_err < fb_threshold)
        & (sc >= score_threshold)
        & (x2 >= 0) & (x2 < W) & (y2 >= 0) & (y2 < H)
        & (np.hypot(u, v) <= radius)
    )
    if roi is not None:
        # restrict to grid points on the caller's region of interest (the
        # pipeline's segment mask): the downstream filter drops off-object
        # matches anyway (para_gen.py:216-223), and the coherence pass below
        # is O(points) host work — frame-wide selection makes it a prep
        # bottleneck at 25k grid points
        keep &= np.asarray(roi)[ys, xs] != 0
    if coherence:
        if keep.sum() <= 4000:
            # sparse set (weakly textured / hard pair): exact k-nearest
            # medians — a fixed grid window around an isolated match holds
            # too few neighbors to judge it
            for _ in range(2):
                keep = _knn_coherence(xs, ys, u, v, keep)
        else:
            kg = keep.reshape(gh, gw)
            ug = u.reshape(gh, gw)
            vg = v.reshape(gh, gw)
            for _ in range(2):
                kg = _coherence_keep(kg, ug, vg)
            keep = kg.ravel()
    return np.stack(
        [xs[keep], ys[keep], np.round(x2[keep]), np.round(y2[keep]), sc[keep]],
        axis=1,
    ).astype(np.float32)


def _select_matches(fwd, bwd, score, H, W, stride, fb_threshold,
                    score_threshold, radius, coherence: bool = True):
    """Full-field host selection (numpy inputs); production paths use
    match_grid + _select_from_grids to avoid fetching dense fields."""
    s2 = stride // 2
    u = fwd[0, s2::stride, s2::stride]
    v = fwd[1, s2::stride, s2::stride]
    sc = score[s2::stride, s2::stride]
    gh, gw = u.shape
    xs = np.arange(s2, W, stride, dtype=np.float64)[None, :]
    ys = np.arange(s2, H, stride, dtype=np.float64)[:, None]
    xt = np.clip(np.round(xs + u).astype(int), 0, W - 1)
    yt = np.clip(np.round(ys + v).astype(int), 0, H - 1)
    fb_err = np.hypot(u + bwd[0][yt, xt], v + bwd[1][yt, xt])
    return _select_from_grids(u, v, sc, fb_err, H, W, stride, fb_threshold,
                              score_threshold, radius, coherence)


def clamp_match_params(
    H: int, W: int, radius: int = 100, patch: int = 12, levels: int = 3
) -> tuple[int, int]:
    """Frame-size clamps applied before every match_grid call: keep the
    coarsest pyramid level at least ~3 patches across and the search radius
    within the frame. Shared with the pipeline prewarm so the warmed program
    is the one actually executed. Returns (radius, levels)."""
    min_dim = min(H, W)
    levels = max(0, min(levels, int(np.floor(np.log2(min_dim / (3 * patch))))))
    return min(radius, min_dim), levels


def match_images(
    rgb1: np.ndarray,
    rgb2: np.ndarray,
    radius: int = 100,
    stride: int = 4,
    patch: int = 12,
    levels: int = 3,
    fb_threshold: float = 1.5,
    score_threshold: float = 0.3,
    rotations: tuple = None,
    refine_passes: int = 1,
    downscale: int = 1,
    roi_mask=None,
    subpatch: bool = False,
) -> np.ndarray:
    """Sparse matches between two (H, W, 3) uint8 images.

    Returns (N, 5) float32 rows ``x1 y1 x2 y2 score`` on a stride grid, kept
    where forward-backward consistency < fb_threshold px and NCC ≥
    score_threshold (the reciprocal-verification analogue of DeepMatching's
    correlation-score pruning). Displacements are bounded by `radius`
    (≙ -ngh_rad 100, para_gen.py:234).

    `downscale` (power of 2): run the whole match on a pooled image —
    ~4×/octave cheaper on the dominant finest-level refine; output grid
    density is preserved (the grid stride shrinks with the image) and
    displacements are scaled back to full-res px. The fb threshold scales
    with the factor (a half-res matcher is inherently ~2× less precise).
    """
    handle = match_images_dispatch(
        rgb1, rgb2, radius=radius, stride=stride, patch=patch, levels=levels,
        rotations=rotations, refine_passes=refine_passes, downscale=downscale,
        subpatch=subpatch,
    )
    return match_images_fetch(handle, fb_threshold=fb_threshold,
                              score_threshold=score_threshold,
                              roi_mask=roi_mask)


def match_images_dispatch(
    rgb1, rgb2, radius: int = 100, stride: int = 4, patch: int = 12,
    levels: int = 3, rotations: tuple = None, refine_passes: int = 1,
    downscale: int = 1, subpatch: bool = False,
):
    """Async half of match_images: uploads + dispatches the device matcher
    and returns a handle (device grid planes + geometry). Pipelines: dispatch
    matching for MANY pairs back-to-back, then fetch (match_images_fetch) —
    the device runs the matcher programs without host-fetch gaps between
    them, and fetches overlap later pairs' device time."""
    j1 = jnp.asarray(np.ascontiguousarray(rgb1.transpose(2, 0, 1)))
    j2 = jnp.asarray(np.ascontiguousarray(rgb2.transpose(2, 0, 1)))
    H_, W_ = rgb1.shape[:2]
    ds = max(1, int(downscale))
    stride_d = max(1, stride // ds)
    rad_d, levels = clamp_match_params(
        H_ // ds, W_ // ds, int(np.ceil(radius / ds)), patch, levels
    )
    if rotations is None:
        rotations = DEFAULT_ROTATIONS
    grids = match_grid(j1, j2, stride=stride_d, radius=rad_d,
                       patch=patch, levels=levels, rotations=rotations,
                       refine_passes=refine_passes, downscale=ds,
                       subpatch=subpatch)
    return (grids, H_, W_, stride, stride_d, ds, radius)


class _SlicedGrids:
    """One pair's view into a multi-pair match_grid_multi result: the
    batched planes are fetched ONCE (four D2H transfers for the whole
    sub-batch) and numpy-sliced per pair."""

    def __init__(self, batched_grids, i: int):
        self._batched = batched_grids  # shared across the sub-batch's views
        self._i = i

    def fetch(self):
        b = self._batched
        if not isinstance(b[0], np.ndarray):
            b = tuple(np.asarray(a) for a in b)
            self._batched = b
        return tuple(a[self._i] for a in b)


def match_images_dispatch_multi(
    rgb_pairs: list, radius: int = 100, stride: int = 4, patch: int = 12,
    levels: int = 3, rotations: tuple = None, refine_passes: int = 1,
    downscale: int = 1, subpatch: bool = False,
) -> list:
    """Multi-pair async dispatch: ONE vmapped matcher program for a stack of
    same-shaped (rgb1, rgb2) uint8 pairs (amortises the per-executed-op
    fixed cost — see match_grid_multi). Returns one match_images_fetch-
    compatible handle per pair; the batched D2H happens on the first fetch
    and is shared by all of them."""
    H_, W_ = rgb_pairs[0][0].shape[:2]
    r1 = np.stack([np.ascontiguousarray(a.transpose(2, 0, 1))
                   for a, _ in rgb_pairs])
    r2 = np.stack([np.ascontiguousarray(b.transpose(2, 0, 1))
                   for _, b in rgb_pairs])
    ds = max(1, int(downscale))
    stride_d = max(1, stride // ds)
    rad_d, levels = clamp_match_params(
        H_ // ds, W_ // ds, int(np.ceil(radius / ds)), patch, levels
    )
    if rotations is None:
        rotations = DEFAULT_ROTATIONS
    grids = match_grid_multi(
        jnp.asarray(r1), jnp.asarray(r2), stride=stride_d, radius=rad_d,
        patch=patch, levels=levels, rotations=rotations,
        refine_passes=refine_passes, downscale=ds, subpatch=subpatch,
    )
    return [
        (_SlicedGrids(grids, i), H_, W_, stride, stride_d, ds, radius)
        for i in range(len(rgb_pairs))
    ]


def match_images_fetch(handle, fb_threshold: float = 1.5,
                       score_threshold: float = 0.3,
                       roi_mask=None) -> np.ndarray:
    """Blocking half of match_images: D2H the grid planes + host selection.

    roi_mask (optional (H, W), nonzero = of interest): restrict selection to
    grid points on it before the coherence passes."""
    import os as _os
    import time as _time

    g, H_, W_, stride, stride_d, ds, radius = handle
    _t0 = _time.time()
    if isinstance(g, _SlicedGrids):
        u, v, sg, fb = g.fetch()
    else:
        u, v, sg, fb = (np.asarray(a) for a in g)
    if _os.environ.get("ARAP_PROFILE"):
        print(f"  [match] d2h+select {_time.time() - _t0:.2f}s (ds={ds})",
              flush=True)
    return _select_from_grids(
        u * ds, v * ds, sg, fb * ds, H_, W_, stride,
        fb_threshold * ds, score_threshold, radius,
        off=ds * (stride_d // 2), step=ds * stride_d, roi=roi_mask,
    )


def write_matches(path, matches: np.ndarray) -> None:
    """Write DM-format match lines ``x1 y1 x2 y2 score`` (the matcher-output
    contract consumed by para_gen.py:468-479)."""
    with open(path, "w") as f:
        for row in matches:
            f.write(
                f"{int(row[0])} {int(row[1])} {int(row[2])} {int(row[3])} "
                f"{row[4]:.4f}\n"
            )

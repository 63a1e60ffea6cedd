"""Matcher tests: the NCC-pyramid matcher must recover known synthetic motions
and produce constraint tuples that survive the pipeline filter."""

import numpy as np

from arap_flow.io.constraints import filter_matches
from arap_flow.ops.matching import match_images


def _texture(H, W, seed=0):
    """Smooth random texture with enough structure for patch matching."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((H // 4 + 2, W // 4 + 2))
    up = np.kron(base, np.ones((4, 4)))[:H, :W]
    fine = rng.standard_normal((H, W)) * 0.3
    g = up + fine
    g = (g - g.min()) / (np.ptp(g) + 1e-9) * 255
    return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)


def test_recovers_translation():
    H, W = 96, 128
    im1 = _texture(H, W)
    dx, dy = 7, -4
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    m = match_images(im1, im2, radius=16, levels=2, stride=4)
    assert len(m) > 100
    u = m[:, 2] - m[:, 0]
    v = m[:, 3] - m[:, 1]
    # majority of matches recover the shift (<=0.5: an even match count can
    # put an exact-equality median between two integer displacements)
    assert abs(np.median(u) - dx) <= 0.5 and abs(np.median(v) - dy) <= 0.5
    good = (np.abs(u - dx) <= 1) & (np.abs(v - dy) <= 1)
    assert good.mean() > 0.8, good.mean()


def test_zero_motion():
    H, W = 64, 96
    im1 = _texture(H, W, seed=3)
    m = match_images(im1, im1, radius=8, levels=2, stride=4)
    assert len(m) > 100
    u = m[:, 2] - m[:, 0]
    v = m[:, 3] - m[:, 1]
    assert np.abs(u).max() <= 1 and np.abs(v).max() <= 1


def _warp_bilinear(im: np.ndarray, mapx: np.ndarray, mapy: np.ndarray):
    """im2[y, x] = im1[mapy, mapx] (inverse map, bilinear, edge clamp)."""
    H, W = im.shape[:2]
    x0 = np.clip(np.floor(mapx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(mapy).astype(int), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = np.clip(mapx - x0, 0, 1)[..., None]
    fy = np.clip(mapy - y0, 0, 1)[..., None]
    out = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    return out.astype(im.dtype)


def _check_recovery(im1, fwd_x, fwd_y, inv_x, inv_y, radius, levels,
                    med_tol=1.5, frac_tol=0.6, margin=12):
    """Warp im1 by the given maps, match, and compare recovered displacement
    to ground truth away from the borders."""
    H, W = im1.shape[:2]
    im2 = _warp_bilinear(im1, inv_x, inv_y)
    m = match_images(im1, im2, radius=radius, levels=levels, stride=4)
    assert len(m) > 50
    x1 = m[:, 0].astype(int)
    y1 = m[:, 1].astype(int)
    interior = (
        (x1 >= margin) & (x1 < W - margin) & (y1 >= margin) & (y1 < H - margin)
    )
    m = m[interior]
    x1, y1 = m[:, 0].astype(int), m[:, 1].astype(int)
    gt_u = fwd_x[y1, x1] - x1
    gt_v = fwd_y[y1, x1] - y1
    err = np.hypot(m[:, 2] - m[:, 0] - gt_u, m[:, 3] - m[:, 1] - gt_v)
    assert np.median(err) < med_tol, np.median(err)
    assert (err < 2.0).mean() > frac_tol, (err < 2.0).mean()


def test_recovers_rotation():
    """5° rotation about center: displacements vary over the frame (up to
    ~7 px at the corners) — exercises the ±2/level refinement, not just the
    coarse translation search."""
    H, W = 128, 160
    im1 = _texture(H, W, seed=7)
    th = np.deg2rad(5.0)
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    # forward map (where each source pixel lands)
    fwd_x = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx
    fwd_y = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy
    # inverse map (to synthesize im2)
    inv_x = np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy) + cx
    inv_y = -np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy
    _check_recovery(im1, fwd_x, fwd_y, inv_x, inv_y, radius=16, levels=2)


def test_recovers_scale():
    """8% zoom about center (up to ~6 px displacement at the corners)."""
    H, W = 128, 160
    im1 = _texture(H, W, seed=8)
    s = 1.08
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd_x = s * (xx - cx) + cx
    fwd_y = s * (yy - cy) + cy
    inv_x = (xx - cx) / s + cx
    inv_y = (yy - cy) / s + cy
    _check_recovery(im1, fwd_x, fwd_y, inv_x, inv_y, radius=16, levels=2)


def test_recovers_nonrigid_warp():
    """Smooth sinusoidal non-rigid deformation (amplitude 3 px, wavelength
    ~45 px) — the DAVIS deformation regime the DM contract targets
    (para_gen.py:227-240)."""
    H, W = 128, 160
    im1 = _texture(H, W, seed=9)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    ux = 3.0 * np.sin(2 * np.pi * yy / 45.0)
    vy = 2.5 * np.cos(2 * np.pi * xx / 50.0)
    fwd_x = xx + ux
    fwd_y = yy + vy
    # inverse ≈ negative shift (amplitude ≪ wavelength, error O(amp²/λ) ≈ 0.1px)
    inv_x = xx - 3.0 * np.sin(2 * np.pi * yy / 45.0)
    inv_y = yy - 2.5 * np.cos(2 * np.pi * xx / 50.0)
    _check_recovery(im1, fwd_x, fwd_y, inv_x, inv_y, radius=16, levels=2)


def test_recovers_large_rotation_via_hypotheses():
    """25° rotation — between the ±15°/±30° coarse hypotheses. Without them
    the matcher collapses to ~30 wrong matches (measured: median error 30 px);
    the hypothesis search recovers a dense correct field (DeepMatching-like
    rotation tolerance, the DM contract of para_gen.py:227-240)."""
    H, W = 128, 160
    im1 = _texture(H, W, seed=10)
    th = np.deg2rad(25.0)
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    inv_x = np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy) + cx
    inv_y = -np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy
    im2 = _warp_bilinear(im1, inv_x, inv_y)
    m = match_images(im1, im2, radius=40, levels=2, stride=4)
    fwd_x = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx
    fwd_y = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy
    x1, y1 = m[:, 0].astype(int), m[:, 1].astype(int)
    err = np.hypot(m[:, 2] - x1 - (fwd_x[y1, x1] - x1),
                   m[:, 3] - y1 - (fwd_y[y1, x1] - y1))
    assert len(m) > 150, len(m)
    assert np.median(err) < 1.5, np.median(err)
    assert (err < 2.0).mean() > 0.7, (err < 2.0).mean()


def test_matches_feed_constraint_filter():
    """End-to-end contract: matcher tuples -> pipeline filter -> per-segment
    constraints (para_gen.py:466-479 flow)."""
    H, W = 96, 128
    im1 = _texture(H, W, seed=5)
    dx, dy = 5, 3
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    seg = np.zeros((H, W), np.uint8)
    seg[20:70, 30:100] = 2  # one object segment, id 2
    m = match_images(im1, im2, radius=16, levels=2, stride=4)
    kept, segs = filter_matches(m[:, :4].astype(np.int32), seg, seg)
    assert len(kept) > 20
    assert set(np.unique(segs)) == {2}
    # all kept displacements within the filter bound and nonzero
    d = np.hypot(kept[:, 2] - kept[:, 0], kept[:, 3] - kept[:, 1])
    assert (d > 0).all() and (d < 60).all()


def test_device_grid_select_matches_host_oracle():
    """match_images (device-side stride-grid selection, the production path)
    must reproduce the straightforward host computation over the dense
    fields (_select_matches) exactly."""
    import jax.numpy as jnp

    from arap_flow.ops.matching import (
        _select_matches, match_fields, match_images)

    # frame large enough that match_images' coarsest-level cap
    # (>=3 patches across) does not reduce the requested levels
    H, W = 192, 256
    im1 = _texture(H, W, seed=5)
    im2 = np.roll(np.roll(im1, 3, axis=0), -5, axis=1)
    got = match_images(im1, im2, radius=16, levels=2, stride=4)

    j1 = jnp.asarray(np.ascontiguousarray(im1.transpose(2, 0, 1)), jnp.float32)
    j2 = jnp.asarray(np.ascontiguousarray(im2.transpose(2, 0, 1)), jnp.float32)
    flows, scores = match_fields(j1, j2, radius=16, levels=2)
    want = _select_matches(
        np.asarray(flows[0]), np.asarray(flows[1]), np.asarray(scores[0]),
        H, W, 4, 1.5, 0.3, 16,
    )
    np.testing.assert_array_equal(got, want)


def test_failure_frontier_50pct_stretch():
    """Guard the documented matcher failure frontier (docs/PARITY.md): at
    ~50% local stretch the NCC patch correlation degrades — COVERAGE drops in
    the high-stretch regions, but the FB/score/coherence filters must keep
    the surviving matches accurate. If a matcher change moves this boundary
    (either way), this test says so."""
    H, W = 128, 256
    im1 = _texture(H, W, seed=11)
    lam, amp = 60.0, 0.5 * 60.0 / (2 * np.pi)  # peak local stretch = 50%
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd_x = xx + amp * np.sin(2 * np.pi * xx / lam)
    fwd_y = yy.copy()
    # invert x' = x + A sin(2πx/λ) by fixed point (contraction: |A·2π/λ|<1)
    inv_x = xx.copy()
    for _ in range(25):
        inv_x = xx - amp * np.sin(2 * np.pi * inv_x / lam)
    inv_y = yy.copy()
    im2 = _warp_bilinear(im1, inv_x, inv_y)
    m = match_images(im1, im2, radius=16, levels=2, stride=4)
    assert len(m) > 30
    margin = 12
    x1 = m[:, 0].astype(int)
    y1 = m[:, 1].astype(int)
    keep = (
        (x1 >= margin) & (x1 < W - margin) & (y1 >= margin) & (y1 < H - margin)
    )
    m, x1, y1 = m[keep], x1[keep], y1[keep]
    # survivors stay accurate (the filters do their job at the frontier)
    err = np.hypot(m[:, 2] - m[:, 0] - (fwd_x[y1, x1] - x1),
                   m[:, 3] - m[:, 1] - (fwd_y[y1, x1] - y1))
    assert np.median(err) < 2.5, np.median(err)
    # coverage drops where the local stretch is high (the documented failure
    # mode: |d fwd_x/dx - 1| near 0.5), relative to the low-stretch regions
    stretch = np.abs(amp * 2 * np.pi / lam * np.cos(2 * np.pi * xx / lam))
    interior = np.zeros((H, W), bool)
    interior[margin : H - margin, margin : W - margin] = True
    hi = (stretch > 0.35) & interior
    lo = (stretch < 0.15) & interior
    cov = np.zeros((H, W), bool)
    cov[y1, x1] = True
    cov_hi = cov[hi].mean()
    cov_lo = cov[lo].mean()
    assert cov_lo > 0.01, cov_lo          # benign regions stay matchable
    assert cov_hi < 0.8 * cov_lo, (cov_hi, cov_lo)  # the frontier is real


def test_stretch_hypotheses_extend_frontier():
    """A global 60% stretch — past the rigid-shift frontier (the round-5
    negative control showed a 40% stretch is already recovered by identity
    seeds + per-level warp-refine: 1.34 px median, so it demonstrated
    nothing): the affine hypothesis bank (STRETCH_HYPOTHESES) seeds a scaled
    resample and recovers the field — the DeepMatching-style deformation
    tolerance (split-and-rescore analogue) this matcher uses. The identity-
    only negative control below is what makes this a test OF the bank."""
    from arap_flow.ops.matching import STRETCH_HYPOTHESES

    H, W = 128, 192
    im1 = _texture(H, W, seed=13)
    s = 1.6
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd_x = s * (xx - cx) + cx
    fwd_y = s * (yy - cy) + cy
    inv_x = (xx - cx) / s + cx
    inv_y = (yy - cy) / s + cy
    im2 = _warp_bilinear(im1, inv_x, inv_y)

    def err_of(rotations):
        m = match_images(im1, im2, radius=48, levels=2, stride=4,
                         rotations=rotations)
        margin = 16
        x1 = m[:, 0].astype(int)
        y1 = m[:, 1].astype(int)
        keep = ((x1 >= margin) & (x1 < W - margin)
                & (y1 >= margin) & (y1 < H - margin))
        m, x1, y1 = m[keep], x1[keep], y1[keep]
        if len(m) < 10:
            return np.inf, len(m)
        err = np.hypot(m[:, 2] - m[:, 0] - (fwd_x[y1, x1] - x1),
                       m[:, 3] - m[:, 1] - (fwd_y[y1, x1] - y1))
        return float(np.median(err)), len(m)

    med_stretch, n_stretch = err_of(STRETCH_HYPOTHESES)
    assert n_stretch > 50, n_stretch
    assert med_stretch < 2.0, med_stretch
    # NEGATIVE CONTROL: without the stretch hypotheses (identity-only bank)
    # the 40% stretch must be measurably worse — otherwise this test cannot
    # tell whether STRETCH_HYPOTHESES are what recovers it (e.g. a dropped
    # rotations kwarg would pass silently)
    med_id, n_id = err_of((0.0,))
    assert med_id > 2.0 * med_stretch or n_id <= 50, (
        f"identity-only bank already matches the stretch "
        f"({med_id:.2f}px, n={n_id}) — the hypothesis bank adds nothing "
        "here; tighten the stretch or investigate"
    )


def test_downscaled_matching_recovers_translation():
    """downscale=2: matching runs on a pooled image; displacements come back
    in FULL-res px on a full-density grid, within the coarser precision."""
    H, W = 96, 128
    im1 = _texture(H, W)
    dx, dy = 10, -6
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    m = match_images(im1, im2, radius=24, levels=2, stride=4, downscale=2)
    assert len(m) > 100
    u = m[:, 2] - m[:, 0]
    v = m[:, 3] - m[:, 1]
    assert abs(np.median(u) - dx) <= 1 and abs(np.median(v) - dy) <= 1
    good = (np.abs(u - dx) <= 2) & (np.abs(v - dy) <= 2)
    assert good.mean() > 0.8, good.mean()
    # source coordinates live on the full-res grid
    assert m[:, 0].max() > W / 2 and m[:, 1].max() > H / 2


def test_multi_pair_dispatch_matches_per_pair():
    """match_images_dispatch_multi (ONE vmapped program per sub-batch) must
    produce the same matches as per-pair match_images: same math, batched
    through the program's leading axis."""
    from arap_flow.ops.matching import (match_images_dispatch_multi,
                                            match_images_fetch)

    H, W = 96, 128
    pairs = []
    for s, (dy, dx) in ((0, (3, 5)), (1, (-4, 2)), (2, (6, -3))):
        im1 = _texture(H, W, seed=s)
        im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
        pairs.append((im1, im2))
    handles = match_images_dispatch_multi(pairs, radius=24, levels=2)
    for (im1, im2), h in zip(pairs, handles):
        got = match_images_fetch(h)
        ref = match_images(im1, im2, radius=24, levels=2)
        assert got.shape == ref.shape, (got.shape, ref.shape)
        assert np.array_equal(got, ref)


def test_subpatch_mode_recovers_translation():
    """subpatch=True (DeepMatching-style split-and-rescore coarse search,
    ops/matching._search_subpatch) must stay correct on rigid motion even
    though it is measured NEGATIVE on the stretch ladder (coverage drops at
    every stretch level — see scripts/stretch_ladder.py --subpatch) and so
    ships opt-in-off."""
    H, W = 96, 128
    im1 = _texture(H, W, seed=7)
    dx, dy = 6, -3
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    m = match_images(im1, im2, radius=16, levels=2, stride=4, subpatch=True)
    assert len(m) > 100
    u = m[:, 2] - m[:, 0]
    v = m[:, 3] - m[:, 1]
    assert abs(np.median(u) - dx) <= 0.5 and abs(np.median(v) - dy) <= 0.5
    good = (np.abs(u - dx) <= 1) & (np.abs(v - dy) <= 1)
    assert good.mean() > 0.8, good.mean()


def test_subpatch_budget_fallback_equals_rigid():
    """Above the vectorized-search budget _search_subpatch degrades to the
    rigid search — identical (du, dv) planes, no silent precision cliff."""
    import jax.numpy as jnp

    from arap_flow.ops import matching as M

    H, W, r, patch = 40, 56, 5, 8
    rng = np.random.default_rng(11)
    g1 = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    g2 = jnp.roll(g1, (2, -3), axis=(0, 1))
    old = M._SEARCH_VEC_BUDGET
    try:
        M._SEARCH_VEC_BUDGET = 1  # force the fallback branch
        du_f, dv_f, _ = M._search_subpatch(g1, g2, r, patch)
    finally:
        M._SEARCH_VEC_BUDGET = old
    zz = M._zscore(jnp.stack([g1, g2]), patch)
    du_r, dv_r, _ = M._search(zz[0], zz[1], r, patch)
    assert np.array_equal(np.asarray(du_f), np.asarray(du_r))
    assert np.array_equal(np.asarray(dv_f), np.asarray(dv_r))


def test_refine_passes_zero_score_shape():
    """refine_passes=0 is a legal static ablation arg (used by the matcher
    cost probes): no refine search ever overwrites `score`, so the pyramid
    must upsample the coarse NCC confidence alongside the flow — previously
    score stayed coarse-shaped and _device_grid_select mis-indexed it."""
    import jax.numpy as jnp

    from arap_flow.ops.matching import match_grid, pyramid_flow

    H, W = 72, 104
    im1 = _texture(H, W, seed=5)
    im2 = np.roll(im1, (3, -2), axis=(0, 1))
    g1 = jnp.asarray(im1[:, :, 0], jnp.float32)
    g2 = jnp.asarray(im2[:, :, 0], jnp.float32)
    uv, score = pyramid_flow(g1, g2, radius=16, levels=2, refine_passes=0)
    assert uv.shape == (2, H, W)
    assert score.shape == (H, W)

    r1 = jnp.asarray(im1.transpose(2, 0, 1))
    r2 = jnp.asarray(im2.transpose(2, 0, 1))
    u, v, sg, fb = match_grid(r1, r2, stride=4, radius=16, levels=2,
                              refine_passes=0)
    assert u.shape == sg.shape == fb.shape
    # the coarse-only estimate is quantized to the coarse-level quantum
    # (2**levels = 4 px) — just check it lands within one quantum
    assert abs(float(jnp.median(u)) - (-2)) <= 4.0
    assert abs(float(jnp.median(v)) - 3) <= 4.0

"""Bounding-box-cropped solves must equal full-frame solves exactly (the crop
only removes provably-inert excluded pixels)."""

import numpy as np

from arap_flow.models.arap import ArapDeformer, crop_box
from arap_flow.ops.solver import SolverConfig


def _problem(H=56, W=72):
    rng = np.random.default_rng(0)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[18:38, 20:44] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[20:36:4, 22:42:4]
    cons = np.stack(
        [xs.ravel(), ys.ravel(), xs.ravel() + 3, ys.ravel() + 2], 1
    ).astype(np.int32)
    return rgb, arap_mask, cons


def test_crop_box_alignment():
    _, arap_mask, cons = _problem()
    y0, x0, h, w = crop_box(arap_mask, cons, margin=4, h_mult=16, w_mult=16)
    assert h % 16 == 0 or h == arap_mask.shape[0]
    assert w % 16 == 0 or w == arap_mask.shape[1]
    ys, xs = np.where(arap_mask == 0)
    assert y0 <= ys.min() and y0 + h > ys.max()
    assert x0 <= xs.min() and x0 + w > xs.max()


def test_cropped_solve_matches_full():
    rgb, arap_mask, cons = _problem()
    cfg = SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=80,
                       pcg_iters=80.0)
    full = ArapDeformer(cfg).deform(rgb, arap_mask, cons)
    cropped = ArapDeformer(cfg, crop=True).deform(rgb, arap_mask, cons)
    np.testing.assert_allclose(cropped.flow, full.flow, atol=2e-4)
    # warped products agree (uint8, allow the ±1 rounding band)
    diff = np.abs(
        cropped.warped_rgb.astype(int) - full.warped_rgb.astype(int)
    )
    assert (diff <= 1).all()
    np.testing.assert_array_equal(
        cropped.warped_mask > 0, full.warped_mask > 0
    )


def test_tight_solve_margin_exact():
    """The solve box only needs a ~1-px excluded rim (inert-pixel +
    border-pin lemmas); with solve_margin=2 the object must drop into a
    SMALLER solve bucket than with margin=8 while products still match the
    full-frame solve."""
    from arap_flow.ops.energy import ArapWeights
    from arap_flow.pipeline.batch import make_task

    H, W = 200, 300
    rng = np.random.default_rng(3)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[60:136, 80:190] = 0  # 76x110 object
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[64:132:8, 84:186:8]
    # rotation + translation: rotated points overshoot the sampled grid
    th = 0.08
    cy, cx = 98.0, 135.0
    xr = np.cos(th) * (xs - cx) - np.sin(th) * (ys - cy) + cx + 5
    yr = np.sin(th) * (xs - cx) + np.cos(th) * (ys - cy) + cy + 3
    cons = np.stack(
        [xs.ravel(), ys.ravel(), np.round(xr).ravel(), np.round(yr).ravel()],
        1,
    ).astype(np.int32)

    buckets = ((80, 128), (96, 128), (80, 256), (96, 256), (112, 256),
               (144, 256), (176, 256))
    tight = make_task(0, 0, rgb, arap_mask, cons, ArapWeights(),
                      buckets=buckets)  # solve_margin=2 default
    loose = make_task(0, 0, rgb, arap_mask, cons, ArapWeights(),
                      buckets=buckets, solve_margin=8)
    assert tight is not None and loose is not None
    # 76+2*2=80 rows fits the 80-row bucket; 76+2*8=92 needs 96
    assert tight.bucket[0] < loose.bucket[0], (tight.bucket, loose.bucket)

    cfg = SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=80,
                       pcg_iters=80.0)
    full = ArapDeformer(cfg).deform(rgb, arap_mask, cons)
    dec = ArapDeformer(cfg, crop=True, crop_buckets=buckets).deform(
        rgb, arap_mask, cons)
    d = np.abs(dec.flow - full.flow)
    assert np.median(d) < 0.05, np.median(d)
    assert d.max() < 3.0, d.max()
    agree = (dec.warped_mask > 0) == (full.warped_mask > 0)
    assert agree.mean() > 0.99, agree.mean()


def test_transposed_solve_matches_full():
    """A wide-flat object (width just over a lane multiple) picks a TALL-
    NARROW bucket transposed; the program solves the reflected problem and
    transposes the warp field back — products must match the full-frame
    solve (the reflection conjugates the energy: same systems up to
    variable order and angle sign)."""
    from arap_flow.ops.energy import ArapWeights
    from arap_flow.pipeline.batch import make_task

    H, W = 300, 450
    rng = np.random.default_rng(5)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[80:204, 60:324] = 0  # 124x264: wide-flat
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[84:200:8, 64:320:8]
    th = -0.06
    cy, cx = 142.0, 192.0
    xr = np.cos(th) * (xs - cx) - np.sin(th) * (ys - cy) + cx + 6
    yr = np.sin(th) * (xs - cx) + np.cos(th) * (ys - cy) + cy - 4
    cons = np.stack(
        [xs.ravel(), ys.ravel(), np.round(xr).ravel(), np.round(yr).ravel()],
        1,
    ).astype(np.int32)

    t = make_task(0, 0, rgb, arap_mask, cons, ArapWeights())
    assert t is not None and t.transposed, (t and t.bucket)
    # canonical footprint is wide-flat; solver operands are its transpose
    assert t.bucket[1] > t.bucket[0]
    assert t.ops.mask_u8.shape == (t.bucket[1], t.bucket[0])

    cfg = SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=80,
                       pcg_iters=80.0)
    full = ArapDeformer(cfg).deform(rgb, arap_mask, cons)
    dec = ArapDeformer(cfg, crop=True).deform(rgb, arap_mask, cons)
    d = np.abs(dec.flow - full.flow)
    assert np.median(d) < 0.05, np.median(d)
    assert d.max() < 3.0, d.max()
    agree = (dec.warped_mask > 0) == (full.warped_mask > 0)
    assert agree.mean() > 0.99, agree.mean()


def test_canvas_decoupling_large_displacement():
    """A large displacement forces canvas bucket > solve bucket (the raster
    landing margins are solved nowhere); products must still match the
    full-frame solve — flow on the tight box, warped RGB/mask landing far
    outside it on the canvas."""
    from arap_flow.pipeline.batch import make_task
    from arap_flow.ops.energy import ArapWeights

    H, W = 200, 300
    rng = np.random.default_rng(1)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[40:104, 30:110] = 0  # 64x80 object
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[44:100:8, 34:106:8]
    DX, DY = 90, 20  # big rightward displacement
    cons = np.stack(
        [xs.ravel(), ys.ravel(), xs.ravel() + DX, ys.ravel() + DY], 1
    ).astype(np.int32)

    buckets = ((80, 128), (112, 128), (112, 256), (144, 256))
    t = make_task(0, 0, rgb, arap_mask, cons, ArapWeights(), buckets=buckets)
    assert t is not None
    # the displacement pads must widen the canvas beyond the solve bucket
    assert t.canvas[0] * t.canvas[1] > t.bucket[0] * t.bucket[1], (
        t.bucket, t.canvas)
    # solve box inside canvas box
    assert t.cy0 <= t.y0 and t.y0 + t.bucket[0] <= t.cy0 + t.canvas[0]
    assert t.cx0 <= t.x0 and t.x0 + t.bucket[1] <= t.cx0 + t.canvas[1]

    cfg = SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=80,
                       pcg_iters=80.0)
    full = ArapDeformer(cfg).deform(rgb, arap_mask, cons)
    dec = ArapDeformer(cfg, crop=True, crop_buckets=buckets).deform(
        rgb, arap_mask, cons)
    # the linear systems are identical (inert-pixel lemma) but the partially
    # converged CG trajectories diverge through float reassociation on
    # different crop sizes (up to ~1 px on weakly determined pixels at this
    # short schedule) — assert at the level that catches offset/placement
    # bugs (which produce ~DX-scale errors), not reduction rounding
    d = np.abs(dec.flow - full.flow)
    assert np.median(d) < 0.05, np.median(d)
    assert d.max() < 3.0, d.max()
    # the object landed ~DX to the right — covered pixels must agree there
    agree = (dec.warped_mask > 0) == (full.warped_mask > 0)
    assert agree.mean() > 0.99, agree.mean()
    assert (dec.warped_mask[:, 120:] > 0).sum() > 1000  # actually landed

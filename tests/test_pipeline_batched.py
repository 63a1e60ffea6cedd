"""Batched pipeline mode must produce the same products as simple mode."""

import os
import os.path as osp

import numpy as np
from PIL import Image

from arap_flow.io import flo
from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

from test_pipeline import _make_dataset, _smooth_texture, CFG, DX, DY


def test_batched_matches_simple(tmp_path):
    inp = str(tmp_path / "data")
    _make_dataset(inp, two_objects=True)

    out_s = str(tmp_path / "out_simple")
    out_b = str(tmp_path / "out_batched")
    cfg = CFG
    main_pipeline(
        PipelineFlags(input=inp, output=out_s, fd=1, multseg=True, seed=0),
        solver_cfg=cfg,
    )
    main_pipeline(
        PipelineFlags(input=inp, output=out_b, fd=1, multseg=True, seed=0,
                      mode="batched"),
        solver_cfg=cfg,
    )
    lst_s = open(osp.join(out_s, "all_files.list")).read().splitlines()
    lst_b = open(osp.join(out_b, "all_files.list")).read().splitlines()
    assert len(lst_s) == len(lst_b) == 2

    us, vs = flo.flow_read(osp.join(out_s, "Flow", "seq0", "00000.flo"))
    ub, vb = flo.flow_read(osp.join(out_b, "Flow", "seq0", "00000.flo"))
    mask = np.array(Image.open(osp.join(inp, "orgMasks", "seq0", "00000.png")))
    # flows agree on the object regions (bucketed crop solves are exact up to
    # reduction-order float noise; CG transients differ at weakly constrained
    # pixels so compare medians + bulk agreement)
    for seg in (1, 2):
        sel = mask == seg
        assert abs(np.median(us[sel]) - np.median(ub[sel])) < 0.05
        assert np.median(np.abs(us[sel] - ub[sel])) < 0.05
    wm_s = np.array(Image.open(osp.join(out_s, "wMasks", "seq0", "00000.png")))
    wm_b = np.array(Image.open(osp.join(out_b, "wMasks", "seq0", "00000.png")))
    assert ((wm_s > 0) == (wm_b > 0)).mean() > 0.98


def _make_seq(root, seq, H_, W_, n_frames=2):
    """A moving textured square at an arbitrary resolution."""
    tex = _smooth_texture(H_, W_, 1)
    bgtex = _smooth_texture(H_, W_, 2) // 3
    os.makedirs(osp.join(root, "orgRGB", seq), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", seq), exist_ok=True)
    yy, xx = np.mgrid[0:H_, 0:W_]
    for t in range(n_frames):
        img = bgtex.copy()
        mask = np.zeros((H_, W_), np.uint8)
        y0, x0 = 12 + DY * t, 8 + DX * t
        ob = (yy >= y0) & (yy < y0 + 24) & (xx >= x0) & (xx < x0 + 28)
        img[ob] = tex[yy[ob] - DY * t, xx[ob] - DX * t]
        mask[ob] = 1
        Image.fromarray(img).save(
            osp.join(root, "orgRGB", seq, f"{t:05d}.jpg"), quality=98
        )
        Image.fromarray(mask).save(osp.join(root, "orgMasks", seq, f"{t:05d}.png"))


def test_sharded_matches_batched_byte_identical(tmp_path):
    """--mode sharded over the virtual 8-device CPU mesh must produce
    byte-identical products to --mode batched on one device: dp sharding is
    zero-collective, each device computes whole problems with the same
    program (the reference farm's determinism, para_gen.py:560-567)."""
    import jax

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs the virtual multi-device mesh")
    inp = str(tmp_path / "data")
    _make_dataset(inp, n_frames=4, two_objects=True)
    cfg = CFG
    out_b = str(tmp_path / "out_batched")
    out_s = str(tmp_path / "out_sharded")
    main_pipeline(
        PipelineFlags(input=inp, output=out_b, fd=1, multseg=True, seed=0,
                      mode="batched"),
        solver_cfg=cfg,
    )
    main_pipeline(
        PipelineFlags(input=inp, output=out_s, fd=1, multseg=True, seed=0,
                      mode="sharded"),
        solver_cfg=cfg,
    )
    lst_b = open(osp.join(out_b, "all_files.list")).read().splitlines()
    lst_s = open(osp.join(out_s, "all_files.list")).read().splitlines()
    assert len(lst_b) == len(lst_s) == 3
    for sub in ("Flow", "wRGB", "wMasks", "inpRGB", "inpMasks"):
        for root, _, files in os.walk(osp.join(out_b, sub)):
            for f in files:
                pb = osp.join(root, f)
                ps = pb.replace(out_b, out_s)
                assert open(pb, "rb").read() == open(ps, "rb").read(), pb


def test_shard_times_sharded_matches_single_host(tmp_path):
    """--shard I/N (multi-host scan split) composed with --mode sharded (the
    per-host device mesh): two 'hosts' writing into the SAME output tree must
    reproduce a single-host batched run byte-for-byte, and their per-shard
    list files must disjoint-union to the full set (the reference's
    filesystem-shared multi-GPU farm semantics, para_gen.py:560-567)."""
    import jax

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs the virtual multi-device mesh")
    inp = str(tmp_path / "data")
    _make_dataset(inp, n_frames=4, two_objects=True)
    cfg = CFG
    out_1 = str(tmp_path / "out_single")
    out_s = str(tmp_path / "out_sharded")
    main_pipeline(
        PipelineFlags(input=inp, output=out_1, fd=1, multseg=True, seed=0,
                      mode="batched"),
        solver_cfg=cfg,
    )
    for i in range(2):
        main_pipeline(
            PipelineFlags(input=inp, output=out_s, fd=1, multseg=True, seed=0,
                          mode="sharded", shard=(i, 2)),
            solver_cfg=cfg,
        )
    lst_1 = open(osp.join(out_1, "all_files.list")).read().splitlines()
    shard_lines = []
    for i in range(2):
        shard_lines += open(
            osp.join(out_s, f"all_files.list.{i}of2")
        ).read().splitlines()
    assert sorted(
        l.replace(out_s, out_1) for l in shard_lines
    ) == sorted(lst_1)
    assert len(shard_lines) == len(set(shard_lines)) == len(lst_1) == 3
    for sub in ("Flow", "wRGB", "wMasks", "inpRGB", "inpMasks"):
        for root, _, files in os.walk(osp.join(out_1, sub)):
            for f in files:
                p1 = osp.join(root, f)
                ps = p1.replace(out_1, out_s)
                assert open(p1, "rb").read() == open(ps, "rb").read(), p1


def test_fallback_respects_weights():
    """An oversized segment (no bucket fits) falls back to a full-frame solve
    inside run_tasks; that solve must use the caller's energy weights, not the
    defaults (regression: batch.py's fallback once dropped the weights
    argument to build_compact)."""
    from arap_flow.io.constraints import add_border_pins
    from arap_flow.models.arap import ArapDeformer
    from arap_flow.ops.energy import ArapWeights
    from arap_flow.pipeline.batch import make_task, run_tasks

    Hs, Ws = 48, 64
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (Hs, Ws, 3)).astype(np.uint8)
    mask = np.full((Hs, Ws), 255, np.uint8)
    mask[4:44, 4:60] = 0  # nearly the whole frame: no bucket fits
    cons = np.array([[20, 20, 24, 23], [40, 30, 44, 33]], np.int32)
    weights = ArapWeights(w_fit=10.0, w_reg=0.5)
    cfg = CFG

    assert make_task(0, 0, rgb, mask, cons, weights) is None
    pinned = add_border_pins(cons, Ws, Hs)
    out = run_tasks(
        [], [(0, 0, rgb, mask, pinned)], cfg, weights=weights
    )[(0, 0)]

    ref = ArapDeformer(cfg, weights).deform(
        rgb, mask, cons
    )
    np.testing.assert_allclose(out.flow, ref.flow, atol=1e-5)
    # and the weights demonstrably matter: default weights give a different flow
    ref_default = ArapDeformer(cfg).deform(
        rgb, mask, cons
    )
    assert np.abs(ref.flow - ref_default.flow).max() > 0.05


def test_batched_mixed_resolutions(tmp_path):
    """Without --size, one batched chunk can span sequences of different
    resolutions; the batched matcher must group by shape instead of aborting
    the run on jnp.stack."""
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    _make_seq(inp, "seq_a", 64, 80)
    _make_seq(inp, "seq_b", 48, 96)
    cfg = CFG
    triples = main_pipeline(
        PipelineFlags(input=inp, output=out, fd=1, seed=0, mode="batched"),
        solver_cfg=cfg,
    )
    assert len(triples) == 2  # one pair per sequence, both survive
    for seq, (h, w) in (("seq_a", (64, 80)), ("seq_b", (48, 96))):
        u, v = flo.flow_read(osp.join(out, "Flow", seq, "00000.flo"))
        assert u.shape == (h, w)
        mask = np.array(
            Image.open(osp.join(inp, "orgMasks", seq, "00000.png"))
        )
        obj = mask == 1
        assert abs(np.median(u[obj]) - DX) < 0.5
        assert abs(np.median(v[obj]) - DY) < 0.5


def test_canvas_sharded_matches_unsharded():
    """The production batched dispatch (solve_and_raster_canvas) under the
    8-device mesh (shard_map over 'data', one problem per device) must match
    the unsharded batched run byte-for-byte on every product."""
    import jax
    import jax.numpy as jnp

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the virtual multi-device mesh")
    from arap_flow.io.constraints import add_border_pins
    from arap_flow.models.arap import solve_and_raster_canvas
    from arap_flow.ops import energy as E
    from arap_flow.ops.solver import SolverConfig
    from arap_flow.parallel import make_mesh

    H_, W_ = 32, 128
    rng = np.random.default_rng(0)
    ops_list, rgb_list = [], []
    for s in range(8):
        arap_mask = np.full((H_, W_), 255, np.uint8)
        arap_mask[4 : H_ - 4, 10 : W_ - 10] = 0
        ys, xs = np.mgrid[6 : H_ - 6 : 6, 14 : W_ - 14 : 16]
        cons = np.stack(
            [xs.ravel(), ys.ravel(),
             xs.ravel() + rng.integers(-3, 4, xs.size),
             ys.ravel() + rng.integers(-3, 4, xs.size)], 1).astype(np.int32)
        cons = add_border_pins(cons, W_, H_)
        ops_list.append(E.build_operands(arap_mask, cons))
        rgb_list.append(rng.integers(0, 256, (3, H_, W_)).astype(np.uint8))
    batched = jax.tree.map(lambda *ls: jnp.stack(ls), *ops_list)
    rgb_b = jnp.asarray(np.stack(rgb_list))
    offs = jnp.zeros((8, 2), jnp.int32)
    cfg = SolverConfig(num_anneal=2, gn_iters=1, max_pcg_iters=25,
                       pcg_iters=25.0)
    mesh = make_mesh(data=8, space=1)
    f1, r1, m1 = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                         canvas_hw=(H_, W_), mesh=None)
    f2, r2, m2 = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                         canvas_hw=(H_, W_), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))

"""End-to-end pipeline test on a tiny synthetic dataset: a textured square
translating across frames; verifies directory products, flow accuracy at the
object, all_files.list, multseg composition, and --resume semantics."""

import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

from arap_flow.io import flo
from arap_flow.ops.solver import SolverConfig
from arap_flow.pipeline.para_gen import (
    PipelineFlags,
    main_pipeline,
    scan_pairs,
)

H, W = 64, 80
DX, DY = 3, 2


def _smooth_texture(H_, W_, seed):
    """Matcher-friendly texture: smooth random blocks + mild detail (natural
    images are smooth; per-pixel noise defeats any patch matcher)."""
    rng = np.random.default_rng(seed)
    base = np.kron(
        rng.uniform(60, 255, (H_ // 8 + 2, W_ // 8 + 2, 3)), np.ones((8, 8, 1))
    )[:H_, :W_]
    detail = np.kron(
        rng.uniform(-25, 25, (H_ // 2 + 1, W_ // 2 + 1, 3)), np.ones((2, 2, 1))
    )[:H_, :W_]
    return np.clip(base + detail, 0, 255).astype(np.uint8)


def _make_dataset(root, n_frames=3, two_objects=False):
    tex = _smooth_texture(H, W, 1)
    bgtex = _smooth_texture(H, W, 2) // 3  # static dark background
    os.makedirs(osp.join(root, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bgtex.copy()
        mask = np.zeros((H, W), np.uint8)
        y0, x0 = 12 + DY * t, 8 + DX * t
        ob1 = (yy >= y0) & (yy < y0 + 30) & (xx >= x0) & (xx < x0 + 34)
        # texture sampled in object-local coordinates so it moves rigidly
        img[ob1] = tex[yy[ob1] - DY * t, xx[ob1] - DX * t]
        mask[ob1] = 1
        if two_objects:
            y1, x1 = 38 - DY * t, 48 + DX * t
            ob2 = (yy >= y1) & (yy < y1 + 20) & (xx >= x1) & (xx < x1 + 24)
            img[ob2] = tex[yy[ob2] + DY * t, xx[ob2] - DX * t]
            mask[ob2] = 2
        Image.fromarray(img).save(osp.join(root, "orgRGB", "seq0", f"{t:05d}.jpg"),
                                  quality=98)
        Image.fromarray(mask).save(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"))


CFG = SolverConfig(num_anneal=4, gn_iters=3, max_pcg_iters=120, pcg_iters=120.0)


def test_pipeline_end_to_end(tmp_path):
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    _make_dataset(inp)
    flags = PipelineFlags(input=inp, output=out, fd=1, seed=0)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == 2  # 3 frames -> 2 pairs
    for line in triples:
        for pth in line.split(" "):
            assert osp.exists(pth)
    # flow at the object ≈ (DX, DY)
    u, v = flo.flow_read(osp.join(out, "Flow", "seq0", "00000.flo"))
    mask = np.array(Image.open(osp.join(inp, "orgMasks", "seq0", "00000.png")))
    obj = mask == 1
    assert abs(np.median(u[obj]) - DX) < 0.5
    assert abs(np.median(v[obj]) - DY) < 0.5
    # background flow is zero (excluded region)
    assert np.abs(u[~obj]).max() < 1e-3
    # all_files.list exists and matches
    lst = open(osp.join(out, "all_files.list")).read().splitlines()
    assert len(lst) == 2
    # warped mask covers roughly the translated object
    wmask = np.array(Image.open(osp.join(out, "wMasks", "seq0", "00000.png")))
    assert (wmask > 0).sum() > 0.7 * obj.sum()


def test_pipeline_resume(tmp_path):
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    _make_dataset(inp)
    flags = PipelineFlags(input=inp, output=out, fd=1, seed=0)
    main_pipeline(flags, solver_cfg=CFG)
    flags2 = PipelineFlags(input=inp, output=out, fd=1, resume=True, seed=0)
    assert scan_pairs(flags2) == []  # everything already generated


def test_pipeline_multseg(tmp_path):
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    _make_dataset(inp, two_objects=True)
    flags = PipelineFlags(input=inp, output=out, fd=1, multseg=True, seed=0)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == 2
    u, v = flo.flow_read(osp.join(out, "Flow", "seq0", "00000.flo"))
    mask = np.array(Image.open(osp.join(inp, "orgMasks", "seq0", "00000.png")))
    # object 1 moves (+DX, +DY); object 2 moves (+DX, −DY): composition must
    # keep them distinct
    assert abs(np.median(u[mask == 1]) - DX) < 0.6
    assert abs(np.median(v[mask == 1]) - DY) < 0.6
    assert abs(np.median(v[mask == 2]) + DY) < 0.6


def test_pipeline_with_backgrounds(tmp_path):
    """bg_dir exercises the BackgroundPool path: inpRGB gets a random
    background over annotation-background pixels; warped RGB gets the same
    background over uncovered pixels (para_gen.py:484-507, 207-212)."""
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    bgd = tmp_path / "bgs"
    bgd.mkdir()
    rngb = np.random.default_rng(9)
    for i in range(2):
        Image.fromarray(
            rngb.integers(100, 255, (100, 140, 3)).astype(np.uint8)
        ).save(bgd / f"bg{i}.jpg")
    _make_dataset(inp)
    flags = PipelineFlags(input=inp, output=out, bg_dir=str(bgd), fd=1, seed=0)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == 2
    # inpRGB background region should not be the dark synthetic background
    inp_rgb = np.array(Image.open(osp.join(out, "inpRGB", "seq0", "00000.png")))
    mask = np.array(Image.open(osp.join(inp, "orgMasks", "seq0", "00000.png")))
    bgpix = inp_rgb[mask == 0]
    assert bgpix.mean() > 60  # dark synthetic bg is ~<30; random bgs are bright


def test_pipeline_fd2(tmp_path):
    inp = str(tmp_path / "data")
    out = str(tmp_path / "out")
    _make_dataset(inp, n_frames=3)
    flags = PipelineFlags(input=inp, output=out, fd=2, seed=0)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == 1  # only (0, 2)
    u, v = flo.flow_read(osp.join(out, "Flow", "seq0", "00000.flo"))
    mask = np.array(Image.open(osp.join(inp, "orgMasks", "seq0", "00000.png")))
    assert abs(np.median(u[mask == 1]) - 2 * DX) < 0.7


def test_prewarm_compiles_bucket_programs():
    """--warmup: the prewarm pass builds and runs a batched dummy problem per
    bucket without error (compile-cache priming for cold pipeline starts)."""
    from arap_flow.ops.energy import ArapWeights
    from arap_flow.pipeline.para_gen import prewarm

    cfg = SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=4,
                       pcg_iters=4.0)
    prewarm(cfg, ArapWeights(), buckets=((32, 64),), batched=True)
    prewarm(cfg, ArapWeights(), buckets=((32, 64),), batched=False)


def test_scan_pairs_repeated_digits_in_stem(tmp_path):
    """Frame stems where the frame number also appears earlier ('001_001')
    must pair to '001_002', not '002_002' (the round-5 str.replace fix:
    substitution happens at the regex match span only)."""
    from arap_flow.pipeline.para_gen import scan_pairs

    inp = str(tmp_path / "d")
    for stem in ("001_001", "001_002"):
        for sub, arr in (("orgRGB", np.zeros((8, 10, 3), np.uint8)),
                         ("orgMasks", np.zeros((8, 10), np.uint8))):
            os.makedirs(osp.join(inp, sub, "seq0"), exist_ok=True)
            ext = ".jpg" if sub == "orgRGB" else ".png"
            Image.fromarray(arr).save(osp.join(inp, sub, "seq0", stem + ext))
    pairs = scan_pairs(PipelineFlags(input=inp, output=str(tmp_path / "o"),
                                     fd=1))
    assert len(pairs) == 1
    assert pairs[0].rgb1_org.endswith("001_001.jpg")
    assert pairs[0].rgb2_org.endswith("001_002.jpg")


def test_warmup_full_env_selects_whole_ladder(tmp_path, monkeypatch):
    """ARAP_WARMUP_FULL=1 routes --warmup over the ENTIRE bucket ladder
    (CROP_BUCKETS) instead of the 13-shape prewarm subset — the full-ladder
    cold-start option (pairs with --exec_pack for a farm builder process)."""
    from arap_flow.models.arap import CROP_BUCKETS
    from arap_flow.pipeline import para_gen as pg

    captured = {}

    def fake_prewarm(cfg, weights, buckets=None, **kw):
        captured["buckets"] = buckets

    monkeypatch.setattr(pg, "prewarm", fake_prewarm)
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    _make_dataset(inp, n_frames=2)
    for env, expect in (("1", CROP_BUCKETS), ("", None)):
        monkeypatch.setenv("ARAP_WARMUP_FULL", env)
        pg.main_pipeline(
            PipelineFlags(input=inp, output=out, fd=1, seed=0,
                          mode="batched", warmup=True),
            solver_cfg=CFG,
        )
        assert captured.pop("buckets") == expect


def test_prewarm_sharded_warms_the_sharded_executable():
    """--mode sharded --warmup must warm the jit(shard_map) program the
    sharded dispatch runs (a different top-level executable from the
    unsharded impl), at the sharded chunk size."""
    import jax

    from arap_flow.models.arap import _canvas_sharded_fn
    from arap_flow.ops.energy import ArapWeights
    from arap_flow.pipeline.para_gen import prewarm

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the virtual multi-device mesh")
    from arap_flow.parallel import make_mesh

    cfg = SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=4,
                       pcg_iters=4.0)
    mesh = make_mesh(data=8, space=1)
    before = _canvas_sharded_fn.cache_info().currsize
    prewarm(cfg, ArapWeights(), buckets=((32, 64),), batched=True, mesh=mesh)
    assert _canvas_sharded_fn.cache_info().currsize > before


def test_scan_shard_partitions_pairs(tmp_path):
    """--shard I/N: hosts partition the sorted pair scan disjointly and
    completely (multi-host dataset sharding, SURVEY §2.7)."""
    from arap_flow.io.image import save_image
    from arap_flow.pipeline.para_gen import PipelineFlags, scan_pairs

    root = tmp_path / "data"
    (root / "orgRGB" / "seq0").mkdir(parents=True)
    (root / "orgMasks" / "seq0").mkdir(parents=True)
    for t in range(7):
        save_image(root / "orgRGB" / "seq0" / f"{t:05d}.jpg",
                   np.zeros((8, 8, 3), np.uint8))
        save_image(root / "orgMasks" / "seq0" / f"{t:05d}.png",
                   np.ones((8, 8), np.uint8))
    base = dict(input=str(root), output=str(tmp_path / "out"), fd=1)
    all_pairs = [p.flow_gen for p in scan_pairs(PipelineFlags(**base))]
    assert len(all_pairs) == 6
    sharded = []
    for i in range(3):
        sharded += [
            p.flow_gen
            for p in scan_pairs(PipelineFlags(**base, shard=(i, 3)))
        ]
    assert sorted(sharded) == sorted(all_pairs)
    assert len(set(sharded)) == len(sharded)


def test_generate_four_phases_end_to_end(tmp_path):
    """The phase-by-phase generator (generate.py parity): match -> convert ->
    deform -> bg each checkpoint to the filesystem and compose into a
    training list, restartable at any phase."""
    from arap_flow.io.image import save_image
    from arap_flow.pipeline import generate as G
    from arap_flow.pipeline.para_gen import PipelineFlags, scan_pairs

    H, W = 48, 64
    rng = np.random.default_rng(9)
    root = tmp_path / "data"
    (root / "orgRGB" / "seq0").mkdir(parents=True)
    (root / "orgMasks" / "seq0").mkdir(parents=True)
    base = np.kron(rng.integers(0, 255, (H // 4 + 1, W // 4 + 1, 3)),
                   np.ones((4, 4, 1)))[:H, :W].astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[10:-10, 14:-14] = 1  # one object segment
    for t in (0, 1):
        frame = np.roll(base, 2 * t, axis=1)
        save_image(root / "orgRGB" / "seq0" / f"{t:05d}.jpg", frame)
        save_image(root / "orgMasks" / "seq0" / f"{t:05d}.png",
                   np.roll(mask, 2 * t, axis=1))
    bg_dir = tmp_path / "bg"
    bg_dir.mkdir()
    save_image(bg_dir / "b.png",
               rng.integers(0, 255, (H, W, 3)).astype(np.uint8))

    flags = PipelineFlags(input=str(root), output=str(tmp_path / "out"),
                          bg_dir=str(bg_dir), fd=1, seed=0)
    pairs = scan_pairs(flags)
    assert len(pairs) == 1
    G.phase_match(flags, pairs)
    assert osp.exists(pairs[0].cstr_tmp)
    G.phase_convert(flags, pairs)
    assert osp.exists(pairs[0].msk1_gen) and osp.exists(pairs[0].rgb1_gen)
    cfg = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                       pcg_iters=40.0)
    G.phase_deform(flags, pairs, solver_cfg=cfg)
    assert osp.exists(pairs[0].flow_gen)
    u, v = flo.flow_read(pairs[0].flow_gen)
    obj = mask > 0
    assert abs(np.median(u[obj]) - 2.0) < 0.6  # recovers the +2 px shift
    lines = G.phase_bg(flags, pairs)
    assert len(lines) == 1
    assert osp.exists(osp.join(flags.output, "all_files.list"))


def test_cli_accepts_reference_noop_flags():
    """The reference CLI parses --rm-cnstr/--rm-wmask/--rm-tmp-cmd/
    --img-pattern but never reads them (para_gen.py:615-618); we accept them
    as no-ops so reference command lines are drop-in."""
    from arap_flow.pipeline.para_gen import parse_args

    f = parse_args([
        "--input", "/tmp/in", "--output", "/tmp/out",
        "--rm-cnstr", "1", "--rm-wmask", "x", "--rm-tmp-cmd", "y",
        "--img-pattern", "*.jpg", "--gpu", "0", "1",
    ])
    assert f.input == "/tmp/in" and f.output == "/tmp/out"

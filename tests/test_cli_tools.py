"""CLI tool tests: warp_tool and deform_tool end-to-end on tiny inputs."""

import os.path as osp

import numpy as np
from PIL import Image

from arap_flow.io import flo
from arap_flow.io.image import save_image
from arap_flow.pipeline import deform_tool, warp_tool


def test_warp_tool_host_backend(tmp_path):
    H, W = 40, 48
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)  # all object
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = 3.0
    p_rgb = str(tmp_path / "rgb.png")
    p_msk = str(tmp_path / "msk.png")
    p_flo = str(tmp_path / "f.flo")
    save_image(p_rgb, rgb)
    save_image(p_msk, mask)
    flo.flow_write(p_flo, flow)
    out_rgb = str(tmp_path / "w.png")
    out_msk = str(tmp_path / "wm.png")
    warp_tool.main([p_rgb, p_msk, p_flo, out_rgb, out_msk, "--backend", "host"])
    wrgb = np.array(Image.open(out_rgb))
    # translated by +3 in x on the interior
    np.testing.assert_array_equal(wrgb[:H - 1, 3 : W - 1], rgb[:H - 1, : W - 4])


def test_deform_tool_six_paths(tmp_path):
    H, W = 32, 40
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    p_rgb = str(tmp_path / "rgb.png")
    p_msk = str(tmp_path / "msk.png")
    p_cstr = str(tmp_path / "c.txt")
    save_image(p_rgb, rgb)
    save_image(p_msk, mask)
    # constraints: shift interior grid by (2, 1)
    lines = []
    for y in range(6, H - 6, 6):
        for x in range(6, W - 6, 6):
            lines.append(f"{x}\t{y}\t{x+2}\t{y+1}")
    open(p_cstr, "w").write(f"{len(lines)}\n" + "\n".join(lines))
    out_flo = str(tmp_path / "o.flo")
    out_rgb = str(tmp_path / "o.png")
    out_msk = str(tmp_path / "om.png")
    # tiny schedule via list mode is parity-only; use the module API with a
    # small config through the CLI's frame runner
    from arap_flow.ops.solver import SolverConfig

    frames = [deform_tool.FramePaths(p_rgb, p_msk, p_cstr, out_flo, out_rgb, out_msk)]
    deform_tool.deform_frames(
        frames, SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                             pcg_iters=60.0)
    )
    u, v = flo.flow_read(out_flo)
    interior = (slice(8, H - 8), slice(8, W - 8))
    assert abs(np.median(u[interior]) - 2.0) < 0.3
    assert abs(np.median(v[interior]) - 1.0) < 0.3
    assert osp.exists(out_rgb) and osp.exists(out_msk)


def test_run_warp_scan(tmp_path):
    """run_warp job scan finds fd trees with the reference directory layout."""
    from arap_flow.pipeline.run_warp import scan_jobs

    root = tmp_path
    for sub in ("Flow", "inpRGB", "inpMasks"):
        (root / "fd2" / sub / "seq0").mkdir(parents=True)
    flo.flow_write(root / "fd2" / "Flow" / "seq0" / "a.flo",
                   np.zeros((8, 8, 2), np.float32))
    save_image(root / "fd2" / "inpRGB" / "seq0" / "a.png",
               np.zeros((8, 8, 3), np.uint8))
    save_image(root / "fd2" / "inpMasks" / "seq0" / "a.png",
               np.zeros((8, 8), np.uint8))
    jobs = scan_jobs(str(root), [1, 2, 3])
    assert len(jobs) == 1
    assert "fd2" in jobs[0][2]


def test_build_sintel_list(tmp_path):
    """run_arap --input: Sintel-style tree scan builds 6-tuple jobs."""
    from arap_flow.pipeline.run_arap import build_sintel_list

    root = tmp_path
    (root / "clean" / "alley_1").mkdir(parents=True)
    (root / "masks" / "clean" / "alley_1").mkdir(parents=True)
    (root / "cnstr" / "clean" / "alley_1").mkdir(parents=True)
    save_image(root / "clean" / "alley_1" / "frame_0001.png",
               np.zeros((8, 8, 3), np.uint8))
    save_image(root / "masks" / "clean" / "alley_1" / "frame_0001.png",
               np.zeros((8, 8), np.uint8))
    (root / "cnstr" / "clean" / "alley_1" / "frame_0001.txt").write_text("0")
    # a frame without constraints must be skipped
    save_image(root / "clean" / "alley_1" / "frame_0002.png",
               np.zeros((8, 8, 3), np.uint8))
    jobs = build_sintel_list(str(root), ["clean", "final"])
    assert len(jobs) == 1
    assert jobs[0].out_flo.endswith("frame_0001.flo")


def test_run_arap_sintel_tree_end_to_end(tmp_path, monkeypatch):
    """Real-tree run_arap smoke: a tiny synthetic Sintel clean/final tree is
    scanned, solved THROUGH THE BATCHED SOLVER (same-shape frames grouped
    into one program), and .flo + warped PNGs land in flow_arap/{pass}/seq.
    Mirrors run_arap.py:27-80 end-to-end."""
    from arap_flow.models import arap as arap_mod
    from arap_flow.ops.solver import SolverConfig
    from arap_flow.pipeline.run_arap import build_sintel_list

    root = tmp_path
    H, W = 40, 48
    rng = np.random.default_rng(7)
    calls = {"batched": 0}
    real_batch = arap_mod.solve_and_raster_batch

    def spy(*a, **k):
        calls["batched"] += 1
        return real_batch(*a, **k)

    monkeypatch.setattr(arap_mod, "solve_and_raster_batch", spy)

    n_frames = {"clean": 3, "final": 2}
    for pas, n in n_frames.items():
        (root / pas / "seq0").mkdir(parents=True)
        (root / "masks" / pas / "seq0").mkdir(parents=True)
        (root / "cnstr" / pas / "seq0").mkdir(parents=True)
        for i in range(1, n + 1):
            rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
            mask = np.full((H, W), 255, np.uint8)
            mask[8:-8, 8:-8] = 0  # object = solve region
            name = f"frame_{i:04d}"
            save_image(root / pas / "seq0" / f"{name}.png", rgb)
            save_image(root / "masks" / pas / "seq0" / f"{name}.png", mask)
            lines = [
                f"{x}\t{y}\t{x+2}\t{y+1}"
                for y in range(12, H - 12, 8)
                for x in range(12, W - 12, 8)
            ]
            (root / "cnstr" / pas / "seq0" / f"{name}.txt").write_text(
                f"{len(lines)}\n" + "\n".join(lines)
            )

    frames = build_sintel_list(str(root), ["clean", "final"])
    assert len(frames) == 5
    cfg = SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                       pcg_iters=60.0)
    deform_tool.deform_frames(frames, cfg)

    assert calls["batched"] >= 1  # the batched program actually ran
    for fr in frames:
        assert osp.exists(fr.out_flo) and osp.exists(fr.out_rgb) \
            and osp.exists(fr.out_mask)
        u, v = flo.flow_read(fr.out_flo)
        assert np.isfinite(u).all() and np.isfinite(v).all()
        interior = (slice(14, H - 14), slice(14, W - 14))
        assert abs(np.median(u[interior]) - 2.0) < 0.5
        assert abs(np.median(v[interior]) - 1.0) < 0.5

"""Adversarial pipeline edge cases: hostile inputs must be skipped/isolated
gracefully (reference behavior: has_mask <10px skip para_gen.py:243-251,
dist<60 constraint filter :216-223, per-pair isolation via worker exit
asserts, PIL-decodes-anything input handling), never raise, and never list
products that don't exist. Distilled from a 10-scenario × 2-mode fuzz
battery that passed in full on both simple and batched modes (round 4);
the cheap, distinct-failure-mode scenarios are pinned here."""

import os
import os.path as osp

import numpy as np
from PIL import Image

from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

# shared texture recipe + solver schedule: import, don't duplicate — a tuning
# change applied to test_pipeline alone must not desynchronize this battery
from test_pipeline import CFG, _smooth_texture as _smooth

H, W = 64, 80


def _moving_square(h, w, n, dy, dx, x0=None, sz=None, seed=1):
    tex = _smooth(h, w, seed)
    bg = _smooth(h, w, seed + 1) // 3
    sz = sz or max(8, min(h, w) // 3)
    y0, x0 = h // 4, (w // 4 if x0 is None else x0)
    yy, xx = np.mgrid[0:h, 0:w]
    frames, masks = [], []
    for t in range(n):
        img = bg.copy()
        m = np.zeros((h, w), np.uint8)
        ya, xa = y0 + dy * t, x0 + dx * t
        ob = (yy >= ya) & (yy < ya + sz) & (xx >= xa) & (xx < xa + sz)
        img[ob] = tex[(yy[ob] - dy * t) % h, (xx[ob] - dx * t) % w]
        m[ob] = 1
        frames.append(img)
        masks.append(m)
    return frames, masks


def _write_seq(root, frames, masks):
    os.makedirs(osp.join(root, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    for t, (img, mask) in enumerate(zip(frames, masks)):
        if img is not None:
            Image.fromarray(img).save(
                osp.join(root, "orgRGB", "seq0", f"{t:05d}.jpg"), quality=98)
        if mask is not None:
            Image.fromarray(mask).save(
                osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"))


def _run(inp, out, expect_pairs, fd=1, **kw):
    flags = PipelineFlags(input=inp, output=out, fd=fd, seed=0, **kw)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == expect_pairs
    for line in triples:
        for pth in line.split(" "):
            assert osp.exists(pth)
    return triples


def test_tiny_mask_pairs_skipped(tmp_path):
    """<10 mask px on either side -> has_mask skip (para_gen.py:243-251):
    frame0's mask is empty, frames 1-2 carry only 9 px."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 3, 2, 3)
    for t in range(3):
        mm = np.zeros((H, W), np.uint8)
        if t:
            mm[30:33, 40:43] = 1  # 9 px < the 10-px floor
        m[t] = mm
    _write_seq(inp, f, m)
    _run(inp, out, expect_pairs=0)


def test_mask_gate_refsum_semantics(tmp_path):
    """--mask_gate refsum replicates the reference's mask.sum()>10 pixel-
    VALUE gate (para_gen.py:251): a 9-px mask of 255-valued pixels is
    SKIPPED by the default count gate but PASSES refsum (9*255 > 10).
    Unit-level check on has_mask itself plus a pipeline-level run."""
    from arap_flow.pipeline.para_gen import has_mask

    nine = np.zeros((H, W), np.uint8)
    nine[30:33, 40:43] = 255  # 9 px, value sum 2295
    assert not has_mask(nine, nine)                  # count: 9 px <= 10
    assert has_mask(nine, nine, "refsum")            # refsum: 2295 > 10
    one = np.zeros((H, W), np.uint8)
    one[5, 5] = 255
    assert has_mask(one, one, "refsum")              # the reference quirk
    assert not has_mask(one, one)
    low = np.zeros((H, W), np.uint8)
    low[10:14, 10:14] = 1  # 16 px but value sum 16 > 10: both pass
    assert has_mask(low, low) and has_mask(low, low, "refsum")
    # pipeline level: 9x9-px object (81 px) moves 2 px/frame — count gate
    # passes it; shrink to 3x3 -> count skips, refsum still processes (the
    # solver gets 9 constraints' worth of a 3x3 object; products must exist)
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 2, 2, 2, sz=3)
    for t in range(2):
        m[t] = (m[t] > 0).astype(np.uint8) * 255
    _write_seq(inp, f, m)
    _run(inp, out, expect_pairs=0)  # count gate: 9 px <= 10 -> skipped
    out2 = str(tmp_path / "o2")
    _run(inp, out2, expect_pairs=1, mask_gate="refsum")


def test_huge_jump_filtered_to_zero_pairs(tmp_path):
    """70-px/frame motion: every match fails the dist<60 constraint filter
    (para_gen.py:216-223) -> the pair drops out instead of producing a
    garbage solve."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(128, 160, 2, 0, 70, x0=5, sz=30)
    _write_seq(inp, f, m)
    _run(inp, out, expect_pairs=0)


def test_corrupt_frame_isolated(tmp_path):
    """A truncated jpg mid-sequence kills only the pairs that touch it;
    the rest of the sequence completes (per-pair isolation)."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 4, 2, 2)
    _write_seq(inp, f, m)
    with open(osp.join(inp, "orgRGB", "seq0", "00001.jpg"), "wb") as fh:
        fh.write(b"\xff\xd8\xff\xe0 truncated")
    # frames 0-3 -> pairs (0,1),(1,2),(2,3); frame1 corrupt kills the first
    # two, (2,3) must still produce products
    _run(inp, out, expect_pairs=1)


def test_rgba_input_and_palette_mask(tmp_path):
    """RGBA PNGs + palette-mode masks decode through the same path as
    RGB jpgs + L-mode masks."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 3, 2, 2)
    os.makedirs(osp.join(inp, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(inp, "orgMasks", "seq0"), exist_ok=True)
    for t in range(3):
        rgba = np.dstack([f[t], np.full((H, W), 255, np.uint8)])
        Image.fromarray(rgba).save(
            osp.join(inp, "orgRGB", "seq0", f"{t:05d}.png"))
        Image.fromarray(m[t]).convert("P").save(
            osp.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
    _run(inp, out, expect_pairs=2)


def test_fd2_with_missing_frame(tmp_path):
    """fd=2 with frame 2 absent: pair (0,2) is skipped by the scan
    (missing-frame check, para_gen.py:413-415), pair (1,3) completes."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 4, 1, 1)
    f[2] = None
    m[2] = None
    _write_seq(inp, f, m)
    _run(inp, out, expect_pairs=1, fd=2)


def test_border_touching_mask(tmp_path):
    """A mask ring on every image border composes with border pinning
    (main.cpp:95-101 semantics) without degenerate solves."""
    inp, out = str(tmp_path / "d"), str(tmp_path / "o")
    f, m = _moving_square(H, W, 3, 1, 1)
    for t in range(3):
        m[t][0, :] = 1
        m[t][-1, :] = 1
        m[t][:, 0] = 1
        m[t][:, -1] = 1
        m[t][20:44, 24:56] = 1
    _write_seq(inp, f, m)
    _run(inp, out, expect_pairs=2)

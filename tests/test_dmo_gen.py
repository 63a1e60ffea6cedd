"""DMO-style generation: textured frames over moving masks must yield valid
flow via the standard pipeline."""

import os
import os.path as osp

import numpy as np
from PIL import Image

from arap_flow.io import flo
from arap_flow.pipeline.dmo_gen import assemble, main as dmo_main, run
from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

from test_pipeline import CFG

H, W = 64, 80
DX, DY = 3, 2


def _make_masks(root, n_frames=3, h=H, w=W):
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    for t in range(n_frames):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = 14 + DY * t, 10 + DX * t
        m[y0 : y0 + 28, x0 : x0 + 32] = 1
        Image.fromarray(m).save(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"))


def test_dmo_assemble_and_flow(tmp_path):
    masks = str(tmp_path / "masks")
    out = str(tmp_path / "out")
    _make_masks(masks)
    troot = assemble(masks, out, seed=3)
    # textured frames exist, masks symlinked
    assert osp.exists(osp.join(troot, "orgRGB", "seq0", "00000.jpg"))
    assert osp.exists(osp.join(troot, "orgMasks", "seq0", "00000.png"))
    # the object texture must move with the mask: run the pipeline and check
    flags = PipelineFlags(input=troot, output=osp.join(out, "fd1"), fd=1, seed=0)
    triples = main_pipeline(flags, solver_cfg=CFG)
    assert len(triples) == 2
    u, v = flo.flow_read(osp.join(out, "fd1", "Flow", "seq0", "00000.flo"))
    m = np.array(Image.open(osp.join(masks, "orgMasks", "seq0", "00000.png")))
    obj = m == 1
    assert abs(np.median(u[obj]) - DX) < 0.6
    assert abs(np.median(v[obj]) - DY) < 0.6


def test_dual_texture_sets_share_flow_byte_identical(tmp_path):
    """--texture_sets 2: the reference's D15OM/D15RM layout (README.md:6-31)
    — two texture sets per frame distance whose Flow trees are BYTE-IDENTICAL
    (set 1 re-applies set 0's .flo via the warp tool instead of re-solving,
    which would change the flow since matches depend on appearance)."""
    masks = str(tmp_path / "masks")
    out = str(tmp_path / "out")
    _make_masks(masks)
    run(masks, out, fds=[1], seed=3, texture_sets=2, solver_cfg=CFG)
    n_checked = 0
    for name in ("00000", "00001"):
        f0 = osp.join(out, "set0", "fd1", "Flow", "seq0", name + ".flo")
        f1 = osp.join(out, "set1", "fd1", "Flow", "seq0", name + ".flo")
        if not osp.exists(f0):
            continue
        assert osp.exists(f1)
        with open(f0, "rb") as a, open(f1, "rb") as b:
            assert a.read() == b.read(), f"Flow differs for {name}"
        n_checked += 1
        # appearance products exist for both sets and DIFFER (different
        # texture seeds), warped masks shared
        for d in ("inpRGB", "wRGB"):
            p0 = osp.join(out, "set0", "fd1", d, "seq0", name + ".png")
            p1 = osp.join(out, "set1", "fd1", d, "seq0", name + ".png")
            assert osp.exists(p0) and osp.exists(p1)
            a0 = np.asarray(Image.open(p0), dtype=np.int16)
            a1 = np.asarray(Image.open(p1), dtype=np.int16)
            assert np.abs(a0 - a1).mean() > 2.0, f"{d} should differ"
        m0 = osp.join(out, "set0", "fd1", "wMasks", "seq0", name + ".png")
        m1 = osp.join(out, "set1", "fd1", "wMasks", "seq0", name + ".png")
        with open(m0, "rb") as a, open(m1, "rb") as b:
            assert a.read() == b.read()
        # set 1's warped RGB must actually be WARPED set-1 texture: warping
        # set 1's inpRGB by the shared flow reproduces it (host backend is
        # deterministic), already guaranteed by construction — spot-check
        # the object moved: warped object pixels differ from the unwarped
        w1 = np.asarray(Image.open(
            osp.join(out, "set1", "fd1", "wRGB", "seq0", name + ".png")),
            dtype=np.int16)
        i1 = np.asarray(Image.open(
            osp.join(out, "set1", "fd1", "inpRGB", "seq0", name + ".png")),
            dtype=np.int16)
        assert np.abs(w1 - i1).mean() > 0.5
    assert n_checked >= 1, "no pairs produced by set 0"


def test_dual_texture_sets_portrait_masks(tmp_path):
    """PORTRAIT annotation masks (H > W): para_gen's preprocessing transposes
    set 0's products (scale_rotate, para_gen.py:122-135), so set 1's
    replication must apply the SAME transpose to its frames — otherwise its
    inpRGB/wRGB would be geometrically inconsistent with the shared Flow
    (the round-5 review finding)."""
    masks = str(tmp_path / "masks")
    out = str(tmp_path / "out")
    _make_masks(masks, h=W, w=H)  # 80x64 portrait -> pipeline transposes
    run(masks, out, fds=[1], seed=3, texture_sets=2, solver_cfg=CFG)
    f0 = osp.join(out, "set0", "fd1", "Flow", "seq0", "00000.flo")
    f1 = osp.join(out, "set1", "fd1", "Flow", "seq0", "00000.flo")
    assert osp.exists(f0) and osp.exists(f1)
    with open(f0, "rb") as a, open(f1, "rb") as b:
        assert a.read() == b.read()
    # set-1 appearance products must be in the TRANSPOSED (landscape)
    # orientation, matching set 0's
    i0 = np.asarray(Image.open(
        osp.join(out, "set0", "fd1", "inpRGB", "seq0", "00000.png")))
    i1 = np.asarray(Image.open(
        osp.join(out, "set1", "fd1", "inpRGB", "seq0", "00000.png")))
    w1 = np.asarray(Image.open(
        osp.join(out, "set1", "fd1", "wRGB", "seq0", "00000.png")))
    assert i1.shape == i0.shape == (H, W, 3)
    assert w1.shape[:2] == (H, W)

"""--matcher binary contract: the external DeepMatching binary must be invoked
on the PREPROCESSED frames (so matches land in the same coordinate system as
the preprocessed masks used by filter_matches), and --dm_bin must accept both
absolute and relative paths (reference contract: para_gen.py:227-240 after
preprocess() re-points rgb1_org/rgb2_org)."""

import os
import os.path as osp
import stat

import numpy as np
from PIL import Image

from arap_flow.pipeline.para_gen import (
    BackgroundPool,
    PipelineFlags,
    PairPaths,
    prep_pair,
)

from test_pipeline import _smooth_texture


def _fake_dm(tmp_path):
    """A stand-in matcher binary that records its argv and emits one match."""
    argv_file = tmp_path / "dm_argv.txt"
    script = tmp_path / "fake_dm.sh"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" > {argv_file}\n'
        # args: src1 src2 -nt 0 -out OUT -ngh_rad 100
        'printf "20 20 23 22\\n" > "$6"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script), argv_file


def _make_pair(tmp_path, H_=48, W_=64):
    """One frame pair with a centered object mask."""
    inp = tmp_path / "data"
    out = tmp_path / "out"
    for d in ("orgRGB/seq0", "orgMasks/seq0"):
        os.makedirs(inp / d, exist_ok=True)
    tex = _smooth_texture(H_, W_, 1)
    mask = np.zeros((H_, W_), np.uint8)
    mask[10:40, 12:52] = 1
    for t in range(2):
        Image.fromarray(tex).save(inp / "orgRGB" / "seq0" / f"{t:05d}.jpg")
        Image.fromarray(mask).save(inp / "orgMasks" / "seq0" / f"{t:05d}.png")
    paths = PairPaths(
        rgb1_gen=str(out / "inpRGB/seq0/00000.png"),
        msk1_gen=str(out / "inpMasks/seq0/00000.png"),
        rgb2_gen=str(out / "wRGB/seq0/00000.png"),
        msk2_gen=str(out / "wMasks/seq0/00000.png"),
        cstr_tmp=str(out / "tmpCnstr/seq0/00000.txt"),
        flow_gen=str(out / "Flow/seq0/00000.flo"),
        rgb1_org=str(inp / "orgRGB/seq0/00000.jpg"),
        msk1_org=str(inp / "orgMasks/seq0/00000.png"),
        rgb2_org=str(inp / "orgRGB/seq0/00001.jpg"),
        msk2_org=str(inp / "orgMasks/seq0/00001.png"),
    )
    return str(inp), str(out), paths


def test_binary_matcher_gets_preprocessed_paths(tmp_path):
    """With --size, the binary must see the resized/cropped frames, not the
    originals."""
    inp, out, p = _make_pair(tmp_path)
    dm, argv_file = _fake_dm(tmp_path)
    flags = PipelineFlags(
        input=inp, output=out, matcher="binary", dm_bin=dm, size=(40, 32),
    )
    bgpool = BackgroundPool(None, np.random.default_rng(0))
    prep_pair(flags, p, bgpool)
    argv = argv_file.read_text().split()
    assert argv[0] == p.rgb1_gen, argv  # preprocessed frame 1
    assert argv[1] == p.rgb2_gen, argv  # preprocessed frame 2


def test_binary_matcher_without_preprocessing_gets_originals(tmp_path):
    inp, out, p = _make_pair(tmp_path)
    dm, argv_file = _fake_dm(tmp_path)
    flags = PipelineFlags(input=inp, output=out, matcher="binary", dm_bin=dm)
    bgpool = BackgroundPool(None, np.random.default_rng(0))
    prep_pair(flags, p, bgpool)
    argv = argv_file.read_text().split()
    assert argv[0] == p.rgb1_org, argv
    assert argv[1] == p.rgb2_org, argv


def test_binary_matcher_absolute_and_relative_bin_path(tmp_path, monkeypatch):
    inp, out, p = _make_pair(tmp_path)
    dm, argv_file = _fake_dm(tmp_path)
    assert osp.isabs(dm)  # absolute path must work (was './{abs}' before)
    bgpool = BackgroundPool(None, np.random.default_rng(0))
    flags = PipelineFlags(input=inp, output=out, matcher="binary", dm_bin=dm)
    assert prep_pair(flags, p, bgpool) is not None
    argv_file.unlink()
    # relative path, reference-style ('./fake_dm.sh' with cwd at the script)
    monkeypatch.chdir(tmp_path)
    flags = PipelineFlags(
        input=inp, output=out, matcher="binary", dm_bin="fake_dm.sh",
    )
    assert prep_pair(flags, p, bgpool) is not None
    assert argv_file.exists()

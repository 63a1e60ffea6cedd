"""The built-in PNG codec (io/image.py) against Pillow as the oracle, and
the product path running with Pillow unimportable."""

import io
import os
import os.path as osp
import sys

import numpy as np
import pytest
from PIL import Image

from arap_flow.io.image import (image_size, load_image, load_mask, load_rgb,
                                png_bytes, save_image)

RNG = np.random.default_rng(0)
ARRAYS = {
    "gray": RNG.integers(0, 256, (17, 23), dtype=np.uint8),
    "rgb": RNG.integers(0, 256, (17, 23, 3), dtype=np.uint8),
    "rgba": RNG.integers(0, 256, (17, 23, 4), dtype=np.uint8),
}


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
def test_png_round_trip_against_pillow(kind, tmp_path):
    path = str(tmp_path / "a.png")
    if kind == "palette":
        # DAVIS-style annotation: palette indices; Pillow picks the bit
        # depth (4 bits here) and adaptive row filters
        idx = RNG.integers(0, 5, (17, 23), dtype=np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128])
        im.save(path)
        np.testing.assert_array_equal(load_image(path), idx)
        np.testing.assert_array_equal(load_mask(path), idx)
        np.testing.assert_array_equal(load_rgb(path),
                                      np.array(Image.open(path).convert("RGB")))
        assert image_size(path) == (23, 17)
        return
    a = ARRAYS[kind]
    save_image(path, a)  # ours -> Pillow
    np.testing.assert_array_equal(np.array(Image.open(path)), a)
    np.testing.assert_array_equal(load_image(path), a)
    # Pillow (adaptive filters, default level) -> ours
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", optimize=True)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    np.testing.assert_array_equal(load_image(path), a)
    rgb = np.array(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(load_rgb(path), rgb)
    assert Image.open(io.BytesIO(png_bytes(a))).size == (23, 17)


def test_pipeline_runs_without_pillow(tmp_path, monkeypatch):
    """A PNG tree through main_pipeline with Pillow unimportable: every
    decode and every product write goes through the built-in codec."""
    from arap_flow.io import flo
    from arap_flow.ops.solver import SolverConfig
    from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

    H, W = 64, 80
    rng = np.random.default_rng(1)
    tex = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                  np.ones((8, 8, 1)))[:H, :W].astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    inp = str(tmp_path / "in")
    for t in range(2):
        img = (tex[::-1] // 3).copy()
        mask = np.zeros((H, W), np.uint8)
        ob = (yy >= 12 + 2 * t) & (yy < 42 + 2 * t) & (xx >= 8 + 3 * t) & (
            xx < 42 + 3 * t)
        img[ob] = tex[yy[ob] - 2 * t, xx[ob] - 3 * t]
        mask[ob] = 1
        for sub, arr in (("orgRGB", img), ("orgMasks", mask)):
            d = osp.join(inp, sub, "seq0")
            os.makedirs(d, exist_ok=True)
            save_image(osp.join(d, f"{t:05d}.png"), arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    out = str(tmp_path / "out")
    cfg = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=30,
                       pcg_iters=30.0)
    triples = main_pipeline(
        PipelineFlags(input=inp, output=out, fd=1, seed=0, mode="batched"),
        solver_cfg=cfg)
    assert len(triples) == 1
    u, v = flo.flow_read(osp.join(out, "Flow", "seq0", "00000.flo"))
    obj = load_mask(osp.join(inp, "orgMasks", "seq0", "00000.png")) == 1
    assert abs(np.median(u[obj]) - 3) < 0.5 and abs(np.median(v[obj]) - 2) < 0.5
    assert load_rgb(osp.join(out, "wRGB", "seq0", "00000.png")).shape == (
        H, W, 3)

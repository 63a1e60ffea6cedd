"""Native runtime tests: the C++ rasterizer must agree with the numpy exact
rasterizer bit-for-bit; flo codec round-trips; async writer persists files."""

import numpy as np
import pytest

from arap_flow.native import build as nbuild
from arap_flow.native import runtime as nrt
from arap_flow.native.host_raster import rasterize_warp_exact, warp_from_flow
from arap_flow.io import flo as flo_io

needs_native = pytest.mark.skipif(
    nbuild.load() is None, reason="native lib unavailable"
)


@needs_native
def test_native_raster_matches_numpy_exact():
    H, W = 48, 64
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    mask = np.full((H, W), 255, np.uint8)
    mask[8:40, 10:50] = 0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    th = 0.3
    cy, cx = H / 2, W / 2
    fx = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx + 4 - xx
    fy = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy - 2 - yy
    warp = warp_from_flow(np.stack([fx, fy], -1).astype(np.float32))

    np_rgb, np_mask = rasterize_warp_exact(warp, rgb, mask)
    c_rgb, c_mask = nrt.rasterize_warp(warp, rgb, mask)
    np.testing.assert_array_equal(c_mask, np_mask)
    np.testing.assert_array_equal(c_rgb, np_rgb)


@needs_native
def test_native_raster_matches_golden_cat512(cat512_warp):
    from arap_flow.io.image import load_rgb, load_mask
    from PIL import Image

    rgb = load_rgb(cat512_warp["rgb"])
    mask = load_mask(cat512_warp["mask"])
    u, v = flo_io.flow_read(cat512_warp["flo"])
    wrgb, wmask = nrt.rasterize_warp(
        warp_from_flow(np.dstack([u, v]).astype(np.float32)), rgb, mask
    )
    gmask = np.array(Image.open(cat512_warp["wmask"]).convert("L"))
    assert ((wmask > 0) == (gmask > 0)).all()
    grgb = load_rgb(cat512_warp["wrgb"])
    assert (np.abs(wrgb.astype(int) - grgb.astype(int)) <= 1).all()


@needs_native
def test_native_flo_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    uv = rng.standard_normal((21, 17, 2)).astype(np.float32)
    p = str(tmp_path / "x.flo")
    nrt.flo_write(p, uv)
    # native bytes == python writer bytes
    assert open(p, "rb").read() == flo_io.flow_encode(uv)
    u, v = nrt.flo_read(p)
    np.testing.assert_array_equal(u, uv[:, :, 0])
    np.testing.assert_array_equal(v, uv[:, :, 1])


@needs_native
def test_async_writer(tmp_path):
    rng = np.random.default_rng(2)
    with nrt.AsyncWriter(threads=2) as w:
        uvs = []
        for i in range(8):
            uv = rng.standard_normal((10, 12, 2)).astype(np.float32)
            uvs.append(uv)
            w.submit_flo(str(tmp_path / f"{i}.flo"), uv)
            w.submit_bytes(str(tmp_path / f"{i}.bin"), b"x" * 100 + bytes([i]))
        w.drain()
        assert w.errors() == 0
    for i, uv in enumerate(uvs):
        u, v = flo_io.flow_read(tmp_path / f"{i}.flo")
        np.testing.assert_array_equal(u, uv[:, :, 0])
        assert (tmp_path / f"{i}.bin").read_bytes()[-1] == i

"""warp_image equivalent: re-apply a .flo flow field to an image + mask.

CLI parity with ARAP/warping/src/main.cpp:302-336:

    python -m arap_flow.pipeline.warp_tool IMAGE MASK FLOW WARPED_IMG WARPED_MASK

Mask convention: 0 = object (drawn), nonzero = background/excluded.
Backends: ``device`` (XLA seed-and-gather rasterizer) or
``host`` (reference-exact splat).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io import flo
from ..io.image import load_mask, load_rgb, save_image


def warp_image(
    img_path, mask_path, flo_path, out_img_path, out_mask_path, backend="host"
):
    rgb = load_rgb(img_path)
    mask = load_mask(mask_path)
    u, v = flo.flow_read(flo_path)
    flow = np.dstack([u, v]).astype(np.float32)

    if backend == "host":
        from ..native.host_raster import rasterize_warp_exact, warp_from_flow

        wrgb, wmask = rasterize_warp_exact(warp_from_flow(flow), rgb, mask)
    else:
        import jax.numpy as jnp

        from ..ops.rasterize import rasterize_flow

        drgb, dmask = rasterize_flow(
            jnp.asarray(flow.transpose(2, 0, 1)),
            jnp.asarray(rgb.transpose(2, 0, 1), jnp.float32),
            jnp.asarray(mask),
        )
        wrgb = np.asarray(drgb).transpose(1, 2, 0).astype(np.uint8)
        wmask = np.asarray(dmask).astype(np.uint8)

    save_image(out_img_path, wrgb)
    save_image(out_mask_path, wmask)
    return wrgb, wmask


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Mask and warp image using the provided optical flow field."
    )
    p.add_argument("image", help="input RGB image (.png)")
    p.add_argument("mask", help="input mask (.png), 0 for object")
    p.add_argument("flow", help="input flow (.flo)")
    p.add_argument("warped_image", help="output warped image (.png)")
    p.add_argument("warped_mask", help="output warped mask (.png)")
    p.add_argument(
        "--backend", choices=["host", "device"], default="host",
        help="host = reference-exact CPU splat; device = XLA rasterizer",
    )
    a = p.parse_args(argv)
    warp_image(a.image, a.mask, a.flow, a.warped_image, a.warped_mask, a.backend)
    print("Saved")


if __name__ == "__main__":
    main()

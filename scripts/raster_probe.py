"""Time the device rasterizer at production crop sizes vs window config.

    python scripts/raster_probe.py
"""
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from arap_flow.ops.rasterize import rasterize_flow


def main():
    print("devices:", jax.devices(), flush=True)
    rng = np.random.default_rng(0)
    for H, W in ((224, 384), (192, 384)):
        yy, xx = np.mgrid[0:H, 0:W]
        ell = ((yy - H/2) / (H*0.35))**2 + ((xx - W/2) / (W*0.4))**2 < 1
        amask = np.where(ell, 0.0, 1.0).astype(np.float32)
        flow = np.zeros((2, H, W), np.float32)
        flow[0] = np.where(ell, 17.3, 0) + rng.normal(0, 0.5, (H, W))
        flow[1] = np.where(ell, -11.2, 0) + rng.normal(0, 0.5, (H, W))
        rgb = rng.uniform(0, 255, (3, H, W)).astype(np.float32)
        for label, kw in (
            ("dual-default", {}),
            ("w4", {"window": 4}),
            ("w3", {"window": 3}),
        ):
            f = jnp.asarray(flow); r = jnp.asarray(rgb); m = jnp.asarray(amask)
            out = rasterize_flow(f, r, m, **kw)
            np.asarray(out[0])
            ts = []
            for _ in range(5):
                t0 = time.time()
                out = rasterize_flow(f, r, m, **kw)
                np.asarray(out[0])
                ts.append(time.time() - t0)
            print(f"{H}x{W} {label}: {min(ts)*1000:.1f} ms", flush=True)


if __name__ == "__main__":
    main()

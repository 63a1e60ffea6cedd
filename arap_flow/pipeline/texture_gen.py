"""Random-texture dataset renderer CLI (texture_gen.py replacement).

The reference drives Blender Cycles over random procedural materials and a
random point light to render 1280×720 texture images (texture_gen.py:311-326).
This CLI renders the same seven texture families procedurally on device:

    python -m arap_flow.pipeline.texture_gen --output DIR --num 100
        [--size 1280 720] [--seed 0] [--families brick checker ...]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..io.image import save_image
from ..ops.textures import FAMILIES


def main(argv=None):
    p = argparse.ArgumentParser(description="Procedural random texture renderer")
    p.add_argument("--output", required=True)
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--size", nargs=2, type=int, default=[1280, 720],
                   help="[width] [height]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--families", nargs="*", default=list(FAMILIES),
                   choices=list(FAMILIES))
    p.add_argument("--prefix", default="texture")
    a = p.parse_args(argv)

    import jax

    from ..ops.textures import render

    os.makedirs(a.output, exist_ok=True)
    W, H = a.size
    rng = np.random.default_rng(a.seed)
    for i in range(a.num):
        fam = a.families[rng.integers(0, len(a.families))]
        key = jax.random.PRNGKey(a.seed * 100003 + i)
        img = np.asarray(render(key, fam, H, W))
        save_image(osp.join(a.output, f"{a.prefix}_{i:05d}_{fam}.png"), img)
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{a.num}")
    print("Done")


if __name__ == "__main__":
    main()

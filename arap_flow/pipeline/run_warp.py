"""Warp-only batch driver (run_warp.py equivalent).

Re-applies existing .flo fields to input images/masks for a set of frame
distances, producing warped RGB/mask trees. The reference scans
``{root}/fd{N}/Flow`` and shells out to warp_image with joblib
(run_warp.py:9-67); here each warp runs in-process (host-exact or device
rasterizer).

    python -m arap_flow.pipeline.run_warp --root ROOT --fd 1 2 3 4 5 9 13
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from .warp_tool import warp_image

FD_DEFAULT = [1, 2, 3, 4, 5, 9, 13]  # run_warp.py:32


def scan_jobs(root: str, fds: list[int]):
    """For each fd: {root}/fd{N}/Flow/**.flo + shared inpRGB/inpMasks ->
    wRGB/wMasks outputs."""
    jobs = []
    for fd in fds:
        froot = osp.join(root, f"fd{fd}", "Flow")
        rgb_root = osp.join(root, f"fd{fd}", "inpRGB")
        msk_root = osp.join(root, f"fd{fd}", "inpMasks")
        if not osp.isdir(froot):
            continue
        for dirpath, _, files in os.walk(froot):
            rel = osp.relpath(dirpath, froot)
            for f in files:
                if not f.endswith(".flo"):
                    continue
                name = osp.splitext(f)[0]
                rgb = osp.join(rgb_root, rel, name + ".png")
                msk = osp.join(msk_root, rel, name + ".png")
                if not (osp.exists(rgb) and osp.exists(msk)):
                    continue
                wrgb = osp.join(root, f"fd{fd}", "wRGB", rel, name + ".png")
                wmsk = osp.join(root, f"fd{fd}", "wMasks", rel, name + ".png")
                jobs.append((rgb, msk, osp.join(dirpath, f), wrgb, wmsk))
    return jobs


def main(argv=None):
    p = argparse.ArgumentParser(description="Warp-only batch driver")
    p.add_argument("--root", required=True)
    p.add_argument("--fd", nargs="*", type=int, default=FD_DEFAULT)
    p.add_argument("--backend", choices=["host", "device"], default="host")
    a = p.parse_args(argv)
    jobs = scan_jobs(a.root, a.fd)
    print(f"{len(jobs)} warp jobs")
    for rgb, msk, flo_path, wrgb, wmsk in jobs:
        os.makedirs(osp.dirname(wrgb), exist_ok=True)
        os.makedirs(osp.dirname(wmsk), exist_ok=True)
        warp_image(rgb, msk, flo_path, wrgb, wmsk, a.backend)
    print("Done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""DMO-style dataset assembly: random procedural textures over object masks.

The reference's DMO datasets (D15OM/D15RM: 5 frame distances × 2 texture sets,
README.md:6-31) pair DAVIS-style object masks with randomized textures; the
repo ships only the Blender texture renderer (texture_gen.py) — the assembly
step is reconstructed here:

1. every object id in a sequence gets a procedural texture (ops/textures)
   sampled in object-tracked coordinates (per-frame mask centroid), so the
   texture translates rigidly with the object and the matcher can recover the
   motion; the background gets its own static texture;
2. the textured frames + original masks form an orgRGB/orgMasks tree;
3. para_gen runs on that tree exactly as on real video (per --fd).

    python -m arap_flow.pipeline.dmo_gen --masks ROOT --output OUT \
        [--fd 1 2 3] [--seed 0] [--multseg] [--schedule parity] \
        [--texture_sets 2]

``--masks ROOT`` must contain orgMasks/<seq>/NNNNN.png annotation masks
(0 = background, ids = objects). Textured frames are written to
OUT/textured/orgRGB; each fd runs into OUT/fd{N}/ with shared masks
(the D15 layout).

``--texture_sets K`` (K >= 2) reproduces the reference's DUAL-texture-set
layout (D15OM + D15RM share identical Flow, README.md:6-31): set 0 is solved
normally into OUT/set0/fd{N}; each further set k re-textures the SAME masks
with a different seed and REUSES set 0's .flo via the warp tool (run_warp
semantics) — Flow is hard-linked, so the sets' Flow trees are byte-identical
by construction; only inpRGB/wRGB/wMasks are re-generated from set k's
textures. Matches/solves run ONCE regardless of K.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import zlib

import numpy as np

from ..io.image import save_image
from .para_gen import (COLOR_DIR, FLOW_DIR, MASK_DIR, ORGCOLOR, ORGMASK,
                       WMASK_DIR, WRGB_DIR, PipelineFlags, main_pipeline,
                       scale_rotate)


def _texture_for(key_seed: int, H: int, W: int):
    import jax

    from ..ops.textures import random_texture

    # oversized canvas so object-tracked sampling stays in bounds
    return np.asarray(random_texture(jax.random.PRNGKey(key_seed), 2 * H, 2 * W))


def texture_sequence(mask_paths: list[str], out_dir: str, seed: int) -> None:
    """Assemble textured RGB frames for one sequence of annotation masks."""
    from ..io.image import load_mask

    masks = [load_mask(p) for p in mask_paths]
    H, W = masks[0].shape
    ids = sorted(set(int(i) for m in masks for i in np.unique(m)) - {0})

    textures = {0: _texture_for(seed * 1000, H, W)}
    for k, oid in enumerate(ids):
        textures[oid] = _texture_for(seed * 1000 + 1 + k, H, W)

    # reference centroid per object from the first frame it appears in
    ref_centroid = {}
    for oid in ids:
        for m in masks:
            ys, xs = np.where(m == oid)
            if len(ys):
                ref_centroid[oid] = (float(ys.mean()), float(xs.mean()))
                break

    yy, xx = np.mgrid[0:H, 0:W]
    os.makedirs(out_dir, exist_ok=True)
    for t, (m, p) in enumerate(zip(masks, mask_paths)):
        frame = textures[0][H // 2 : H // 2 + H, W // 2 : W // 2 + W].copy()
        for oid in ids:
            sel = m == oid
            if not sel.any():
                continue
            cy, cx = float(yy[sel].mean()), float(xx[sel].mean())
            r0y, r0x = ref_centroid[oid]
            # sample the object's texture in object-tracked coordinates so it
            # moves rigidly with the mask
            sy = np.clip((yy[sel] - cy + r0y).astype(int) + H // 2, 0, 2 * H - 1)
            sx = np.clip((xx[sel] - cx + r0x).astype(int) + W // 2, 0, 2 * W - 1)
            frame[sel] = textures[oid][sy, sx]
        name = osp.splitext(osp.basename(p))[0]
        save_image(osp.join(out_dir, name + ".jpg"), frame)


def assemble(masks_root: str, output: str, seed: int) -> str:
    """Texture every sequence under masks_root/orgMasks; returns the new
    input root (textured orgRGB + linked orgMasks)."""
    src = osp.join(masks_root, ORGMASK)
    troot = osp.join(output, "textured")
    for dirpath, dirs, files in os.walk(src):
        pngs = sorted(osp.join(dirpath, f) for f in files if f.endswith(".png"))
        if not pngs:
            continue
        rel = osp.relpath(dirpath, src)
        texture_sequence(
            pngs, osp.join(troot, ORGCOLOR, rel),
            seed + zlib.crc32(rel.encode()) % 100000,
        )
        mdir = osp.join(troot, ORGMASK, rel)
        os.makedirs(mdir, exist_ok=True)
        for p in pngs:
            dst = osp.join(mdir, osp.basename(p))
            if not osp.exists(dst):
                os.symlink(osp.abspath(p), dst)
    return troot


def _link_or_copy(src: str, dst: str) -> None:
    os.makedirs(osp.dirname(dst), exist_ok=True)
    if osp.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)  # byte-identical by construction
    except OSError:
        shutil.copy2(src, dst)


def replicate_texture_set(set0_out: str, setk_input: str, setk_out: str,
                          fds: list[int], warp_backend: str = "host") -> int:
    """Texture set k >= 1 of the dual-set D15 layout (README.md:6-31).

    For every pair set 0 produced (its Flow tree is the ground truth of what
    survived the match/filter sweep), re-derive set k's products WITHOUT
    re-solving: Flow + inpMasks + wMasks are hard-linked from set 0 (flow and
    masks are texture-independent — matches depend on appearance, but the
    flow is REUSED, which is the whole point of the shared-Flow layout);
    inpRGB comes from set k's textured frames; wRGB re-applies set 0's .flo
    to set k's frame via the warp tool (run_warp semantics,
    /root/reference/run_warp.py:9-67). Returns the number of pairs written.
    """
    from ..io.image import load_image, load_rgb, save_image
    from .warp_tool import warp_image

    n = 0
    for fd in fds:
        flow_root = osp.join(set0_out, f"fd{fd}", FLOW_DIR)
        if not osp.isdir(flow_root):
            continue
        for dirpath, _, files in os.walk(flow_root):
            rel = osp.relpath(dirpath, flow_root)
            for f in sorted(files):
                if not f.endswith(".flo"):
                    continue
                name = osp.splitext(f)[0]
                flo0 = osp.join(dirpath, f)
                out_fd = osp.join(setk_out, f"fd{fd}")
                # shared, texture-independent products: hard-linked
                _link_or_copy(flo0, osp.join(out_fd, FLOW_DIR, rel, f))
                for d in (MASK_DIR, WMASK_DIR):
                    src = osp.join(set0_out, f"fd{fd}", d, rel, name + ".png")
                    if osp.exists(src):
                        _link_or_copy(src,
                                      osp.join(out_fd, d, rel, name + ".png"))
                # set k's own appearance products. The frame must pass the
                # SAME preprocessing set 0's pipeline applied (portrait
                # transpose, para_gen.scale_rotate:122-135) or set-k's
                # inpRGB/wRGB would be geometrically inconsistent with the
                # linked set-0 Flow/masks (dmo_gen has no --size, so resize
                # never applies here — only the transpose path can trigger).
                src_rgb = osp.join(setk_input, ORGCOLOR, rel, name + ".jpg")
                src_msk = osp.join(setk_input, ORGMASK, rel, name + ".png")
                inp_rgb = osp.join(out_fd, COLOR_DIR, rel, name + ".png")
                os.makedirs(osp.dirname(inp_rgb), exist_ok=True)
                _, im, _ = scale_rotate(load_rgb(src_rgb),
                                        load_image(src_msk), None)
                save_image(inp_rgb, im)
                # warp mask: 0 = object (warp_tool convention) from the
                # set-0 inpMask (0 object / 255 background already)
                msk = osp.join(out_fd, MASK_DIR, rel, name + ".png")
                wrgb = osp.join(out_fd, WRGB_DIR, rel, name + ".png")
                wmsk_tmp = osp.join(out_fd, WMASK_DIR, rel,
                                    name + ".setk.tmp.png")
                os.makedirs(osp.dirname(wrgb), exist_ok=True)
                warp_image(inp_rgb, msk, flo0, wrgb, wmsk_tmp, warp_backend)
                os.remove(wmsk_tmp)  # warped mask already linked from set 0
                n += 1
    return n


def run(masks: str, output: str, fds: list[int], seed: int = 0,
        multseg: bool = False, schedule: str = "parity",
        mode: str = "simple", texture_sets: int = 1,
        warp_backend: str = "host", solver_cfg=None) -> None:
    """Programmatic entry (the CLI parses into this). texture_sets >= 2
    produces OUT/set{k}/fd{N} trees with byte-identical Flow across sets."""
    multi = texture_sets > 1
    set_out = [osp.join(output, f"set{k}") if multi else output
               for k in range(texture_sets)]
    # distinct texture seeds per set, same masks
    set_in = [assemble(masks, set_out[k], seed + 7777 * k)
              for k in range(texture_sets)]
    for fd in fds:
        print(f"=== set0 fd{fd} ===")
        flags = PipelineFlags(
            input=set_in[0], output=osp.join(set_out[0], f"fd{fd}"), fd=fd,
            multseg=multseg, schedule=schedule, seed=seed, mode=mode,
        )
        main_pipeline(flags, solver_cfg=solver_cfg)
    for k in range(1, texture_sets):
        print(f"=== set{k}: re-texture + shared-Flow warp ===")
        n = replicate_texture_set(set_out[0], set_in[k], set_out[k], fds,
                                  warp_backend)
        print(f"set{k}: {n} pairs replicated (Flow hard-linked from set0)")


def main(argv=None):
    ap = argparse.ArgumentParser(description="DMO-style textured dataset generation")
    ap.add_argument("--masks", required=True, help="root containing orgMasks/")
    ap.add_argument("--output", required=True)
    ap.add_argument("--fd", nargs="*", type=int, default=[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multseg", action="store_true", default=False)
    ap.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    ap.add_argument("--mode", choices=["simple", "batched"], default="simple")
    ap.add_argument("--texture_sets", type=int, default=1,
                    help=">=2: the reference's dual-texture-set layout "
                    "(D15OM/D15RM, README.md:6-31) — further sets re-texture "
                    "the same masks and share set 0's Flow byte-identically "
                    "(re-warped, not re-solved)")
    ap.add_argument("--warp_backend", choices=["host", "device"],
                    default="host",
                    help="rasterizer for the re-applied warps of sets >= 1")
    a = ap.parse_args(argv)
    run(a.masks, a.output, a.fd, a.seed, a.multseg, a.schedule, a.mode,
        a.texture_sets, a.warp_backend)


if __name__ == "__main__":
    main()

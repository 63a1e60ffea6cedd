"""arap_deform equivalent: ARAP-deform frames and emit flow + warped outputs.

CLI parity with ARAP/deformation/src/main.cpp:162-241:

    # single frame (6 paths)
    python -m arap_flow.pipeline.deform_tool RGB MASK CSTR FLOW WRGB WMASK
    # list file of 6-path lines
    python -m arap_flow.pipeline.deform_tool LISTFILE

The reference resolves an Opt plan file via $ARAP_PLAN (main.cpp:206-213); this
framework has no plan file — the energy is compiled in (ops/energy.py). The
solver schedule (numIter=19, nonLinearIter=8, linearIter=400, main.cpp:215-221)
is the default; --schedule fast enables the PCG ζ early exit.

Like the reference's list mode, frames of identical size share one compiled
program (jit shape cache ≙ plan reuse, CombinedSolver.h:149-160).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

from ..io import flo
from ..io.constraints import read_constraint_file
from ..io.image import load_mask, load_rgb, save_image
from ..models.arap import ArapDeformer
from ..ops.solver import SolverConfig


@dataclass
class FramePaths:
    rgb: str
    mask: str
    cstr: str
    out_flo: str
    out_rgb: str
    out_mask: str


def parse_list_file(path) -> list[FramePaths]:
    frames = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                frames.append(FramePaths(*parts[:6]))
    return frames


def deform_frames(frames: list[FramePaths], cfg: SolverConfig,
                  batch: bool = True, fw=None) -> None:
    """Deform a list of frames, writing .flo + warped RGB/mask per frame.

    Where the reference's list mode merely reuses one compiled plan across
    same-size frames (CombinedSolver.h:149-160), here same-shape frames are
    additionally solved as ONE batched device program (one dispatch and one
    D2H round-trip per chunk instead of per frame). Ragged shapes fall back
    to per-frame solves, which still share jit programs per shape.

    `fw`: utils.config.FrameworkConfig carrying the energy weights and the
    rasterizer choice; ARAP_RASTER=host selects the reference-exact host
    rasterizer, which runs the per-frame path (the batched program rasterizes
    on device)."""
    from ..utils.config import FrameworkConfig

    fw = fw or FrameworkConfig()
    if batch and len(frames) > 1 and fw.raster != "host":
        if _deform_frames_batched(frames, cfg, fw):
            return
    deformer = ArapDeformer(cfg, weights=fw.weights, raster=fw.raster)
    for fr in frames:
        rgb = load_rgb(fr.rgb)
        mask = load_mask(fr.mask)
        cons = read_constraint_file(fr.cstr)
        res = deformer.deform(rgb, mask, cons)
        _write_result(fr, res)


def _write_result(fr: FramePaths, res) -> None:
    flo.flow_write(fr.out_flo, res.flow)
    save_image(fr.out_rgb, res.warped_rgb)
    save_image(fr.out_mask, res.warped_mask)
    print("Saved")


def _deform_frames_batched(frames: list[FramePaths], cfg: SolverConfig,
                           fw=None) -> bool:
    """Batched full-frame path: group frames by shape, solve each group with
    solve_and_raster_batch in memory-bounded chunks. Returns False if nothing
    batches (caller runs the serial path)."""
    from ..utils.config import FrameworkConfig

    fw = fw or FrameworkConfig()
    import numpy as np

    import jax
    import jax.numpy as jnp

    from ..io.constraints import add_border_pins
    from ..models.arap import DeformResult, solve_and_raster_batch
    from ..ops import energy as E
    from .batch import max_chunk_for

    from ..io.image import image_size

    # grouping pass reads only image headers, so a long Sintel list never
    # holds more than one chunk of frames resident
    groups: dict[tuple, list[int]] = {}
    for i, fr in enumerate(frames):
        w, h = image_size(fr.mask)
        groups.setdefault((h, w), []).append(i)

    if all(len(idx) < 2 for idx in groups.values()):
        return False

    deformer = ArapDeformer(cfg, weights=fw.weights)

    def _serial(i):
        fr = frames[i]
        _write_result(
            fr,
            deformer.deform(
                load_rgb(fr.rgb), load_mask(fr.mask),
                read_constraint_file(fr.cstr),
            ),
        )

    for shape, idxs in groups.items():
        if len(idxs) < 2:
            _serial(idxs[0])
            continue
        H, W = shape
        step = max_chunk_for((H, W))
        for c0 in range(0, len(idxs), step):
            chunk = idxs[c0 : c0 + step]
            try:
                ops = []
                rgbs = []
                for i in chunk:
                    fr = frames[i]
                    rgb = load_rgb(fr.rgb)
                    mask = load_mask(fr.mask)
                    cons = add_border_pins(
                        np.asarray(
                            read_constraint_file(fr.cstr), np.int32
                        ).reshape(-1, 4), W, H)
                    ops.append(E.build_compact(mask, cons, fw.weights))
                    rgbs.append(np.ascontiguousarray(rgb.transpose(2, 0, 1)))
                n_real = len(ops)
                # pad partial chunks by repeating the last frame: one compiled
                # batch shape per frame size (a wasted duplicate solve is
                # cheap; a novel batch shape costs a 10-300s compile here)
                while len(ops) < min(step, len(idxs)):
                    ops.append(ops[-1])
                    rgbs.append(rgbs[-1])
                # host-side stacks: one fresh default-layout upload per chunk
                # (eager jnp.stack of device arrays mints utility programs
                # and re-fingerprints the solve executable — see
                # energy.build_compact)
                batched = jax.tree.map(lambda *ls: np.stack(ls), *ops)
                _, flows, wrgbs, wmasks = solve_and_raster_batch(
                    batched, np.stack(rgbs), cfg)
                flows = np.asarray(flows)
                wrgbs = np.asarray(wrgbs)
                wmasks = np.asarray(wmasks)
                for j, i in enumerate(chunk[:n_real]):
                    res = DeformResult(
                        flow=flows[j].transpose(1, 2, 0),
                        warped_rgb=wrgbs[j].transpose(1, 2, 0).astype(np.uint8),
                        warped_mask=wmasks[j].astype(np.uint8),
                    )
                    _write_result(frames[i], res)
            except Exception as e:  # failure isolation: retry frame-by-frame
                print(f"batched chunk failed ({e!r}); falling back to serial")
                for i in chunk:
                    _serial(i)
    return True


def make_config(schedule: str) -> SolverConfig:
    if schedule == "parity":
        return SolverConfig()
    return SolverConfig(q_tolerance=1e-4)


def make_framework_config(schedule: str):
    """FrameworkConfig for this tool: CLI --schedule gives the base solver,
    ARAP_* env vars override on top (ARAP_SCHEDULE / ARAP_BACKEND /
    ARAP_RASTER / ARAP_W_FIT / ARAP_W_REG — the unified config per SURVEY §5;
    env precedence mirrors $ARAP_PLAN, main.cpp:206-213)."""
    from ..utils.config import FrameworkConfig

    return FrameworkConfig.from_env(solver=make_config(schedule))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ARAP-deform frames: constraints + mask -> flow + warped outputs."
    )
    p.add_argument("paths", nargs="+",
                   help="either 6 paths (RGB Mask Cstr Flow wRGB wMask) or one list file")
    p.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    a = p.parse_args(argv)

    if len(a.paths) == 6:
        frames = [FramePaths(*a.paths)]
    elif len(a.paths) == 1:
        frames = parse_list_file(a.paths[0])
    else:
        p.error("expected 6 paths or a single list file")
    if not frames:
        p.error("no frames to process")
    fw = make_framework_config(a.schedule)
    deform_frames(frames, fw.solver, fw=fw)


if __name__ == "__main__":
    main()

"""Smoke run of the pair pipeline on the GPU, at the product's real size.

    python chip_smoke.py          # one GPU: phases 1-3
    python chip_smoke.py --four   # four GPUs: phase 4 only

1. Device: refuses to run unless JAX's default backend is a GPU; prints the
   device kind, the device count and nvidia-smi's name and power limit.
2. Pipeline: a seeded synthetic DAVIS-style tree (854x480 PNG frames, two
   objects per frame: one rigid, one non-rigid) through
   pipeline/para_gen.main_pipeline in --mode batched --multseg with the
   full 19x8x400 parity schedule and the native matcher, writing .flo and
   PNG products. One cold run, then one warm run.
3. Accuracy: every segment's constraints, as the pipeline cached them in
   tmpCnstr/, are solved again by the plain reference — a full-frame,
   unbatched float64 ops/solver.solve — and its flow, composed as the
   pipeline composes segments, is compared with the warm run's .flo on each
   segment's pixels. Then the analytic-motion check of
   scripts/pipeline_bench.check_flow_accuracy.
4. (--four) The same tree in --mode sharded over a 4-GPU 'data' mesh
   against --mode batched on one GPU: byte-identical products, or failing
   that flows that agree within the phase-3 tolerance.

Every phase prints one line with its wall time. The last line of standard
output is one JSON object {"ok": true, "device": {...}}; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import sys
import tempfile
import time

import jax
import numpy as np

REPO = osp.dirname(osp.abspath(__file__))
N_PAIRS = 8

# Tolerance of the timed path against the float64 reference, in px of EPE.
# Base: the float32-vs-float64 bound of the same solve on CPU
# (tests/test_f64.py: max < 0.05 px, median < 1e-3 px). Added: the batched
# path ships flow as int16 fixed point at 1/64 px (models/arap.py), which
# moves each component by up to 1/128 px, so a pixel's EPE by up to
# sqrt(2)/128 px.
QUANT_EPE = np.sqrt(2.0) / 128.0
TOL_MAX = 0.05 + QUANT_EPE
TOL_MEAN = 1e-3 + QUANT_EPE


def _say(msg: str) -> None:
    print(msg, flush=True)


def _scripts():
    sys.path.insert(0, osp.join(REPO, "scripts"))
    import pipeline_bench

    return pipeline_bench


def _run_pipeline(data: str, out: str, mode: str, cfg=None) -> int:
    from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

    flags = PipelineFlags(input=data, output=out, fd=1, multseg=True,
                          seed=0, mode=mode)
    return len(main_pipeline(flags, solver_cfg=cfg))


def _dilate(m: np.ndarray) -> np.ndarray:
    out = m.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= np.roll(np.roll(m, dy, 0), dx, 1)
    return out


@jax.jit
def _raster_mask(warp, arap_mask):
    """Warped-object mask of a full-frame warp (the pipeline's device
    rasterizer, colour planes unused)."""
    import jax.numpy as jnp

    from arap_flow.ops import rasterize as R

    return R.rasterize(warp, jnp.zeros((3, *arap_mask.shape)), arap_mask)[1]


def reference_flows(data: str, out: str, cfg, name: str):
    """Plain reference for one pair: per segment (in the pipeline's compose
    order) the float64 full-frame flow (H, W, 2) and its warped mask.
    Segments come from the original annotation mask at each cached
    constraint's source pixel (the pipeline's filter rule)."""
    import jax.numpy as jnp

    from arap_flow.io.constraints import add_border_pins, read_constraint_file
    from arap_flow.io.image import load_mask
    from arap_flow.ops import energy as E
    from arap_flow.ops import solver as S

    mk1 = load_mask(osp.join(data, "orgMasks", "seq0", name + ".png"))
    cons = read_constraint_file(osp.join(out, "tmpCnstr", "seq0",
                                         name + ".txt"))
    seg_of = mk1[cons[:, 1], cons[:, 0]]
    hh, ww = mk1.shape
    segs = []
    for s in np.unique(seg_of):
        arap_mask = np.where(mk1 == s, 0, 255).astype(np.uint8)
        pinned = add_border_pins(cons[seg_of == s], ww, hh)
        with jax.enable_x64():
            ops = E.build_operands(arap_mask, pinned, dtype=np.float64)
            x, flow = S.solve(ops, cfg)
            x = np.asarray(x)
            flow = np.asarray(flow).transpose(1, 2, 0)
        wmask = _raster_mask(jnp.asarray(x[:2], jnp.float32),
                       jnp.asarray(arap_mask != 0, jnp.float32))
        segs.append((int(s), flow, np.asarray(wmask) != 0))
    return mk1, segs


def compare_to_reference(data: str, out: str, cfg) -> dict:
    """EPE of every pair's .flo against the composed float64 reference, on
    the pixels of each segment that the composition takes from that
    segment. The composition (pipeline/para_gen.finish_pair) lets a later
    segment's warped mask override earlier flow, so a pixel at the edge of
    a warped mask switches segments under a sub-pixel change of the flow:
    a 1-px band around every overriding warped mask is left out."""
    from arap_flow.io import flo as flo_io

    names = sorted(f[:-4] for f in os.listdir(osp.join(out, "Flow", "seq0"))
                   if f.endswith(".flo"))
    errs, per_seg = [], {}
    for name in names:
        mk1, segs = reference_flows(data, out, cfg, name)
        flow = segs[0][1].copy()
        owner = np.full(mk1.shape, segs[0][0])
        band = np.zeros(mk1.shape, bool)
        for s, f_s, w_s in segs[1:]:
            flow[w_s] = f_s[w_s]
            owner[w_s] = s
            band |= _dilate(w_s) & _dilate(~w_s)
        u, v = flo_io.flow_read(osp.join(out, "Flow", "seq0", name + ".flo"))
        epe = np.hypot(u - flow[..., 0], v - flow[..., 1])
        for s, _, _ in segs:
            sel = (mk1 == s) & (owner == s) & ~band
            e = epe[sel]
            errs.append(e)
            n, tot, mx = per_seg.get(s, (0, 0.0, 0.0))
            per_seg[s] = (n + e.size, tot + float(e.sum()),
                          max(mx, float(e.max(initial=0.0))))
    e = np.concatenate(errs)
    return {
        "pairs": len(names),
        "pixels": int(e.size),
        "mean_epe": float(e.mean()),
        "max_epe": float(e.max()),
        "per_segment": {s: {"pixels": n, "mean_epe": t / max(n, 1),
                            "max_epe": m}
                        for s, (n, t, m) in sorted(per_seg.items())},
    }


def _compile_log() -> list:
    """(function, seconds) of every XLA compile from here on."""
    events = []

    def listen(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            events.append((str(kw.get("fun_name", "?")), float(duration)))

    jax.monitoring.register_event_duration_secs_listener(listen)
    return events


def _single(work: str) -> None:
    from arap_flow.models.arap import PROGRAM_KEYS
    from arap_flow.native.runtime import native_available
    from arap_flow.ops.solver import SolverConfig

    bench = _scripts()
    cfg = SolverConfig()
    data = osp.join(work, "data")
    t0 = time.time()
    bench.make_dataset(data, N_PAIRS + 1)
    native = native_available()
    t_data = time.time() - t0
    compiles = _compile_log()
    t1 = time.time()
    n_cold = _run_pipeline(data, osp.join(work, "cold"), "batched")
    t_cold = time.time() - t1
    cold_compiles = list(compiles)
    t1 = time.time()
    n_warm = _run_pipeline(data, osp.join(work, "warm"), "batched")
    t_warm = time.time() - t1
    solve_compiles = [c for c in cold_compiles if "canvas" in c[0]]
    _say(f"phase pipeline: {n_cold} pairs cold in {t_cold:.2f} s, "
         f"{n_warm} pairs warm in {t_warm:.2f} s "
         f"({n_warm / t_warm:.3f} pairs/s warm), native library "
         f"{'loaded' if native else 'NOT loaded (numpy fallback)'}, "
         f"dataset {t_data:.2f} s")
    _say(f"  cold compiles: {len(cold_compiles)} programs, "
         f"{sum(s for _, s in cold_compiles):.2f} s; solve programs "
         + ", ".join(f"{s:.2f}" for _, s in solve_compiles)
         + f" s; warm run compiled {len(compiles) - len(cold_compiles)}")
    _say("  solve program keys (solve bucket, canvas, transposed, B): "
         + "; ".join(f"{k[0][1:]} {k[1]} {k[2]} {k[0][0]}"
                     for k in PROGRAM_KEYS))
    if n_cold != N_PAIRS or n_warm != N_PAIRS:
        raise SystemExit(f"expected {N_PAIRS} pairs, got {n_cold}/{n_warm}")

    t1 = time.time()
    stats = compare_to_reference(data, osp.join(work, "warm"), cfg)
    _say(f"phase accuracy: float64 reference over {stats['pairs']} pairs, "
         f"{stats['pixels']} segment pixels: mean EPE "
         f"{stats['mean_epe']:.6f} px (tolerance {TOL_MEAN:.6f}), max EPE "
         f"{stats['max_epe']:.6f} px (tolerance {TOL_MAX:.6f}) in "
         f"{time.time() - t1:.2f} s")
    for s, st in stats["per_segment"].items():
        _say(f"  segment {s}: {st['pixels']} px, mean EPE "
             f"{st['mean_epe']:.6f}, max EPE {st['max_epe']:.6f}")
    bench.check_flow_accuracy(osp.join(work, "warm"), data)
    if not (stats["mean_epe"] <= TOL_MEAN and stats["max_epe"] <= TOL_MAX):
        raise SystemExit("timed path disagrees with the float64 reference")


def _four(work: str) -> None:
    from arap_flow.io import flo as flo_io

    bench = _scripts()
    data = osp.join(work, "data")
    bench.make_dataset(data, N_PAIRS + 1)
    times = {}
    for mode in ("batched", "sharded"):
        t1 = time.time()
        n = _run_pipeline(data, osp.join(work, mode), mode)
        times[mode] = time.time() - t1
        if n != N_PAIRS:
            raise SystemExit(f"--mode {mode}: {n} of {N_PAIRS} pairs")
    same, differ, max_epe = 0, [], 0.0
    root_b = osp.join(work, "batched")
    for sub in ("Flow", "wRGB", "wMasks", "inpRGB", "inpMasks"):
        for d, _, files in os.walk(osp.join(root_b, sub)):
            for f in files:
                pb = osp.join(d, f)
                ps = osp.join(work, "sharded", osp.relpath(pb, root_b))
                with open(pb, "rb") as fb, open(ps, "rb") as fs:
                    if fb.read() == fs.read():
                        same += 1
                        continue
                differ.append(osp.relpath(pb, root_b))
                if f.endswith(".flo"):
                    ub, vb = flo_io.flow_read(pb)
                    us, vs = flo_io.flow_read(ps)
                    max_epe = max(max_epe,
                                  float(np.hypot(ub - us, vb - vs).max()))
    _say(f"phase four: batched on 1 GPU {times['batched']:.2f} s, sharded "
         f"over 4 GPUs {times['sharded']:.2f} s (both cold); {same} product "
         f"files byte-identical, {len(differ)} differ; max flow EPE between "
         f"them {max_epe:.6f} px (tolerance {TOL_MAX:.6f})")
    for p in differ[:20]:
        _say(f"  differs: {p}")
    if max_epe > TOL_MAX:
        raise SystemExit("sharded and batched flows disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="compare --mode sharded over 4 GPUs with --mode "
                    "batched on one (this phase only)")
    args = ap.parse_args(argv)

    t0 = time.time()
    sys.path.insert(0, REPO)
    from arap_flow.utils.device import require_gpu

    dev = require_gpu(4 if args.four else 1)
    if args.four and dev["count"] != 4:
        raise SystemExit(f"--four needs exactly 4 GPUs, found {dev['count']}")
    _say(f"phase device: {dev['platform']} {dev['kind']} x{dev['count']} "
         f"in {time.time() - t0:.2f} s")
    _say(dev["smi"])

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            _four(work)
        else:
            _single(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _say(f"total {time.time() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

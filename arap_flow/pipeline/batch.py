"""Bucketed batch execution of (frame, segment) ARAP problems.

The reference keeps each GPU busy with one solve at a time, fed by worker
processes and tmp list files (para_gen.py:560-567, --narap buffering). Here
each segment is cropped to a TIGHT bucket-aligned solve box (exact — inert
excluded pixels, docs/PARITY.md lemmas) paired with a larger
displacement-padded CANVAS box for rasterization; tasks group by that
(solve, canvas) bucket pair and each group runs as ONE batched compiled
program (models/arap.py:solve_and_raster_canvas), the per-problem solves
vmapped side by side. BatchRunner streams: chunks dispatch the moment they
fill, remainders pad up a bounded batch-size ladder, fetches happen in
collect(). Segments too large for any bucket fall back to a single
full-frame solve."""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..io.constraints import add_border_pins
from ..models.arap import DeformResult, pick_bucket, _solve_and_raster
from ..ops import energy as E
from ..ops.solver import SolverConfig

# bucket shapes (H, W) covering typical DAVIS segments
from ..models.arap import CROP_BUCKETS as DEFAULT_BUCKETS

# one lock per compiled-program signature, PROCESS-WIDE (runner instances are
# per-chunk, so instance-level locks would never see each other): a
# concurrent same-signature dispatch from another thread during a cold
# compile misses the not-yet-populated jit cache and compiles the SAME
# executable again. Warm dispatches only pay an enqueue under the lock.
import threading as _threading

_SIG_LOCKS: dict[tuple, _threading.Lock] = {}
_SIG_MUTEX = _threading.Lock()

# --warmup subset: the full ladder is wide (31 shapes — tight fits are worth
# ~15-30% solve area); precompiling all of it would cost 30+ cold compiles,
# so prewarm covers the historically common mid-size shapes and the rest
# compile on demand (one-time, persisted by the jit cache)
PREWARM_BUCKETS: tuple = (
    (128, 256), (160, 256), (192, 256), (128, 384), (160, 384), (192, 384),
    (208, 384), (224, 384), (256, 384), (256, 512), (320, 512), (384, 640),
    (512, 896),
)


# per-device batch cap: compile time grows with the batch. 24 predates the
# GPU port; re-deriving it from a sweep on the card is open work.
MAX_CHUNK = 24
# share of one device's memory a chunk's solve may hold, and the f32 planes
# a problem keeps live in the vmapped solve+raster program (operands, PCG
# state and temporaries, with the raster canvas) — an upper estimate
CHUNK_MEM_SHARE = 0.25
PLANES_PER_PROBLEM = 64
# memory assumed when the device reports none (the CPU backend)
_DEFAULT_DEVICE_BYTES = 16 << 30


@lru_cache(maxsize=None)
def device_bytes() -> int:
    """Memory one device lets this process allocate (its `bytes_limit`)."""
    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", _DEFAULT_DEVICE_BYTES))


def max_chunk_for(bucket: tuple, n_data: int = 1,
                  mem_bytes: int | None = None) -> int:
    """Largest batch of this bucket shape per chunk: MAX_CHUNK problems per
    device, fewer when their planes would exceed CHUNK_MEM_SHARE of the
    device's memory (`mem_bytes`, default device_bytes()). `n_data`
    (sharded runs) multiplies the global batch: the budget is per device."""
    if mem_bytes is None:
        mem_bytes = device_bytes()
    bh, bw = bucket
    per_problem = PLANES_PER_PROBLEM * bh * bw * 4
    fit = int(CHUNK_MEM_SHARE * mem_bytes) // per_problem
    return n_data * max(1, min(MAX_CHUNK, fit))


@dataclass
class SegmentTask:
    """One segment solve request (frame-pair index, segment id, crops).

    The SOLVE box (y0/x0/bucket) is the tight object bucket the deep PCG
    kernel runs on; the CANVAS box (cy0/cx0/canvas ⊇ solve box) additionally
    has the directional displacement margins where warped pixels land — the
    rasterizer draws on the canvas, the solver never pays for it."""

    pair_idx: int
    seg_id: int
    frame_hw: tuple
    y0: int
    x0: int
    bucket: tuple
    cy0: int
    cx0: int
    canvas: tuple
    ops: E.ArapOperands
    rgb: jnp.ndarray  # (3, h, w) cropped uint8 (device-cast to f32)
    # when True the solver operands (and the PCG solve) are TRANSPOSED
    # relative to the canonical (bucket-shaped) solve box: wide-flat objects
    # solve on a tall-narrow bucket with fewer padded lanes; the program
    # transposes the warp field back before rasterization (the ARAP energy
    # is reflection-conjugate: same linear systems up to variable order)
    transposed: bool = False


def make_task(
    pair_idx: int,
    seg_id: int,
    rgb: np.ndarray,
    arap_mask: np.ndarray,
    cons: np.ndarray,
    weights: E.ArapWeights,
    buckets=DEFAULT_BUCKETS,
    pin_border: bool = True,
    margin: int = 8,
    solve_margin: int = 2,
) -> SegmentTask | None:
    """Crop a segment problem into the smallest fitting solve/canvas bucket
    pair (None -> use a full-frame fallback).

    `margin` pads the CANVAS (raster landing area beyond the directional
    displacement bounds — the solver can overshoot sampled constraint
    displacements slightly under rotation); `solve_margin` pads the SOLVE
    box, where exactness only needs a 1-px excluded rim (inert-pixel +
    border-pin lemmas, docs/PARITY.md) — keeping it tight drops segments
    into smaller buckets for the deep PCG kernel."""
    from ..models.arap import place_span

    H, W = arap_mask.shape
    cons = np.asarray(cons, np.int32).reshape(-1, 4)
    if pin_border:
        cons = add_border_pins(cons, W, H)
    obj_y, obj_x = np.where(arap_mask == 0)
    if len(obj_y) == 0:
        return None
    bbox = (int(obj_y.min()), int(obj_y.max()),
            int(obj_x.min()), int(obj_x.max()))
    cbox = pick_bucket(arap_mask, cons, buckets, margin=margin, bbox=bbox)
    if cbox is None:
        return None
    cy0, cx0, ch, cw = cbox

    # tight solve box: object bbox + solve_margin only (the displacement pads
    # are masked-inert for the solve — exactness lemmas, docs/PARITY.md) —
    # placed INSIDE the canvas box
    ylo = max(bbox[0] - solve_margin, cy0)
    yhi = min(bbox[1] + 1 + solve_margin, cy0 + ch)
    xlo = max(bbox[2] - solve_margin, cx0)
    xhi = min(bbox[3] + 1 + solve_margin, cx0 + cw)
    hn, wn = yhi - ylo, xhi - xlo
    # smallest solve bucket over BOTH orientations: a wide-flat object whose
    # width wastes padded lanes often fits a tall-narrow bucket transposed
    # (canonical footprint (bh, bw) = bucket (sw, sh)); the kernel cost is
    # proportional to bucket area, the reflection is exact (same systems up
    # to variable order — tests/test_crop.py)
    fits = [
        (sh * sw, sh, sw, False)
        for sh, sw in buckets
        if hn <= sh <= ch and wn <= sw <= cw
    ] + [
        (sh * sw, sw, sh, True)
        for sh, sw in buckets
        if wn <= sh <= cw and hn <= sw <= ch
    ]
    if not fits:
        bh, bw, transposed = ch, cw, False
    else:
        _, bh, bw, transposed = min(fits)
    y0 = min(max(place_span(ylo, yhi, bh, H), cy0), cy0 + ch - bh)
    x0 = min(max(place_span(xlo, xhi, bw, W), cx0), cx0 + cw - bw)

    sub_mask = np.ascontiguousarray(arap_mask[y0 : y0 + bh, x0 : x0 + bw])
    sub_rgb = np.ascontiguousarray(rgb[y0 : y0 + bh, x0 : x0 + bw])
    shifted = cons.copy()
    shifted[:, [0, 2]] -= x0
    shifted[:, [1, 3]] -= y0
    inside = (
        (shifted[:, 0] >= 0) & (shifted[:, 0] < bw)
        & (shifted[:, 1] >= 0) & (shifted[:, 1] < bh)
    )
    # compact operands + u8 RGB: ~8x less H2D per task (the expansion runs
    # on device inside the jitted solve program, models/arap.py:_expand)
    if transposed:
        # solver-side problem is the transpose: swap x/y in mask + cons
        cons_t = shifted[inside][:, [1, 0, 3, 2]]
        ops = E.build_compact(np.ascontiguousarray(sub_mask.T), cons_t,
                              weights)
    else:
        ops = E.build_compact(sub_mask, shifted[inside], weights)
    return SegmentTask(
        pair_idx=pair_idx,
        seg_id=seg_id,
        frame_hw=(H, W),
        y0=y0,
        x0=x0,
        bucket=(bh, bw),
        cy0=cy0,
        cx0=cx0,
        canvas=(ch, cw),
        ops=ops,
        # host numpy: uploaded once per CHUNK by the jitted dispatch
        # (BatchRunner._dispatch) after np.stack
        rgb=np.ascontiguousarray(sub_rgb.transpose(2, 0, 1)),
        transposed=transposed,
    )


class BatchRunner:
    """Streaming bucketed execution: add tasks as host prep produces them;
    a bucket's chunk is DISPATCHED the moment it fills, so the device chews
    on earlier chunks while the host still preps later ones (the reference
    keeps GPUs fed the same way with --narap buffered pairs,
    para_gen.py:560-567). finish() pads the remainders up a bounded
    batch-size ladder, fetches everything, and pastes into full-frame
    canvases.
    """

    def __init__(self, cfg: SolverConfig, timer=None, mesh=None,
                 weights: E.ArapWeights = E.ArapWeights()):
        from ..utils.profiling import StageTimer

        self.cfg = cfg
        self.timer = timer if timer is not None else StageTimer()
        self.mesh = mesh
        self.weights = weights
        self.n_data = 1 if mesh is None else mesh.shape["data"]
        self.buffers: dict[tuple, list[SegmentTask]] = {}
        self.pending: list = []
        self.out: dict[tuple, DeformResult] = {}

    def _ladder(self, step: int) -> list[int]:
        # bounded batch-size ladder per bucket: at most ~8 compiled batch
        # shapes (each a separate compile) and at most ~33%
        # duplicate-solve waste (the old pad-to-step rule wasted up to
        # step-2 solves, e.g. 8 real tasks padded to a step of 9).
        # Sharded runs need multiples of the 'data' axis — every entry is.
        return sorted(
            {min(self.n_data * s, step) for s in (1, 2, 4, 6, 8, 12, 16, 24)}
        )

    def _dispatch(self, key, chunk_tasks, n_real):
        from ..models.arap import solve_and_raster_canvas

        # include everything that keys a distinct executable: mesh shape
        # participates via _canvas_sharded_fn, cfg via static_key
        sig = (key, len(chunk_tasks), self.n_data, self.cfg.static_key)
        with _SIG_MUTEX:
            lock = _SIG_LOCKS.setdefault(sig, _threading.Lock())
        with self.timer.stage("upload+stack"):
            # HOST-side stacking: the jitted call below uploads each stacked
            # array once, as a fresh default-layout buffer (an eager
            # jnp.stack of per-task device arrays would compile a utility
            # program per shape).
            batched_ops = jax.tree.map(
                lambda *ls: np.stack(ls), *[t.ops for t in chunk_tasks]
            )
            rgb_b = np.stack([t.rgb for t in chunk_tasks])
            offs = np.asarray(
                [(t.y0 - t.cy0, t.x0 - t.cx0) for t in chunk_tasks],
                np.int32,
            )
        # the lock spans the jit CALL: a concurrent same-signature call from
        # the other thread would re-compile the executable (see __init__)
        with lock, self.timer.stage("solve+raster dispatch"):
            flows, wrgbs, wmasks = solve_and_raster_canvas(
                batched_ops, rgb_b, offs, self.cfg,
                canvas_hw=chunk_tasks[0].canvas, mesh=self.mesh,
                transposed=chunk_tasks[0].transposed,
            )
        self.pending.append((chunk_tasks, n_real, flows, wrgbs, wmasks))

    def add(self, task: SegmentTask) -> None:
        key = (task.bucket, task.canvas, task.transposed)
        buf = self.buffers.setdefault(key, [])
        buf.append(task)
        step = max_chunk_for(task.bucket, self.n_data)
        if len(buf) >= step:
            self._dispatch(key, buf[:step], step)
            del buf[:step]

    def add_fallback(self, pair_idx, seg_id, rgb, arap_mask, cons,
                     pin_border: bool = True) -> None:
        """Full-frame fallback solve (async dispatch; fetched in finish).

        Pins the image border itself (same contract as make_task/add —
        main.cpp:95-101 always pins); pass pin_border=False only when the
        constraints already carry the border pins."""
        if pin_border:
            H, W = np.asarray(arap_mask).shape
            cons = add_border_pins(np.asarray(cons, np.int32).reshape(-1, 4),
                                   W, H)
        ops = E.build_compact(np.asarray(arap_mask), cons, self.weights)
        rgb_u8 = jnp.asarray(np.ascontiguousarray(rgb.transpose(2, 0, 1)))
        _, flow, wrgb, wmask = _solve_and_raster(ops, rgb_u8, self.cfg)
        self.pending.append(((pair_idx, seg_id), None, flow, wrgb, wmask))

    def flush(self) -> None:
        """Dispatch buffered remainders (padded up the ladder by repeating
        the last task) WITHOUT fetching — the device starts chewing while
        the caller does other host work; collect() fetches later."""
        for key, buf in self.buffers.items():
            if not buf:
                continue
            step = max_chunk_for(key[0], self.n_data)
            n_real = len(buf)
            target = next(t for t in self._ladder(step) if t >= n_real)
            chunk_tasks = list(buf)
            while len(chunk_tasks) < target:
                chunk_tasks = chunk_tasks + [chunk_tasks[-1]]
            self._dispatch(key, chunk_tasks, n_real)
        self.buffers.clear()

    def finish(self) -> dict[tuple, DeformResult]:
        self.flush()
        return self.collect()

    def _paste_chunk(self, group, n_real, flows, wrgbs, wmasks) -> None:
        """Paste one fetched chunk into full-frame canvases (host numpy).

        One contiguous (B, h, w, c) conversion per chunk (a batched astype/
        ascontiguousarray is one linear pass; the old per-segment strided
        transpose-assignments walked the crop element-wise), then per-segment
        slice writes. i16 fixed-point flow decodes here too: FLOW_I16_SCALE
        is a power of two, so the reciprocal multiply is bit-exact with the
        former divide."""
        with self.timer.stage("host paste"):
            fl = flows[:n_real].transpose(0, 2, 3, 1)
            if fl.dtype == np.int16:  # compact i16 fixed-point flow
                from ..models.arap import FLOW_I16_SCALE

                fl = fl.astype(np.float32)  # contiguous single pass
                fl *= np.float32(1.0 / FLOW_I16_SCALE)
            else:
                fl = np.ascontiguousarray(fl, np.float32)
            rg = np.ascontiguousarray(
                wrgbs[:n_real].transpose(0, 2, 3, 1)
            ).astype(np.uint8, copy=False)
            mk = wmasks[:n_real].astype(np.uint8, copy=False)
            for i, t in enumerate(group[:n_real]):
                H, W = t.frame_hw
                bh, bw = t.bucket
                ch, cw = t.canvas
                flow = np.zeros((H, W, 2), np.float32)
                flow[t.y0 : t.y0 + bh, t.x0 : t.x0 + bw] = fl[i]
                rgb = np.zeros((H, W, 3), np.uint8)
                rgb[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = rg[i]
                mask = np.zeros((H, W), np.uint8)
                mask[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = mk[i]
                self.out[(t.pair_idx, t.seg_id)] = DeformResult(
                    flow=flow, warped_rgb=rgb, warped_mask=mask
                )

    def collect(self) -> dict[tuple, DeformResult]:
        """Fetch every dispatched chunk and paste into full-frame canvases.

        Pastes run in ONE worker thread overlapped with the NEXT chunk's
        D2H fetch, which waits on device completion, so the paste cost
        hides behind it.
        `self.out` is written only by the worker; the final result is read
        after all pastes join."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            futs = []
            for entry in self.pending:
                group, n_real = entry[0], entry[1]
                flows, wrgbs, wmasks = entry[2:]
                if n_real is None:  # fallback: group is the (pair, seg) key
                    with self.timer.stage("D2H fetch"):
                        flow = np.asarray(flows)
                        wrgb = np.asarray(wrgbs)
                        wmask = np.asarray(wmasks)

                    def _assemble(key=group, fl=flow, rg=wrgb, mk=wmask):
                        self.out[key] = DeformResult(
                            flow=fl.transpose(1, 2, 0),
                            warped_rgb=rg.transpose(1, 2, 0).astype(np.uint8),
                            warped_mask=mk.astype(np.uint8),
                        )

                    futs.append(ex.submit(_assemble))
                    continue
                with self.timer.stage("D2H fetch"):
                    f_np = np.asarray(flows)
                    r_np = np.asarray(wrgbs)
                    m_np = np.asarray(wmasks)
                futs.append(
                    ex.submit(self._paste_chunk, group, n_real,
                              f_np, r_np, m_np)
                )
            for f in futs:
                f.result()  # join + propagate paste exceptions
        self.pending.clear()
        return self.out


def run_tasks(
    tasks: list[SegmentTask],
    fallbacks: list[tuple],
    cfg: SolverConfig,
    timer=None,
    mesh=None,
    weights: E.ArapWeights = E.ArapWeights(),
) -> dict[tuple, DeformResult]:
    """Execute bucketed tasks (batched per bucket) + full-frame fallbacks.

    fallbacks: list of (pair_idx, seg_id, rgb, arap_mask, cons-with-pins);
    `weights` applies to the fallback solves (bucketed tasks already carry
    theirs via make_task).
    `timer` (optional StageTimer) records a per-stage breakdown: upload,
    device dispatch, D2H fetch (which also absorbs the wait for device
    completion), and host paste. NOTE: pastes run in a worker
    thread concurrent with the main thread's fetch stage (see collect), so
    stage sums can exceed wall time — 'host paste' is overlapped, not serial.
    `mesh`: optional jax Mesh — bucket batches are sharded over its 'data'
    axis (--mode sharded; the reference's multi-GPU farm, para_gen.py:560-567)
    and chunks are sized/padded to a multiple of the axis size.
    Returns {(pair_idx, seg_id): DeformResult (full-frame canvases)}.
    """
    runner = BatchRunner(cfg, timer=timer, mesh=mesh, weights=weights)
    for t in tasks:
        runner.add(t)
    for pair_idx, seg_id, rgb, arap_mask, cons in fallbacks:
        runner.add_fallback(pair_idx, seg_id, rgb, arap_mask, cons)
    return runner.finish()

"""High-level ARAP deformation model.

Mirrors the arap_deform application flow (ARAP/deformation/src/main.cpp:140-160 +
CombinedSolver.h): load image/mask/constraints → pin the border → solve the
annealed GN/PCG schedule → rasterize the warped image/mask → emit flow.

Where the reference rebuilds its CUDA plan per image size
(CombinedSolver.h:149-160), jax.jit's shape-keyed cache gives the same reuse for
free; `bucket_shape` pads problems to a standard size so many segments share one
compiled executable (padding pixels are excluded by mask and provably inert —
see tests/test_energy.py::test_excluded_pixels_inert).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.constraints import add_border_pins
from ..ops import energy as E
from ..ops import rasterize as R
from ..ops import solver as S
from ..ops.solver import SolverConfig


@dataclass
class DeformResult:
    """Products of one ARAP deformation solve (one frame pair / segment)."""

    flow: np.ndarray  # (H, W, 2) float32, u/v
    warped_rgb: np.ndarray  # (H, W, 3) uint8
    warped_mask: np.ndarray  # (H, W) uint8, 255 = covered
    state: np.ndarray | None = None  # (3, H, W) warp positions + angle


def _expand(ops):
    """Trace-time adapter: CompactOperands expand on device inside the jitted
    program (fewer H2D bytes); full ArapOperands pass through."""
    if isinstance(ops, E.CompactOperands):
        return E.expand_operands(ops)
    return ops


def _to_f32(rgb):
    """u8 RGB uploads (4× less H2D) cast on device; f32 passes through."""
    return rgb.astype(jnp.float32) if rgb.dtype != jnp.float32 else rgb


@partial(jax.jit, static_argnames=("static_key",))
def _solve_and_raster_impl(ops, rgb, dyn, static_key):
    ops = _expand(ops)
    rgb_f = _to_f32(rgb)
    cfg = S._rebuild_config(dyn, static_key)
    x = S.anneal_solve(ops, cfg)
    flow = S.flow_from_state(x, ops)
    arap_mask = 1.0 - ops.mask  # rasterizer wants 0 = object
    wrgb, wmask = R.rasterize(x[:2], rgb_f, arap_mask)
    # uint8 on device: 4x less device->host traffic for the image products
    return x, flow, wrgb.astype(jnp.uint8), wmask.astype(jnp.uint8)


def _mask_shape(ops):
    return (ops.mask_u8 if isinstance(ops, E.CompactOperands) else ops.mask).shape


def _solve_and_raster(ops, rgb_f, cfg: SolverConfig):
    return _solve_and_raster_impl(ops, rgb_f, cfg.dynamic, cfg.static_key)


# fixed crop bucket shapes: a BOUNDED set of compiled program shapes (every
# novel shape costs an XLA compile). Widths step by 128 and heights by 32
# where segments cluster; the ladder predates the GPU port and its spacing
# is not yet measured on the card (padding waste against compile count).
#
# distinct canvas-program keys used this process → first-use wallclock.
# The TRUE executable identity of solve_and_raster_canvas includes its
# STATIC args (canvas_hw, transposed, compact_flow, static_key), which
# jax's compile logs do not print — sustained-run telemetry
# (scripts/endurance.py) compares XLA compile events against this registry
# to detect double-compiles and to time compile-set saturation.
PROGRAM_KEYS: dict = {}

CROP_BUCKETS: tuple = (
    # (rows, cols). The tall-narrow column serves canonical tall objects AND transposed solves of
    # wide-flat objects (pipeline/batch.make_task picks the cheaper
    # orientation). Entries compile on demand; prewarm + the persistent jit
    # cache amortise the ladder's width.
    (64, 128), (96, 128), (128, 128), (160, 128), (192, 128), (224, 128),
    (256, 128), (288, 128), (320, 128), (384, 128), (448, 128), (512, 128),
    (96, 256), (128, 256), (160, 256), (192, 256), (224, 256), (256, 256),
    (320, 256), (384, 256), (128, 384), (160, 384), (192, 384), (208, 384),
    (224, 384), (256, 384), (288, 384), (256, 512), (320, 512), (384, 640),
    (512, 896),
)


def directional_pads(
    cons: np.ndarray, margin: int = 8
) -> tuple[int, int, int, int]:
    """Per-side crop margins (top, bottom, left, right) from the actual
    constraint displacements: the crop only needs landing area where warped
    pixels can actually go (a symmetric max-|disp| pad wastes up to ~25% of
    the solved area; solve exactness itself only needs the 1-px rim —
    docs/PARITY.md exactness lemmas)."""
    if len(cons) == 0:
        return margin, margin, margin, margin
    d = cons[:, 2:4].astype(np.int64) - cons[:, 0:2]
    return (
        margin + int(max(0, -d[:, 1].min())),
        margin + int(max(0, d[:, 1].max())),
        margin + int(max(0, -d[:, 0].min())),
        margin + int(max(0, d[:, 0].max())),
    )


def place_span(lo: int, hi: int, size: int, limit: int) -> int:
    """Start of a `size`-long window covering [lo, hi) inside [0, limit),
    surplus split evenly."""
    start = lo - (size - (hi - lo)) // 2
    return min(max(start, 0), limit - size)


def pick_bucket(
    arap_mask: np.ndarray, cons: np.ndarray, buckets: tuple = CROP_BUCKETS,
    margin: int = 8, bbox: tuple | None = None,
) -> tuple | None:
    """Choose the smallest fixed bucket covering the object bbox + directional
    displacement margins and position it inside the frame. Returns
    (y0, x0, h, w) or None when no bucket fits (caller solves full-frame).
    `bbox` (ymin, ymax, xmin, xmax) skips the np.where scan when the caller
    already has it."""
    H, W = arap_mask.shape
    if bbox is None:
        ys, xs = np.where(arap_mask == 0)
        if len(ys) == 0:
            return None
        bbox = int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())
    ymin, ymax, xmin, xmax = bbox
    pt, pb, pl, pr = directional_pads(cons, margin)
    ylo, yhi = ymin - pt, ymax + 1 + pb
    xlo, xhi = xmin - pl, xmax + 1 + pr
    fit = [
        (bh * bw, bh, bw)
        for bh, bw in buckets
        if yhi - ylo <= bh <= H and xhi - xlo <= bw <= W
    ]
    if not fit:
        return None
    _, bh, bw = min(fit)
    return place_span(ylo, yhi, bh, H), place_span(xlo, xhi, bw, W), bh, bw


def crop_box(
    arap_mask: np.ndarray,
    constraints: np.ndarray,
    margin: int = 8,
    h_mult: int = 64,
    w_mult: int = 128,
    extra: int = 0,
) -> tuple[int, int, int, int]:
    """Tight solve window around the object, bucket-aligned.

    Exactness: excluded pixels (mask != 0) are provably inert (zero residuals,
    zero JtJ coupling — tests/test_energy.py::test_excluded_pixels_inert), and
    border pins only activate on solve-region pixels (CombinedSolver.h:234), so
    any crop containing the whole object + a 1-px rim yields the identical
    linear systems as the full frame. `extra` widens the box (e.g. by the max
    constraint displacement so rasterization keeps landing area). Bucket
    alignment (h_mult × w_mult) maximises jit-cache reuse.

    Returns (y0, x0, h, w).
    """
    H, W = arap_mask.shape
    ys, xs = np.where(arap_mask == 0)
    if len(ys) == 0:
        return 0, 0, H, W
    pad = margin + extra
    y0 = max(0, int(ys.min()) - pad)
    y1 = min(H, int(ys.max()) + 1 + pad)
    x0 = max(0, int(xs.min()) - pad)
    x1 = min(W, int(xs.max()) + 1 + pad)
    h = min(H, int(np.ceil((y1 - y0) / h_mult)) * h_mult)
    w = min(W, int(np.ceil((x1 - x0) / w_mult)) * w_mult)
    # grow symmetrically inside the frame
    y0 = max(0, min(y0 - (h - (y1 - y0)) // 2, H - h))
    x0 = max(0, min(x0 - (w - (x1 - x0)) // 2, W - w))
    return y0, x0, h, w


class ArapDeformer:
    """Reusable deformation solver (the CombinedSolver equivalent).

    One instance holds the solver config and weights; jit caching keys on the
    image shape, so — like the reference's list mode (main.cpp:231-237) — frames
    of the same size reuse the compiled program.
    """

    def __init__(
        self,
        cfg: SolverConfig = SolverConfig(),
        weights: E.ArapWeights = E.ArapWeights(),
        pin_border: bool = True,
        keep_state: bool = False,
        crop: bool = False,
        crop_buckets: tuple = CROP_BUCKETS,
        raster: str = "device",
    ):
        """`raster`: "device" (windowed splat kernel, ≥99.87% mask agreement,
        runs inside the solve program) or "host" (the reference-exact CPU
        quad rasterizer, native/host_raster.py ≡ warping/main.cpp:110-225 —
        the parity-first switch, selectable via ARAP_RASTER=host through
        utils.config.FrameworkConfig)."""
        self.cfg = cfg
        self.weights = weights
        self.pin_border = pin_border
        self.keep_state = keep_state
        if keep_state and crop:
            # the bucketed canvas program returns (flow, wrgb, wmask) only —
            # the solver state never leaves the device on the crop path, so
            # honoring keep_state here is impossible; fail loudly instead of
            # returning DeformResult(state=None) and surprising the caller
            raise ValueError(
                "keep_state=True requires crop=False (the bucketed canvas "
                "path does not fetch the solver state)"
            )
        self.crop = crop
        self.crop_buckets = crop_buckets
        assert raster in ("device", "host"), raster
        self.raster = raster

    def deform(
        self,
        rgb: np.ndarray,
        arap_mask: np.ndarray,
        constraints: np.ndarray,
    ) -> DeformResult:
        """Solve one frame: rgb (H,W,3) u8, arap_mask (H,W) (0 = object),
        constraints (N,4) [x1 y1 x2 y2] WITHOUT border pins (added here, parity
        with main.cpp:95-101)."""
        H, W = arap_mask.shape[:2]
        cons = np.asarray(constraints, np.int32).reshape(-1, 4)
        if self.pin_border:
            cons = add_border_pins(cons, W, H)

        if self.crop:
            res = self._deform_cropped(rgb, arap_mask, cons,
                                       fetch_raster=self.raster != "host")
            if self.raster == "host":
                res = self._host_raster(res, rgb, arap_mask)
            return res

        ops = E.build_compact(np.asarray(arap_mask), cons, self.weights)
        rgb_u8 = jnp.asarray(np.ascontiguousarray(rgb.transpose(2, 0, 1)))
        x, flow, wrgb, wmask = _solve_and_raster(ops, rgb_u8, self.cfg)
        flow_np = np.asarray(flow).transpose(1, 2, 0)
        state = np.asarray(x) if self.keep_state else None
        if self.raster == "host":
            # host re-rasters from the flow — leave the device wrgb/wmask
            # unfetched (products it would immediately discard)
            return self._host_raster(
                DeformResult(flow=flow_np, warped_rgb=None, warped_mask=None,
                             state=state),
                rgb, arap_mask,
            )
        return DeformResult(
            flow=flow_np,
            warped_rgb=np.asarray(wrgb).transpose(1, 2, 0).astype(np.uint8),
            warped_mask=np.asarray(wmask).astype(np.uint8),
            state=state,
        )

    @staticmethod
    def _host_raster(res: DeformResult, rgb, arap_mask) -> DeformResult:
        """Replace the device-raster products with the reference-exact host
        rasterization of the solved flow (warpField = flow + grid,
        warping/main.cpp:159-166; pixel-for-pixel parity validated in
        tests/test_native.py / tests/test_rasterize.py)."""
        from ..native.host_raster import warp_from_flow
        from ..native.runtime import rasterize_warp

        warp = warp_from_flow(res.flow)
        wrgb, wmask = rasterize_warp(
            warp, np.asarray(rgb, np.uint8), np.asarray(arap_mask)
        )
        return DeformResult(flow=res.flow, warped_rgb=wrgb, warped_mask=wmask,
                            state=res.state)

    def _deform_cropped(self, rgb, arap_mask, cons,
                        fetch_raster: bool = True) -> DeformResult:
        """Solve on the object's TIGHT bucket and rasterize on the padded
        canvas bucket (same decoupled path as the batched pipeline — the
        deep PCG kernel never pays for the displacement landing margins;
        exactness: docs/PARITY.md lemmas), pasting products back into
        full-frame canvases. `fetch_raster=False` (host-raster callers)
        skips the device wrgb/wmask D2H — the caller re-rasters from flow."""
        from ..pipeline.batch import make_task

        H, W = arap_mask.shape[:2]
        t = make_task(0, 0, rgb, arap_mask, cons, self.weights,
                      buckets=self.crop_buckets, pin_border=False)
        if t is None:
            # no bucket fits: full-frame solve
            ops = E.build_compact(np.asarray(arap_mask), cons, self.weights)
            rgb_u8 = jnp.asarray(np.ascontiguousarray(rgb.transpose(2, 0, 1)))
            _, flow, wrgb, wmask = _solve_and_raster(ops, rgb_u8, self.cfg)
            return DeformResult(
                flow=np.asarray(flow).transpose(1, 2, 0),
                warped_rgb=(
                    np.asarray(wrgb).transpose(1, 2, 0).astype(np.uint8)
                    if fetch_raster else None
                ),
                warped_mask=(
                    np.asarray(wmask).astype(np.uint8) if fetch_raster
                    else None
                ),
            )
        offs = np.asarray([[t.y0 - t.cy0, t.x0 - t.cx0]], np.int32)
        b_ops = jax.tree.map(lambda l: np.asarray(l)[None], t.ops)
        flows, wrgbs, wmasks = solve_and_raster_canvas(
            b_ops, t.rgb[None], offs, self.cfg, canvas_hw=t.canvas,
            compact_flow=False, transposed=t.transposed,
        )
        bh, bw = t.bucket
        ch, cw = t.canvas
        full_flow = np.zeros((H, W, 2), np.float32)
        full_flow[t.y0 : t.y0 + bh, t.x0 : t.x0 + bw] = (
            np.asarray(flows[0]).transpose(1, 2, 0)
        )
        if not fetch_raster:
            return DeformResult(flow=full_flow, warped_rgb=None,
                                warped_mask=None, state=None)
        full_rgb = np.zeros((H, W, 3), np.uint8)
        full_rgb[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = (
            np.asarray(wrgbs[0]).transpose(1, 2, 0).astype(np.uint8)
        )
        full_mask = np.zeros((H, W), np.uint8)
        full_mask[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = (
            np.asarray(wmasks[0]).astype(np.uint8)
        )
        return DeformResult(flow=full_flow, warped_rgb=full_rgb,
                            warped_mask=full_mask, state=None)

    def solve_flow(
        self, arap_mask: np.ndarray, constraints: np.ndarray
    ) -> np.ndarray:
        """Flow-only solve (no rasterization); returns (H, W, 2) float32."""
        H, W = arap_mask.shape[:2]
        cons = np.asarray(constraints, np.int32).reshape(-1, 4)
        if self.pin_border:
            cons = add_border_pins(cons, W, H)
        ops = E.build_operands(np.asarray(arap_mask), cons, self.weights)
        _, flow = S.solve(ops, self.cfg)
        return np.asarray(flow).transpose(1, 2, 0)


def deform(
    rgb: np.ndarray,
    arap_mask: np.ndarray,
    constraints: np.ndarray,
    cfg: SolverConfig = SolverConfig(),
    weights: E.ArapWeights = E.ArapWeights(),
) -> DeformResult:
    """One-shot functional API over ArapDeformer."""
    return ArapDeformer(cfg, weights).deform(rgb, arap_mask, constraints)


FLOW_I16_SCALE = 64.0  # 1/64 px quantum, ±512 px range


def _quantize_flow(flows):
    # i16 fixed-point flow (1/64 px): halves the dominant D2H plane;
    # quantization (±0.008 px) is far below solver accuracy. Dequantized
    # host-side (pipeline/batch.py).
    return jnp.clip(
        jnp.round(flows * FLOW_I16_SCALE), -32768, 32767
    ).astype(jnp.int16)


@partial(jax.jit, static_argnames=("static_key", "compact_flow"))
def _solve_and_raster_batch_impl(ops, rgb, dyn, static_key,
                                 compact_flow=False):
    cfg = S._rebuild_config(dyn, static_key)

    def one(o, r):
        o = _expand(o)
        x = S.anneal_solve(o, cfg)
        flow = S.flow_from_state(x, o)
        wrgb, wmask = R.rasterize(x[:2], _to_f32(r), 1.0 - o.mask)
        return x, flow, wrgb.astype(jnp.uint8), wmask.astype(jnp.uint8)

    xs, flows, wrgbs, wmasks = jax.vmap(one)(ops, rgb)
    if compact_flow:
        flows = _quantize_flow(flows)
    return xs, flows, wrgbs, wmasks


@partial(jax.jit, static_argnames=("static_key", "canvas_hw", "compact_flow",
                                   "transposed"))
def _solve_and_raster_canvas_impl(ops, rgb, offs, dyn, static_key, canvas_hw,
                                  compact_flow=True, transposed=False):
    """Decoupled solve/raster: the 61k-iteration solve runs on the TIGHT
    object bucket; results are placed (per-problem dynamic offset) onto a
    larger canvas bucket that has the raster landing area. The displacement
    margins are masked-inert during the solve, so solving them was pure
    waste — this moves their cost from the deep PCG kernel to the one-shot
    rasterizer.

    ops/rgb: solve-bucket-shaped batched operands; offs: (B, 2) int32
    (dy, dx) of the solve box inside the canvas box. Returns
    (flow (B,2,hs,ws), wrgb (B,3,Hc,Wc) u8, wmask (B,Hc,Wc) u8).

    `transposed`: the operands hold the REFLECTED problem (x/y swapped —
    pipeline/batch.make_task chose a tall-narrow bucket for a wide-flat
    object); the solve runs in transposed coordinates and the resulting
    planes are transposed back (u<->v swap) before rasterization, so flow /
    raster / paste stay canonical. Exactness: the reflection conjugates the
    ARAP energy (Rotate2D angle negates), giving the same linear systems up
    to variable order; rgb stays canonical (it is only rasterized)."""
    cfg = S._rebuild_config(dyn, static_key)
    Hc, Wc = canvas_hw

    def one(o, r, off):
        o = _expand(o)
        x = S.anneal_solve(o, cfg)
        if transposed:
            # planes back to canonical orientation: x'[0] is the warped
            # x'-position = canonical y, x'[1] = canonical x; the angle
            # negates under reflection; mask/grid transpose spatially (the
            # swapped-transposed grid IS the canonical UrShape grid)
            x = jnp.stack([x[1].T, x[0].T, -x[2].T])
            o = o._replace(
                mask=o.mask.T,
                grid=jnp.stack([o.grid[1].T, o.grid[0].T]),
            )
        flow = S.flow_from_state(x, o)
        dy, dx = off[0], off[1]
        # canvas-absolute warped positions: shift by the solve-box offset
        warp = x[:2] + jnp.stack([dx, dy]).astype(x.dtype)[:, None, None]
        warp_c = jax.lax.dynamic_update_slice(
            jnp.zeros((2, Hc, Wc), x.dtype), warp, (0, dy, dx)
        )
        # default canvas mask = excluded (1) so padded quads never draw
        mask_c = jax.lax.dynamic_update_slice(
            jnp.ones((Hc, Wc), x.dtype), 1.0 - o.mask, (dy, dx)
        )
        rgb_c = jax.lax.dynamic_update_slice(
            jnp.zeros((3, Hc, Wc), jnp.float32), _to_f32(r), (0, dy, dx)
        )
        wrgb, wmask = R.rasterize(warp_c, rgb_c, mask_c)
        return flow, wrgb.astype(jnp.uint8), wmask.astype(jnp.uint8)

    flows, wrgbs, wmasks = jax.vmap(one)(ops, rgb, offs)
    if compact_flow:
        flows = _quantize_flow(flows)
    return flows, wrgbs, wmasks


@lru_cache(maxsize=None)
def _canvas_sharded_fn(mesh, static_key, canvas_hw, compact_flow, transposed):
    """Cached data_sharded_jit (parallel/mesh.py — shard_map over 'data',
    replicated traced dyn) for the canvas impl."""
    from ..parallel.mesh import data_sharded_jit

    def fn(ops, rgb, offs, dyn):
        return _solve_and_raster_canvas_impl(
            ops, rgb, offs, dyn, static_key, canvas_hw=canvas_hw,
            compact_flow=compact_flow, transposed=transposed,
        )

    return data_sharded_jit(mesh, fn, n_sharded_in=3, n_out=3)


def solve_and_raster_canvas(ops_batched, rgb_batched, offs, cfg: SolverConfig,
                            canvas_hw: tuple, mesh=None,
                            compact_flow: bool = True,
                            transposed: bool = False):
    """Batched tight-solve + canvas-raster (see _solve_and_raster_canvas_impl).

    offs: (B, 2) int32 (dy, dx) of each solve box inside its canvas box.
    Returns (flows, wrgbs, wmasks); flows are i16 fixed-point when
    compact_flow. `mesh` shards the batch over the 'data' axis via shard_map
    (B must divide by the axis size — pipeline/batch.py's ladder guarantees
    it)."""
    # telemetry: full program key incl. the STATIC args invisible in jax's
    # compile logs (canvas_hw/transposed/compact_flow) → first-use wallclock.
    # scripts/endurance.py checks (a) XLA compile events per program <= 1 and
    # (b) no new key appears late in a sustained run (compile-set saturation).
    key = (tuple(_mask_shape(ops_batched)), tuple(canvas_hw), transposed,
           compact_flow, cfg.static_key,
           None if mesh is None else tuple(mesh.shape.items()))
    PROGRAM_KEYS.setdefault(key, _time.time())
    if mesh is not None:
        fn = _canvas_sharded_fn(
            mesh, cfg.static_key, tuple(canvas_hw), compact_flow, transposed,
        )
        dyn = jax.tree.map(jnp.float32, cfg.dynamic)
        return fn(ops_batched, rgb_batched, offs, dyn)
    # executable pack (ARAP_EXEC_PACK): serialized-executable cache shared
    # across processes — skips the compile a fresh worker would pay per
    # program (utils/aot.py; the cross-process analogue of the reference's
    # per-size plan reuse, CombinedSolver.h:149-160). Self-building: a miss
    # AOT-compiles (same cost as jit, once) and persists for every later
    # process. Sharded-mesh programs stay on the
    # jit path (shard_map executables are not in scope).
    from ..utils import aot

    if aot.pack_dir() is not None:
        static_kwargs = dict(static_key=cfg.static_key,
                             canvas_hw=tuple(canvas_hw),
                             compact_flow=compact_flow, transposed=transposed)
        args = (ops_batched, rgb_batched, offs, cfg.dynamic)
        akey = aot.canvas_key(args, static_kwargs)
        comp = aot.lookup(akey)
        if comp is None:
            comp = aot.compile_and_save(
                akey, _solve_and_raster_canvas_impl, args, static_kwargs)
        try:
            return comp(*args)
        except Exception as exc:  # noqa: BLE001 — any pack failure → jit path
            import logging

            logging.getLogger(__name__).warning(
                "exec-pack executable call failed (%s: %s) — recompiling "
                "via jit", type(exc).__name__, exc)
    return _solve_and_raster_canvas_impl(
        ops_batched, rgb_batched, offs, cfg.dynamic, cfg.static_key,
        canvas_hw=tuple(canvas_hw), compact_flow=compact_flow,
        transposed=transposed,
    )


def solve_and_raster_batch(ops_batched, rgb_batched, cfg: SolverConfig,
                           mesh=None, compact_flow: bool = False):
    """Batched solve + rasterize for same-shape (bucketed) problems.

    ops_batched: ArapOperands with leading batch axis on every leaf;
    rgb_batched: (B, 3, H, W) float32. Returns (x, flow, wrgb, wmask) batched
    (flow as i16 fixed-point when compact_flow).
    This is the on-chip replacement for the reference's per-GPU process farm:
    many (frame, segment) problems solved in one compiled program.

    `mesh`: optional jax Mesh — the batch axis is sharded over its 'data'
    axis via shard_map (the multi-chip task farm, para_gen.py:560-567
    equivalent; zero collectives, each chip owns whole problems). B must be
    divisible by the 'data' axis size.
    """
    if mesh is not None:
        fn = _batch_sharded_fn(mesh, cfg.static_key, compact_flow)
        dyn = jax.tree.map(jnp.float32, cfg.dynamic)
        return fn(ops_batched, rgb_batched, dyn)
    return _solve_and_raster_batch_impl(
        ops_batched, rgb_batched, cfg.dynamic, cfg.static_key,
        compact_flow=compact_flow,
    )


@lru_cache(maxsize=None)
def _batch_sharded_fn(mesh, static_key, compact_flow):
    """Cached data_sharded_jit (parallel/mesh.py) for solve_and_raster_batch."""
    from ..parallel.mesh import data_sharded_jit

    def fn(ops, rgb, dyn):
        return _solve_and_raster_batch_impl(
            ops, rgb, dyn, static_key, compact_flow=compact_flow,
        )

    return data_sharded_jit(mesh, fn, n_sharded_in=2, n_out=4)

"""PCG inner-loop probe on the GPU: per-iteration time, the loop's fusions,
its host round trips, and whether any matrix unit (TF32) enters.

    python scripts/pcg_probe.py [--trace DIR]

- Per-iteration time: B=8 problems at the 224x384 bucket, one vmapped solve
  program (1 anneal x 1 GN step), run with PCG budgets of 100 and 400
  iterations — the budget is a traced scalar, so both runs use ONE
  executable and the difference over 300 iterations is the loop's cost.
- Fusions per iteration: the ops of the while-loop body in the optimized
  HLO of that program.
- Host round trips: a profiler trace of the 400-iteration run; device
  memcpy events per iteration show whether the loop predicate goes back to
  the host every iteration.
- Matrix units: `dot` / `convolution` ops in the optimized HLO of the
  production solve+raster program and of the matcher; none means TF32
  cannot enter.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os.path as osp
import re
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

B, BH, BW = 8, 224, 384


def _problems():
    """B elliptical segments filling the bucket, rigid-ish constraints."""
    from arap_flow.io.constraints import add_border_pins
    from arap_flow.ops import energy as E

    yy, xx = np.mgrid[0:BH, 0:BW]
    out = []
    for i in range(B):
        rng = np.random.default_rng(i)
        ell = (((yy - BH / 2) / (BH / 2 - 3)) ** 2
               + ((xx - BW / 2) / (BW / 2 - 3)) ** 2) < 1
        mask = np.where(ell, 0, 255).astype(np.uint8)
        ys, xs = np.mgrid[4:BH - 4:8, 4:BW - 4:8]
        sel = ell[ys, xs]
        d = rng.integers(-4, 5, 2)
        cons = np.stack([xs[sel], ys[sel], xs[sel] + d[0], ys[sel] + d[1]],
                        1).astype(np.int32)
        cons = add_border_pins(cons, BW, BH)
        out.append(E.build_operands(mask, cons))
    return out


def _loop_body_ops(hlo: str) -> collections.Counter:
    """Opcode counts of the (largest) while-loop body computation."""
    bodies = re.findall(r"while\([^)]*\)[^\n]*body=%?([\w.\-]+)", hlo)
    best = collections.Counter()
    for name in set(bodies):
        m = re.search(r"\n%?" + re.escape(name) + r" [^\n]*\{\n(.*?)\n\}",
                      hlo, re.S)
        if not m:
            continue
        ops = collections.Counter(
            mm.group(1) for mm in re.finditer(
                r"= [\w\[\]{},:0-9 ]*? ([a-z\-]+)\(", m.group(1)))
        if sum(ops.values()) > sum(best.values()):
            best = ops
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="chiprun_out/pcg_trace")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from arap_flow.ops import solver as S
    from arap_flow.utils.device import require_gpu

    dev = require_gpu()
    print(f"device: {dev['kind']} x{dev['count']}; {dev['smi']}", flush=True)

    batched = jax.tree.map(lambda *ls: jnp.stack(ls), *_problems())
    key = (1, 1, 400)

    def dyn(iters):
        return S.SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=400,
                              pcg_iters=float(iters)).dynamic

    t0 = time.time()
    lowered = S._solve_batch_impl.lower(batched, dyn(400), static_key=key)
    compiled = lowered.compile()
    print(f"compile (B={B} {BH}x{BW}, 1x1x400): {time.time() - t0:.2f} s",
          flush=True)

    def run(iters, reps=7):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            out = compiled(batched, dyn(iters))
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t)
        return min(ts), out

    run(400, 2)
    t100, _ = run(100)
    t400, out = run(400)
    n_iter = float(out[2][0])
    per = (t400 - t100) / 300
    print(f"min of 7: 100 iters {t100 * 1e3:.3f} ms, 400 iters "
          f"{t400 * 1e3:.3f} ms (executed {n_iter:.0f}); per PCG iteration "
          f"(B={B}) {per * 1e6:.2f} us, per problem-iteration "
          f"{per / B * 1e6:.2f} us; full 19x8x400 schedule at this rate "
          f"{per * 60800:.2f} s per chunk", flush=True)

    hlo = compiled.as_text()
    body = _loop_body_ops(hlo)
    print(f"while body ops: {sum(body.values())} total, "
          f"{body.get('fusion', 0)} fusions; {dict(body.most_common(12))}",
          flush=True)

    jax.profiler.start_trace(args.trace)
    jax.block_until_ready(compiled(batched, dyn(400)))
    jax.profiler.stop_trace()
    files = sorted(glob.glob(osp.join(args.trace, "plugins", "profile", "*",
                                      "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(files[-1])
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        names = collections.Counter()
        busy = collections.Counter()
        for line in plane.lines:
            for ev in line.events:
                names[ev.name] += 1
                busy[ev.name] += ev.duration_ns
        memcpy = sum(c for n, c in names.items() if "memcpy" in n.lower())
        print(f"trace {plane.name}: {sum(names.values())} events, "
              f"{memcpy} memcpy events ({memcpy / 400:.2f} per PCG "
              "iteration)", flush=True)
        for n, c in names.most_common(15):
            print(f"  {c:7d} x {busy[n] / max(c, 1) / 1e3:9.2f} us  {n[:90]}")
        break

    # matrix units in the production programs
    from arap_flow.models import arap as A
    from arap_flow.ops import energy as E
    from arap_flow.ops import matching as M

    compact = jax.tree.map(
        lambda *ls: np.stack(ls),
        *[E.build_compact(np.where(np.asarray(o.mask) > 0, 0, 255).astype(
            np.uint8), np.zeros((0, 4), np.int32)) for o in _problems()])
    rgb = np.zeros((B, 3, BH, BW), np.uint8)
    offs = np.zeros((B, 2), np.int32)
    canvas = A._solve_and_raster_canvas_impl.lower(
        compact, rgb, offs, S.SolverConfig().dynamic,
        S.SolverConfig().static_key, canvas_hw=(BH, BW)).compile().as_text()
    z = jnp.zeros((3, 480, 854), jnp.uint8)
    match = M.match_grid.lower(z, z).compile().as_text()
    for name, txt in (("solve+raster canvas", canvas), ("matcher", match)):
        n_dot = len(re.findall(r"\bdot\(", txt))
        n_conv = len(re.findall(r"\bconvolution\(", txt))
        n_cc = len(re.findall(r"custom-call\(", txt))
        print(f"optimized HLO {name}: {n_dot} dot, {n_conv} convolution, "
              f"{n_cc} custom-call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

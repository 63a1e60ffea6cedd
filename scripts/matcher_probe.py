"""Split the matcher's device time across its components (on the GPU).

The split tells whether the matcher's budget is the coarse hypothesis
search, the per-level refine ladder, bidirectionality, or the grid-select
tail — and therefore which lever is worth pulling.

    python scripts/matcher_probe.py
"""

import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

H, W = 480, 854


def timed(fn, reps=5):
    fn()  # compile
    ts = []
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        # np.asarray forces D2H, which waits for the device
        for a in out:
            np.asarray(a)
        ts.append(time.time() - t0)
    return sorted(ts)[len(ts) // 2]


def main():
    from arap_flow.ops.matching import DEFAULT_ROTATIONS, match_grid

    rng = np.random.default_rng(0)
    im1 = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    im2 = rng.integers(0, 255, (3, H, W)).astype(np.uint8)

    cases = [
        ("default (5 rot, L3, rp1, rr2)", dict()),
        ("identity-only rotations", dict(rotations=(0.0,))),
        ("levels=2", dict(levels=2)),
        ("refine_radius=1", dict(refine_radius=1)),
        ("levels=2 + rr1", dict(levels=2, refine_radius=1)),
    ]
    for name, kw in cases:
        kw.setdefault("rotations", DEFAULT_ROTATIONS)

        def run(kw=kw):
            import jax.numpy as jnp

            return match_grid(jnp.asarray(im1), jnp.asarray(im2), **kw)

        # first-call (compile) timed ALONE: folding the warm reps into it
        # would overstate compile cost by ~6 warm executions and skew the
        # cross-config comparison this probe exists for
        t0 = time.time()
        np.asarray(run()[0])
        t_first = time.time() - t0
        t = timed(run)
        print(f"{name}: {t:.3f}s/pair warm   (first-call {t_first:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()

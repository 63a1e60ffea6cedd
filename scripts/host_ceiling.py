"""Host-ceiling measurement for the batched pipeline (multi-chip claim support).

The multi-device scaling story (--mode sharded, dp over every card of a
host) extrapolates linearly from one-device throughput because the
data-parallel layout is zero-collective (each device owns whole problems).
The honest question is the SERIAL FRACTION: at 4x device throughput, the
host must decode,
filter, bucket, paste, compose and write 8x as many pairs through the same
threads — the reference's farm had one whole host process per GPU
(para_gen.py:560-567); ours has one process per host.

This script measures the ceiling directly: it runs the real batched pipeline
(real dataset on disk, real decode/filter/bucket-prep/paste/compose/PNG+.flo
writes, the production thread structure) with every DEVICE program stubbed
to return instantly with correctly-shaped host arrays. The resulting pairs/s
is the throughput an infinitely fast device (or any number of devices)
could not exceed on this host — the denominator of the scaling claim.

Stub fidelity notes:
  - matcher: dispatch returns the decoded mask as the "handle"; fetch
    synthesizes a stride-8 on-object match grid with a small rigid shift
    (realistic match counts, so filter_matches/make_task do real work).
  - solver+raster: returns i16-zero flow (the production compact dtype),
    the input crop pasted into the canvas as warped RGB (content-realistic
    PNG encode cost), and a full-canvas 255 mask (compose touches every
    canvas pixel — upper-bound compose cost).
  - jnp.stack/asarray uploads still run (CPU backend memcpy) — on a GPU
    these are H2D copies, also host-side time.

The MULTI-WORKER measurement is the deployment shape the reference used
(reference: one worker process per GPU, para_gen.py:560-567, README.md:122
`--gpu 0 1 2 3`): N co-located worker processes, each running `--shard i/N`
of the same dataset with stubbed devices, all timed through a file barrier so
they contend simultaneously. The aggregate pairs/s curve over N in {1,2,4,8}
quantifies the co-location penalty (per-process compile sets are NOT modeled
— stubs compile nothing; see docs/PARITY.md for the compile-budget story).
On a host with fewer cores than workers the curve measures
oversubscription: aggregate(N) ~= aggregate(1) means workers time-slice
cleanly and host feed scales with CORES, not processes. Every worker runs
with JAX_PLATFORMS=cpu (set here), so none of them opens an accelerator.

Run on CPU:
    JAX_PLATFORMS=cpu python scripts/host_ceiling.py [n_pairs]
    # multi-worker curve (N = 1,2,4,8 co-located shard processes):
    JAX_PLATFORMS=cpu python scripts/host_ceiling.py [n_pairs] --multi [out.json]
"""

import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))


def install_stubs():
    import jax.numpy as jnp

    from arap_flow.models import arap as arap_mod
    from arap_flow.ops import matching as match_mod
    from arap_flow.pipeline import batch as batch_mod

    # ---- matcher stubs ----
    def stub_dispatch(g1, g2, radius=100, downscale=1, **kw):
        return ("h", np.asarray(g1).shape)

    def stub_dispatch_multi(pairs, radius=100, downscale=1, **kw):
        return [("h", np.asarray(a).shape) for a, _ in pairs]

    def stub_fetch(handle, fb_threshold=1.5, roi_mask=None, **kw):
        mask = roi_mask
        ys, xs = np.where(mask > 0)
        sel = (ys % 8 == 0) & (xs % 8 == 0)
        sy, sx = ys[sel], xs[sel]
        m = np.stack(
            [sx, sy, sx + 3, sy + 2, np.ones_like(sx)], axis=1
        ).astype(np.float32)
        return m

    match_mod.match_images_dispatch = stub_dispatch
    match_mod.match_images_dispatch_multi = stub_dispatch_multi
    match_mod.match_images_fetch = stub_fetch

    # ---- solver+raster stubs (batched canvas + full-frame fallback) ----
    def stub_solve_and_raster_canvas(batched_ops, rgb_b, offs, cfg,
                                     canvas_hw=None, mesh=None,
                                     transposed=False, compact_flow=True,
                                     **kw):
        rgb = np.asarray(rgb_b)  # (B, 3, bh, bw) u8
        B, _, bh, bw = rgb.shape
        ch, cw = canvas_hw
        off = np.asarray(offs)
        flows = np.zeros((B, 2, bh, bw), np.int16)
        wrgbs = np.zeros((B, 3, ch, cw), np.uint8)
        for i in range(B):
            oy, ox = int(off[i, 0]), int(off[i, 1])
            oy, ox = max(0, oy), max(0, ox)
            wrgbs[i, :, oy : oy + bh, ox : ox + bw] = (
                rgb[i, :, : ch - oy, : cw - ox]
            )
        wmasks = np.full((B, ch, cw), 255, np.uint8)
        return flows, wrgbs, wmasks

    def stub_solve_and_raster(ops, rgb_u8, cfg, **kw):
        rgb = np.asarray(rgb_u8)
        _, H, W = rgb.shape
        return (
            None,
            np.zeros((2, H, W), np.float32),
            rgb,
            np.full((H, W), 255, np.uint8),
        )

    arap_mod.solve_and_raster_canvas = stub_solve_and_raster_canvas
    batch_mod.solve_and_raster_canvas = stub_solve_and_raster_canvas
    arap_mod._solve_and_raster = stub_solve_and_raster
    batch_mod._solve_and_raster = stub_solve_and_raster
    _ = jnp  # imported for parity with production path


def _worker(idx: int, n_workers: int, root: str, n_pairs: int) -> None:
    """One co-located shard worker: warm run, file barrier, timed run.

    The barrier makes all N workers' timed runs overlap, so the aggregate
    number reflects true co-location contention (decode/encode threads,
    page cache, the single allocator arena) — the configuration the
    reference's per-GPU process farm actually ran (para_gen.py:560-567).
    """
    install_stubs()

    from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

    data = osp.join(root, "data")
    expect = len(range(idx, n_pairs, n_workers))

    def run(out_name):
        flags = PipelineFlags(
            input=data, output=osp.join(root, out_name), fd=1, multseg=True,
            seed=0, mode="batched", shard=(idx, n_workers),
        )
        t0 = time.time()
        triples = main_pipeline(flags)
        assert len(triples) == expect, (len(triples), expect)
        return time.time() - t0

    warm_s = run(f"warm_{n_workers}_{idx}")
    bdir = osp.join(root, f"barrier_{n_workers}")
    os.makedirs(bdir, exist_ok=True)
    with open(osp.join(bdir, f"ready_{idx}"), "w") as f:
        f.write("1")
    deadline = time.time() + 300
    while len(os.listdir(bdir)) < n_workers:
        if time.time() > deadline:
            raise SystemExit(f"worker {idx}: barrier timeout")
        time.sleep(0.05)
    timed_s = run(f"timed_{n_workers}_{idx}")
    with open(osp.join(root, f"res_{n_workers}_{idx}.json"), "w") as f:
        json.dump({"idx": idx, "n_workers": n_workers, "pairs": expect,
                   "warm_s": round(warm_s, 2), "timed_s": round(timed_s, 2)},
                  f)


def _multi(n_pairs: int, out_json: str | None) -> None:
    from pipeline_bench import make_dataset

    root = "/tmp/arap_host_ceiling_multi"
    shutil.rmtree(root, ignore_errors=True)
    data = osp.join(root, "data")
    make_dataset(data, n_pairs + 1)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # stubbed workers must not open a GPU
    curve = []
    for n_workers in (1, 2, 4, 8):
        # stderr to per-worker FILES, not pipes: pipes are only drained
        # sequentially after the barrier, so a worker writing > the ~64 KB
        # pipe buffer (jax log spew) would block BEFORE reaching the barrier
        # and deadlock the whole stage
        err_files = [open(osp.join(root, f"stderr_{n_workers}_{i}.log"),
                          "wb") for i in range(n_workers)]
        procs = [
            subprocess.Popen(
                [sys.executable, osp.abspath(__file__), str(n_pairs),
                 "--work", str(i), str(n_workers), root],
                env=env, stdout=subprocess.DEVNULL, stderr=ef,
            )
            for i, ef in enumerate(err_files)
        ]
        errs = []
        try:
            for i, p in enumerate(procs):
                p.communicate(timeout=1800)
                if p.returncode != 0:
                    err_files[i].close()
                    with open(err_files[i].name, "rb") as f:
                        errs.append(f.read().decode()[-2000:])
        finally:
            # one hung/failed worker must not leave N-1 CPU-bound jax
            # processes contending with whatever the host runs next
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for ef in err_files:
                if not ef.closed:
                    ef.close()
        assert not errs, "\n".join(errs)
        res = [
            json.load(open(osp.join(root, f"res_{n_workers}_{i}.json")))
            for i in range(n_workers)
        ]
        pairs = sum(r["pairs"] for r in res)
        wall = max(r["timed_s"] for r in res)
        curve.append({
            "n_workers": n_workers,
            "aggregate_pairs_per_s": round(pairs / wall, 2),
            "wall_s_max": wall,
            "wall_s_per_worker": [r["timed_s"] for r in res],
        })
        print(json.dumps(curve[-1]), flush=True)
    result = {
        "n_pairs": n_pairs,
        "host_cores": len(os.sched_getaffinity(0)),
        "curve": curve,
        "note": "N co-located --shard i/N worker processes, devices stubbed "
        "instant, timed runs overlapped via file barrier; on this "
        f"{len(os.sched_getaffinity(0))}-core container the curve measures "
        "the pure oversubscription penalty of process co-location",
    }
    print(json.dumps(result))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)


def main():
    argv = sys.argv[1:]
    n_pairs = int(argv[0]) if argv and not argv[0].startswith("--") else 48
    if "--work" in argv:  # internal: spawned worker process
        k = argv.index("--work")
        _worker(int(argv[k + 1]), int(argv[k + 2]), argv[k + 3], n_pairs)
        return
    if "--multi" in argv:
        k = argv.index("--multi")
        out_json = argv[k + 1] if len(argv) > k + 1 else None
        _multi(n_pairs, out_json)
        return

    install_stubs()

    from pipeline_bench import make_dataset

    from arap_flow.pipeline import para_gen
    from arap_flow.pipeline.para_gen import PipelineFlags, main_pipeline

    root = "/tmp/arap_host_ceiling"
    shutil.rmtree(root, ignore_errors=True)
    data = osp.join(root, "data")
    make_dataset(data, n_pairs + 1)

    runs = []
    for i in range(2):  # second run: all caches warm, steady host state
        out = osp.join(root, f"out_{i}")
        flags = PipelineFlags(
            input=data, output=out, fd=1, multseg=True, seed=0,
            mode="batched", warmup=False,
        )
        os.environ["ARAP_PROFILE"] = "1"
        t0 = time.time()
        triples = main_pipeline(flags)
        runs.append(time.time() - t0)
        assert len(triples) == n_pairs, (len(triples), n_pairs)

    ceiling = n_pairs / min(runs)
    result = {
        "n_pairs": n_pairs,
        "runs_s": [round(t, 2) for t in runs],
        "host_ceiling_pairs_per_s": round(ceiling, 2),
        "note": "batched pipeline, all device programs stubbed instant; "
        "decode+match-prep+filter+bucket+compose+writes real",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

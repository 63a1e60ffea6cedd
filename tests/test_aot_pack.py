"""Executable pack (utils/aot.py): the cross-process AOT compile cache.

Gates: (1) the pack path produces BYTE-IDENTICAL products to the jit path,
(2) a FRESH PROCESS loads the pack without compiling (the cold-start story:
one compile set per worker otherwise),
(3) failures fall back to the jit path silently."""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np


def _problem(B=2, H=32, W=64, seed=0):
    import jax
    import jax.numpy as jnp

    from arap_flow.io.constraints import add_border_pins
    from arap_flow.ops import energy as E

    rng = np.random.default_rng(seed)
    ops_list, rgb_list = [], []
    for s in range(B):
        arap_mask = np.full((H, W), 255, np.uint8)
        arap_mask[4 : H - 4, 10 : W - 10] = 0
        ys, xs = np.mgrid[6 : H - 6 : 6, 14 : W - 14 : 16]
        cons = np.stack(
            [xs.ravel(), ys.ravel(),
             xs.ravel() + rng.integers(-3, 4, xs.size),
             ys.ravel() + rng.integers(-3, 4, xs.size)], 1).astype(np.int32)
        cons = add_border_pins(cons, W, H)
        ops_list.append(E.build_operands(arap_mask, cons))
        rgb_list.append(rng.integers(0, 256, (3, H, W)).astype(np.uint8))
    batched = jax.tree.map(lambda *ls: jnp.stack(ls), *ops_list)
    return batched, jnp.asarray(np.stack(rgb_list)), jnp.zeros((B, 2),
                                                              jnp.int32)


def _cfg():
    from arap_flow.ops.solver import SolverConfig

    return SolverConfig(num_anneal=2, gn_iters=1, max_pcg_iters=20,
                        pcg_iters=20.0)


_CHILD = """
import os, sys, json
import numpy as np
sys.path.insert(0, {repo!r})
os.environ["ARAP_EXEC_PACK"] = {pack!r}
sys.path.insert(0, {testdir!r})
from test_aot_pack import _problem, _cfg
from arap_flow.models.arap import solve_and_raster_canvas
from arap_flow.utils import aot
batched, rgb_b, offs = _problem()
f, r, m = solve_and_raster_canvas(batched, rgb_b, offs, _cfg(),
                                  canvas_hw=(32, 64))
st = aot.stats()
np.savez({out!r}, f=np.asarray(f), r=np.asarray(r), m=np.asarray(m))
print(json.dumps(st))
"""


def test_pack_identical_and_fresh_process_loads(tmp_path, monkeypatch):
    pack = str(tmp_path / "pack")
    out = str(tmp_path / "child_out.npz")

    from arap_flow.models.arap import solve_and_raster_canvas
    from arap_flow.utils import aot

    batched, rgb_b, offs = _problem()
    cfg = _cfg()
    # jit path (no pack) — delenv: an ambient ARAP_EXEC_PACK (a documented
    # production env var) must not leak into the baseline, and monkeypatch
    # restores the developer's value afterwards
    monkeypatch.delenv("ARAP_EXEC_PACK", raising=False)
    f0, r0, m0 = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                         canvas_hw=(32, 64))
    # pack path: builds the pack, must be byte-identical
    monkeypatch.setenv("ARAP_EXEC_PACK", pack)
    f1, r1, m1 = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                         canvas_hw=(32, 64))
    assert aot.stats()["loaded"] == 1
    monkeypatch.delenv("ARAP_EXEC_PACK")
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
    files = [f for f in os.listdir(pack) if f.endswith(".jaxexec")]
    assert len(files) == 1, files

    # fresh process with the pack: must LOAD (not compile) and match
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    script = _CHILD.format(repo=repo, pack=pack, out=out,
                           testdir=osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    st = json.loads(res.stdout.strip().splitlines()[-1])
    assert st["loaded"] == 1 and st["missed"] == 0, st
    child = np.load(out)
    np.testing.assert_array_equal(child["f"], np.asarray(f0))
    np.testing.assert_array_equal(child["r"], np.asarray(r0))
    np.testing.assert_array_equal(child["m"], np.asarray(m0))


def test_pack_miss_falls_back_to_jit(tmp_path, monkeypatch):
    """A corrupt pack entry must not break dispatch — jit fallback.

    aot's in-process _LOADED cache is keyed by program identity (shapes +
    statics, NOT pack dir), so the executable cached by the previous test
    would serve this key and the corrupt file would never be read — clear
    the module state so the deserialize-failure path actually runs."""
    from arap_flow.models.arap import solve_and_raster_canvas
    from arap_flow.utils import aot

    aot._LOADED.clear()
    aot._FAILED.clear()
    pack = str(tmp_path / "pack2")
    batched, rgb_b, offs = _problem(seed=5)
    cfg = _cfg()
    monkeypatch.delenv("ARAP_EXEC_PACK", raising=False)
    f0, _, _ = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                       canvas_hw=(32, 64))
    monkeypatch.setenv("ARAP_EXEC_PACK", pack)
    # pre-write garbage where the entry would live
    static_kwargs = dict(static_key=cfg.static_key,
                         canvas_hw=(32, 64), compact_flow=True,
                         transposed=False)
    args = (batched, rgb_b, offs, cfg.dynamic)
    key = aot.canvas_key(args, static_kwargs)
    os.makedirs(pack, exist_ok=True)
    path = aot._path(key)
    with open(path, "wb") as fh:
        fh.write(b"not a pickle")
    f1, _, _ = solve_and_raster_canvas(batched, rgb_b, offs, cfg,
                                       canvas_hw=(32, 64))
    # the corrupt entry must have actually been READ and then REBUILT —
    # otherwise this test passes vacuously whenever the hand-built key here
    # drifts from the dispatch's (e.g. a new static kwarg is added)
    with open(path, "rb") as fh:
        rebuilt = fh.read()
    assert rebuilt != b"not a pickle", (
        "corrupt entry never touched: the test's key no longer matches "
        "solve_and_raster_canvas's — update static_kwargs above"
    )
    assert len(rebuilt) > 1000  # a real serialized executable
    monkeypatch.delenv("ARAP_EXEC_PACK")
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))

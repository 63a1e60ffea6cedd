"""The solver has one path, plain JAX left to XLA: no other backend can be
asked for, no module imports Pallas (no kernel remains), the PCG loop is the
textbook recurrence, and batching changes no bit of the answer."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S
from arap_flow.pipeline.batch import (CHUNK_MEM_SHARE, MAX_CHUNK,
                                      PLANES_PER_PROBLEM, max_chunk_for)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_config_naming_a_removed_backend_raises(backend):
    with pytest.raises(TypeError, match="backend"):
        S.SolverConfig(backend=backend)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_env_naming_a_removed_backend_raises(backend, monkeypatch):
    from arap_flow.utils.config import FrameworkConfig

    monkeypatch.setenv("ARAP_BACKEND", backend)
    with pytest.raises(ValueError, match="one path"):
        FrameworkConfig.from_env()


def test_no_module_imports_pallas():
    files = [*(REPO / "arap_flow").rglob("*.py"), *(REPO / "scripts").glob(
        "*.py"), REPO / "bench.py", REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names
                    if "pallas" in n]
    assert len(files) > 40 and not bad, bad


@pytest.mark.parametrize("bucket,mem,expect", [
    ((64, 128), 16 << 30, MAX_CHUNK),      # small bucket: the cap
    ((512, 896), 16 << 30, MAX_CHUNK),     # largest bucket, ample memory
    ((512, 896), 1 << 30, 2),              # 256 MiB share / 117 MiB each
    ((224, 384), 64 << 20, 1),             # never below one problem
])
def test_max_chunk_for_rule(bucket, mem, expect):
    per = PLANES_PER_PROBLEM * bucket[0] * bucket[1] * 4
    assert expect == max(1, min(MAX_CHUNK, int(CHUNK_MEM_SHARE * mem) // per))
    assert max_chunk_for(bucket, mem_bytes=mem) == expect
    # sharded runs: the budget is per device
    assert max_chunk_for(bucket, n_data=4, mem_bytes=mem) == 4 * expect


def _spd_problem(H=6, W=7, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    arap_mask = np.zeros((H, W), np.uint8)
    cons = add_border_pins(np.array([[3, 2, 4, 3]], np.int32), W, H)
    ops = E.build_operands(arap_mask, cons, dtype=dtype)
    x = E.init_state(ops) + 0.2 * jnp.asarray(
        rng.standard_normal((3, H, W)), ops.grid.dtype)
    return ops, x, E.anneal_constraints(ops, 1.0)


def _dense_pcg(A, b, pre, iters):
    """Textbook Jacobi-PCG from δ = 0 (solverGPUGaussNewton.t:361-551)."""
    d = np.zeros_like(b)
    r = b.copy()
    z = pre * r
    p = z.copy()
    rz = r @ z
    for _ in range(iters):
        ap = A @ p
        alpha = rz / (p @ ap)
        d += alpha * p
        r -= alpha * ap
        z = pre * r
        rz, rz_old = r @ z, rz
        p = z + (rz / rz_old) * p
    return d


@pytest.mark.parametrize("budget", [1, 5, 20])
def test_fixed_budget_pcg_matches_dense_recurrence(budget):
    """pcg_solve with a traced budget of k iterations against the same k
    iterations on the dense JtJ matrix (float64, so the comparison is
    tight): the loop runs exactly the budget and every iterate matches."""
    with jax.enable_x64():
        ops, x, cimg = _spd_problem()
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, ops, cimg)
        n = x.size
        eye = jnp.eye(n, dtype=x.dtype).reshape(n, *x.shape)
        A = np.asarray(jax.vmap(lambda e: E.apply_jtj(e, ops, s, c))(eye)
                       ).reshape(n, n).T
        delta, iters = S.pcg_solve(ops, s, c, jtf, diag, 400,
                                   pcg_iters=jnp.float32(budget))
        pre = np.asarray(S.guarded_invert(diag)).ravel()
        ref = _dense_pcg(A, -np.asarray(jtf).ravel(), pre, budget)
        assert float(iters) == budget
        np.testing.assert_allclose(np.asarray(delta).ravel(), ref,
                                   rtol=1e-9, atol=1e-11)


def test_solve_batch_bitwise_equals_per_problem_solve():
    probs = []
    for seed in range(3):
        ops, _, _ = _spd_problem(H=12, W=16, seed=seed, dtype=np.float32)
        probs.append(ops)
    batched = jax.tree.map(lambda *ls: jnp.stack(ls), *probs)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=30,
                         pcg_iters=30.0)
    xs, flows = S.solve_batch(batched, cfg)
    for i, ops in enumerate(probs):
        x1, f1 = S.solve(ops, cfg)
        np.testing.assert_array_equal(np.asarray(xs[i]), np.asarray(x1))
        np.testing.assert_array_equal(np.asarray(flows[i]), np.asarray(f1))

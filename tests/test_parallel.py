"""Multi-chip tests on the virtual 8-device CPU mesh: data-parallel sharded
batch solve and the spatially-sharded (halo-exchange) solver must match the
single-chip solver exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from arap_flow.io.constraints import add_border_pins
from arap_flow.ops import energy as E
from arap_flow.ops import solver as S
from arap_flow.parallel import make_mesh, solve_batch_sharded, solve_spatial


def _problem(H, W, seed):
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 0
    ys, xs = np.mgrid[H // 4 + 1 : 3 * H // 4 - 1 : 4, W // 4 + 1 : 3 * W // 4 - 1 : 4]
    cons = np.stack(
        [
            xs.ravel(),
            ys.ravel(),
            xs.ravel() + rng.integers(-2, 3, xs.size),
            ys.ravel() + rng.integers(-2, 3, xs.size),
        ],
        axis=1,
    ).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    return E.build_operands(arap_mask, cons)


def _batch(problems):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *problems)


def test_data_parallel_matches_single():
    H, W = 24, 32
    probs = [_problem(H, W, s) for s in range(8)]
    batched = _batch(probs)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=40.0)
    mesh = make_mesh(data=8, space=1)
    xs, flows = solve_batch_sharded(batched, cfg, mesh)
    x0, f0 = S.solve(probs[3], cfg)
    np.testing.assert_allclose(np.asarray(xs[3]), np.asarray(x0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(flows[3]), np.asarray(f0), atol=1e-5)


def test_spatial_matches_single():
    """Row-sharded solve with ppermute halos == single-chip solve (up to psum
    reduction order)."""
    H, W = 32, 24  # H divisible by space=4
    probs = [_problem(H, W, s) for s in (0, 1)]
    batched = _batch(probs)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=30.0)
    mesh = make_mesh(data=2, space=4)
    xs, flows = solve_spatial(batched, cfg, mesh)
    for i, p in enumerate(probs):
        x0, f0 = S.solve(p, cfg)
        np.testing.assert_allclose(
            np.asarray(xs[i]), np.asarray(x0), atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(flows[i]), np.asarray(f0), atol=5e-4
        )


def test_spatial_full_mesh_space8():
    """All 8 devices on the space axis (single problem's rows split 8 ways)."""
    H, W = 32, 16
    p = _problem(H, W, 7)
    batched = _batch([p])
    cfg = S.SolverConfig(num_anneal=1, gn_iters=2, pcg_iters=25.0)
    mesh = make_mesh(data=1, space=8)
    xs, flows = solve_spatial(batched, cfg, mesh)
    x0, f0 = S.solve(p, cfg)
    np.testing.assert_allclose(np.asarray(xs[0]), np.asarray(x0), atol=5e-4)


def _problem_wide(seed, H=16, W=128):
    """Problem at a bucket width (W = 128), as the pipeline batches them."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    cons = np.stack(
        [xs.ravel(), ys.ravel(),
         xs.ravel() + rng.integers(-3, 4, xs.size),
         ys.ravel() + rng.integers(-3, 4, xs.size)], 1).astype(np.int32)
    cons = add_border_pins(cons, W, H)
    return E.build_operands(arap_mask, cons)


def test_data_parallel_wide_batch_matches_single():
    """The PRODUCTION multi-device solve path: the vmapped XLA batch solve
    under shard_map over the 'data' axis (one whole problem per device on
    the 8-device CPU mesh) must match the single-device batched solve of the
    same bucket-width problems exactly."""
    probs = [_problem_wide(s) for s in range(8)]
    batched = _batch(probs)
    cfg = S.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=30,
                         pcg_iters=30.0)
    mesh = make_mesh(data=8, space=1)
    xs, flows = solve_batch_sharded(batched, cfg, mesh)
    x1, f1 = S.solve_batch(batched, cfg)
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(x1))
    np.testing.assert_array_equal(np.asarray(flows), np.asarray(f1))


def test_sharded_schedule_sweep_no_recompile():
    """The dynamic SolverConfig floats must stay TRACED arguments of the
    sharded executable: sweeping pcg_iters/q_tolerance must reuse one
    compiled program (the static/dynamic split invariant)."""
    from arap_flow.parallel.mesh import _solve_batch_sharded_fn

    probs = [_problem(24, 32, s) for s in range(8)]
    batched = _batch(probs)
    mesh = make_mesh(data=8, space=1)
    _solve_batch_sharded_fn.cache_clear()
    for iters in (20.0, 30.0, 40.0):
        cfg = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=iters)
        xs, flows = solve_batch_sharded(batched, cfg, mesh)
    info = _solve_batch_sharded_fn.cache_info()
    assert info.currsize == 1, f"one executable expected, got {info}"
    assert info.hits == 2, f"sweep should reuse the cached fn, got {info}"
    # deeper schedule must actually change the answer (dyn really is wired)
    cfg_a = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=2.0)
    cfg_b = S.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=40.0)
    xa, _ = solve_batch_sharded(batched, cfg_a, mesh)
    xb, _ = solve_batch_sharded(batched, cfg_b, mesh)
    assert not np.allclose(np.asarray(xa), np.asarray(xb))

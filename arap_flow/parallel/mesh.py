"""Device mesh construction and data-parallel batch solving.

Data-parallel ARAP is communication-free: every chip owns whole problems
(batch entries), exactly like the reference's one-GPU-per-worker farm
(para_gen.py:560-567) but on-chip-batched and without processes or tmp files.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import solver as S


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    space: int = 1,
    devices=None,
) -> Mesh:
    """Create a ('data', 'space') mesh. Defaults to all devices on 'data'."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data is None:
        data = n // space
    assert data * space == n, f"mesh {data}x{space} != {n} devices"
    arr = np.asarray(devices).reshape(data, space)
    return Mesh(arr, ("data", "space"))


def shard_batch(ops_batched, mesh: Mesh):
    """Place batched operands with the batch axis sharded over 'data'."""
    def put(leaf):
        spec = P("data", *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, ops_batched)


def data_sharded_jit(mesh: Mesh, impl, n_sharded_in: int, n_out: int):
    """jit(shard_map(...)) over the mesh's 'data' axis — THE sharding shape
    of every dp entry point here (the reference farm semantics,
    para_gen.py:560-567): the first `n_sharded_in` args and all `n_out`
    outputs shard on 'data', the trailing arg (the dynamic SolverConfig
    floats) is replicated so schedule sweeps don't recompile (the tested
    split invariant). Each device traces its own LOCAL-batch program, so
    a sharded chunk runs the same per-device program as an unsharded
    chunk of the local size. Zero collectives inside: each device owns
    whole problems."""
    spec = P("data")
    return jax.jit(jax.shard_map(
        impl, mesh=mesh,
        in_specs=(*(spec,) * n_sharded_in, P()),
        out_specs=(spec,) * n_out,
        check_vma=False,
    ))


@lru_cache(maxsize=None)
def _solve_batch_sharded_fn(mesh: Mesh, static_key):
    """Cached data_sharded_jit keyed on (mesh, static_key) ONLY — dynamic
    floats stay traced (see data_sharded_jit)."""

    def fn(ops, dyn):
        xs, flows, _ = S._solve_batch_impl(ops, dyn, static_key)
        return xs, flows

    return data_sharded_jit(mesh, fn, n_sharded_in=1, n_out=2)


def solve_batch_sharded(ops_batched, cfg: S.SolverConfig, mesh: Mesh):
    """Data-parallel batched solve: batch sharded over the mesh's 'data' axis
    via shard_map, with zero collectives (each device owns whole problems).
    Batch size must be divisible by the data-axis size.
    """
    import jax.numpy as jnp

    fn = _solve_batch_sharded_fn(mesh, cfg.static_key)
    dyn = jax.tree.map(jnp.float32, cfg.dynamic)
    return fn(shard_batch(ops_batched, mesh), dyn)

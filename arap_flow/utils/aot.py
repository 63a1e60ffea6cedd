"""Executable pack: cross-process AOT cache of compiled XLA executables.

The cold-start problem this solves: every process compiles each solver
program it runs, so an N-worker farm (host_ceiling.py --multi, the
reference's para_gen.py:560-567 deployment shape) multiplies the compile
set by up to N where the persistent compile cache misses. The reference had the same per-size plan-reuse economics
(CombinedSolver.h:149-160 — "plan compile time printed per image size, plan
reused across same-size frames"); its unit of reuse was a process-local plan,
ours is a SERIALIZED EXECUTABLE shared by every process on the host.

Mechanism: `jax.experimental.serialize_executable` pickles a compiled
executable that a fresh process loads without compiling. With
`ARAP_EXEC_PACK=dir` set:

  - the canvas dispatch (models/arap.solve_and_raster_canvas) looks its
    program key up in the pack and CALLS the deserialized executable,
    skipping jit entirely;
  - on a miss it AOT-compiles (`.lower().compile()` — same cost as jit),
    saves the serialized executable into the pack, and uses it — the
    pack is self-building: one cold run (or `--warmup`) populates it for
    every later process.

Keys include jax version + platform + every static argument + all input
shapes/dtypes; entries are content-addressed files, written atomically, so
concurrent workers can share one pack directory. Any failure (missing file,
version skew, deserialize error) falls back to the normal jit path.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import threading

_LOG = logging.getLogger(__name__)

_BOOK = threading.Lock()          # bookkeeping (dicts below)
_LOADED: dict = {}                # key -> loaded executable
_FAILED: set = set()              # keys that missed / failed (no retry)
_KEY_LOCKS: dict = {}             # key -> compile lock (one compile per key)


def pack_dir() -> str | None:
    """The executable-pack directory, or None when packing is disabled."""
    d = os.environ.get("ARAP_EXEC_PACK", "")
    return d or None


def _platform_tag() -> tuple:
    import jax

    return (jax.__version__, jax.devices()[0].platform)


def canvas_key(tree_args, static_kwargs) -> tuple:
    """Program identity: platform + static args + every leaf shape/dtype."""
    import jax

    leaves = jax.tree.leaves(tree_args)
    shapes = tuple(
        (tuple(getattr(l, "shape", ())), str(getattr(l, "dtype", type(l))))
        for l in leaves
    )
    return (_platform_tag(), tuple(sorted(static_kwargs.items())), shapes)


def _path(key) -> str:
    h = hashlib.sha1(repr(key).encode()).hexdigest()[:32]
    return os.path.join(pack_dir(), h + ".jaxexec")


def lookup(key):
    """Deserialized executable for `key`, or None (miss/error — jit path)."""
    if pack_dir() is None:
        return None
    with _BOOK:
        if key in _LOADED:
            return _LOADED[key]
        if key in _FAILED:
            return None
    path = _path(key)
    if not os.path.exists(path):
        with _BOOK:
            _FAILED.add(key)
        return None
    try:
        from jax.experimental import serialize_executable as se

        with open(path, "rb") as f:
            payload = pickle.loads(f.read())
        comp = se.deserialize_and_load(*payload)
        with _BOOK:
            _LOADED[key] = comp
        return comp
    except Exception as exc:  # noqa: BLE001 — any pack failure means "use jit"
        # visible, not fatal: a silently-broken pack (version skew, partial
        # write) would otherwise cost every worker a full compile with zero
        # diagnostics
        _LOG.warning("exec-pack entry %s failed to load (%s: %s) — "
                     "falling back to compile", os.path.basename(path),
                     type(exc).__name__, exc)
        with _BOOK:
            _FAILED.add(key)
        return None


def compile_and_save(key, jitted, args, static_kwargs):
    """AOT-compile `jitted` for (args, static_kwargs), persist into the pack,
    and return the executable. One compile per key per process; concurrent
    same-key callers block on the compile like the jit path's _SIG_LOCKS."""
    with _BOOK:
        lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with lock:
        with _BOOK:
            if key in _LOADED:  # raced: another thread compiled it
                return _LOADED[key]
        comp = jitted.lower(*args, **static_kwargs).compile()
        try:
            from jax.experimental import serialize_executable as se

            payload = se.serialize(comp)
            os.makedirs(pack_dir(), exist_ok=True)
            path = _path(key)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(pickle.dumps(payload))
            os.replace(tmp, path)  # atomic: concurrent workers share the dir
        except Exception as exc:  # noqa: BLE001 — persistence is best-effort
            _LOG.warning("exec-pack save failed (%s: %s) — executable kept "
                         "in-process only", type(exc).__name__, exc)
        with _BOOK:
            _LOADED[key] = comp
        return comp


def stats() -> dict:
    with _BOOK:
        return {"loaded": len(_LOADED), "missed": len(_FAILED)}

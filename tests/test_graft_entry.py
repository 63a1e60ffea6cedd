"""Driver entry-point checks.

__graft_entry__.dryrun_multichip(n) may be called from a process whose backend
has one device, so the entry must self-provision its virtual CPU mesh. These
tests exercise exactly that contract: call the public function from an env
that does NOT pre-set the virtual device count.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_entry(code: str, extra_env=None):
    """Run `code` in a subprocess whose env does NOT force a virtual mesh."""
    env = dict(os.environ)
    # no forced host device count
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600,
    )


def test_dryrun_multichip_self_provisions():
    r = _run_entry("import __graft_entry__ as g; g.dryrun_multichip(8)")
    assert r.returncode == 0, r.stdout
    assert "dryrun_multichip ok" in r.stdout


def test_dryrun_multichip_strips_stale_device_count():
    # Even if the caller's XLA_FLAGS pin a DIFFERENT device count, the entry
    # must override it for the subprocess.
    r = _run_entry(
        "import __graft_entry__ as g; g.dryrun_multichip(4)",
        extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"},
    )
    assert r.returncode == 0, r.stdout
    assert "dryrun_multichip ok" in r.stdout


@pytest.mark.slow
def test_entry_compiles():
    import jax

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.remove(REPO)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert all(bool(x) for x in jax.tree.leaves(jax.tree.map(
        lambda a: jax.numpy.isfinite(a).all(), out)))

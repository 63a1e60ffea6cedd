"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so sharding paths are
exercised without accelerators, and without the persistent compilation cache
(each test run compiles afresh and writes nothing into the checkout).
"""

import os


def _force_device_count(flags: str, n: int = 8) -> str:
    """REPLACE any pre-existing xla_force_host_platform_device_count rather
    than keeping it: a stale ambient flag with a count < 8 would make every
    multi-device test (sharded pipeline byte-identity, spatial halo,
    sharded prewarm) silently skip via its len(jax.devices()) guard and the
    suite would go green with the multi-chip coverage gone."""
    import re as _re

    flags = _re.sub(
        r"--xla_force_host_platform_device_count=\d+", "", flags
    ).strip()
    return (flags + f" --xla_force_host_platform_device_count={n}").strip()


os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ARAP_NO_COMPILE_CACHE", "1")
os.environ["XLA_FLAGS"] = _force_device_count(os.environ.get("XLA_FLAGS", ""))

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE.exists():
        pytest.skip("reference tree not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def cat512_deform(reference_root):
    """Golden deformation fixture paths (ARAP/deformation/cat512_*)."""
    d = reference_root / "ARAP" / "deformation"
    return {
        "rgb": d / "cat512_iRGB.png",
        "mask": d / "cat512_iMsk.png",
        "cstr": d / "cat512_iCstr.txt",
        "wrgb": d / "cat512_wRGB.png",
        "wmask": d / "cat512_wMsk.png",
    }


@pytest.fixture(scope="session")
def cat512_warp(reference_root):
    """Golden warping fixture paths (ARAP/warping/cat512_*)."""
    d = reference_root / "ARAP" / "warping"
    return {
        "rgb": d / "cat512_iRGB.png",
        "mask": d / "cat512_iMsk.png",
        "flo": d / "cat512_iFlo.flo",
        "wrgb": d / "cat512_wRGB.png",
        "wmask": d / "cat512_wMsk.png",
    }

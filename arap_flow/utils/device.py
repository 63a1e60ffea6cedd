"""The accelerator a measurement runs on.

A measured time means nothing without the device it was taken on, so every
measurement entry point (bench.py, chip_smoke.py, scripts/pcg_probe.py)
calls require_gpu(): it names the device, and refuses to time anything but
a GPU instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` lines, or why they are
    missing. Power limits below the card's maximum lower its clocks."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"


def require_gpu(min_count: int = 1) -> dict:
    """{platform, kind, count, smi} of the default JAX backend; raises
    SystemExit(2) unless it is a GPU backend with >= min_count devices."""
    import jax

    platform = jax.default_backend()
    devices = jax.devices()
    if platform != "gpu" or len(devices) < min_count:
        raise SystemExit(
            f"needs {min_count} GPU device(s); JAX found {len(devices)} "
            f"{platform!r} device(s)"
        )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "smi": gpu_name_and_power(),
    }

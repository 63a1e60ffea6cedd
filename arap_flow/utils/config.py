"""Unified typed configuration.

The reference scatters configuration over four mechanisms (SURVEY.md §5):
argparse CLI flags (para_gen.py:611-639), environment variables ($ARAP_PLAN,
$CUDA_VISIBLE_DEVICES), compiled-in CombinedSolverParameters + hardcoded energy
weights (CombinedSolver.h:173-174, main.cpp:215-221), and Opt's name-keyed
solver parameters. Here everything funnels into one dataclass; environment
overrides use the ARAP_* prefix.

Env vars:
- ARAP_SCHEDULE       parity | fast            (solver schedule preset)
- ARAP_BACKEND        xla                      (the one solve path; any
                                                other value raises)
- ARAP_RASTER         device | host            (rasterizer)
- ARAP_MATCHER        native | binary | file   (correspondence source)
- ARAP_W_FIT / ARAP_W_REG                       (energy weights)
- ARAP_NATIVE_DISABLE 1                         (skip the C++ runtime)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..ops.energy import ArapWeights
from ..ops.solver import SolverConfig


@dataclass
class FrameworkConfig:
    solver: SolverConfig = field(default_factory=SolverConfig)
    weights: ArapWeights = field(default_factory=ArapWeights)
    raster: str = "device"  # device | host
    matcher: str = "native"  # native | binary | file
    crop: bool = True  # bbox-crop per-segment solves (exact)
    async_io: bool = True  # native threaded writer for .flo/PNG
    io_threads: int = 4

    @classmethod
    def from_env(cls, **overrides) -> "FrameworkConfig":
        """Construct from keyword overrides, then apply ARAP_* env overrides
        on top (env wins — the $ARAP_PLAN precedence model, main.cpp:206-213).

        Consumed by pipeline/para_gen.main_pipeline, pipeline/deform_tool and
        models.ArapDeformer, so the env vars take effect end to end."""
        cfg = cls(**overrides)
        sched = os.environ.get("ARAP_SCHEDULE")
        if sched == "fast":
            cfg.solver = cfg.solver._replace(
                pcg_iters_early=150.0, anneal_split=12.0
            )
        elif sched == "parity":
            cfg.solver = cfg.solver._replace(
                pcg_iters_early=0.0, anneal_split=0.0, q_tolerance=0.0,
                rz_tolerance=0.0,
            )
        backend = os.environ.get("ARAP_BACKEND")
        if backend not in (None, "", "xla"):
            raise ValueError(
                f"ARAP_BACKEND={backend!r}: the solver has one path (XLA); "
                "the Pallas and fused backends were removed"
            )
        raster = os.environ.get("ARAP_RASTER")
        if raster in ("device", "host"):
            cfg.raster = raster
        matcher = os.environ.get("ARAP_MATCHER")
        if matcher in ("native", "binary", "file"):
            cfg.matcher = matcher
        wf = os.environ.get("ARAP_W_FIT")
        wr = os.environ.get("ARAP_W_REG")
        if wf or wr:
            cfg.weights = ArapWeights(
                w_fit=float(wf) if wf else cfg.weights.w_fit,
                w_reg=float(wr) if wr else cfg.weights.w_reg,
            )
        return cfg

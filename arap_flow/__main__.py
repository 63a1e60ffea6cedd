"""Unified CLI: ``python -m arap_flow <command> [args...]``.

Commands map to the reference driver surface (SURVEY.md §2.1):
para_gen, generate, run_arap, run_warp, deform (arap_deform), warp
(warp_image), texture_gen.
"""

import sys

COMMANDS = {
    "para_gen": ("arap_flow.pipeline.para_gen", "main"),
    "generate": ("arap_flow.pipeline.generate", "main"),
    "run_arap": ("arap_flow.pipeline.run_arap", "main"),
    "run_warp": ("arap_flow.pipeline.run_warp", "main"),
    "deform": ("arap_flow.pipeline.deform_tool", "main"),
    "warp": ("arap_flow.pipeline.warp_tool", "main"),
    "texture_gen": ("arap_flow.pipeline.texture_gen", "main"),
    "dmo_gen": ("arap_flow.pipeline.dmo_gen", "main"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m arap_flow <command> [args...]")
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    import importlib

    mod, fn = COMMANDS[argv[0]]
    return getattr(importlib.import_module(mod), fn)(argv[1:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())

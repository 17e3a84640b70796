"""Command-line entry point:
``python -m blacklight_tpu_torch [--device cuda|cpu] <input file>``.

Mirrors ``blacklight_tpu/cli.py`` (reference src/blacklight.cpp:31-273):
one input file, friendly errors, exit code 1 on failure. The device is
``cuda`` unless ``--device cpu`` is given; ``cuda`` fails when PyTorch
sees no GPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m blacklight_tpu_torch",
        description="Render a blacklight input file with the PyTorch port.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to render (default: cuda)")
    parser.add_argument("input_file")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from blacklight_tpu.utils.errors import BlacklightError

    try:
        from blacklight_tpu.utils.config import read_config
        from blacklight_tpu_torch import pipeline

        cfg = read_config(args.input_file)
        for _ in range(cfg.num_runs):
            pipeline.run(cfg, device=args.device)
    except (BlacklightError, OSError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

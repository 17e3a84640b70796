"""Errors and warnings (reference src/utils/exceptions.hpp:1-42)."""

import sys


class BlacklightError(RuntimeError):
    """Fatal configuration or data error ("Error: ..." in the reference)."""

    def __init__(self, message: str):
        super().__init__(message)


def blacklight_warning(message: str) -> None:
    """Non-fatal warning printed to stderr, as the reference's BlacklightWarning."""
    print(f"Warning: {message}", file=sys.stderr, flush=True)

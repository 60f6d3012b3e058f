"""Shared constants of the CPU tests."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# small shapes for the CPU: 6 x 4 macroblocks, GOPs of 3 frames
TINY = {"encoder": {"width": 96, "height": 64, "gop_n": 3}}
TINY_RC = {"encoder": {"width": 96, "height": 64, "gop_n": 3,
                       "target_kbps": 300}}


def tiny(workload: str) -> dict:
    """Overrides that shrink a cell's configuration to CPU size."""
    return TINY_RC if workload.startswith("rcmb") else TINY

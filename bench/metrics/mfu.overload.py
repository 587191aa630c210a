"""Model FLOPs of the window's ticks over their summed walls at the bf16
peak, %."""

from harness.readers import serve_mfu as read  # noqa: F401

LAYER = "whole engine step"
SOURCE = "program_span"
UNIT = "%"
MOVES = "tokens_per_s"


"""Percent of the traced window of a CTR cell that no kernel, copy or set on the card covers, which moves
``rows_per_s``; the arithmetic is ``idle_share.py``'s."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name("idle_share.py")).read

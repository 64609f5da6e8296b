"""Rows that every completed update consumed, over the whole window (compute and reset included): the CTR
cells' throughput, which the host paces, kept apart from the card-paced images of the segmentation cells so
that each has its own bound. The arithmetic is ``samples_per_s.py``'s."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name("samples_per_s.py")).read

"""Blocking host reads an append makes in the CTR cells, which moves ``rows_per_s``; the arithmetic is
``update_host_reads.py``'s."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name("update_host_reads.py")).read

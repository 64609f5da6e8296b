"""Host time of the input checks an append makes in the CTR cells, which moves ``rows_per_s``; the arithmetic
is ``validate_host_ms.py``'s."""
from pathlib import Path

from harness import load_module

read = load_module(Path(__file__).with_name("validate_host_ms.py")).read

"""Rank-zero-gated warnings and log lines (reference `src/torchmetrics/utilities/prints.py:22-50`)."""
from __future__ import annotations

import logging
import os
import warnings
from functools import wraps
from typing import Any, Callable

log = logging.getLogger(__name__)


def _process_index() -> int:
    # the launcher's env vars, so that a warning never initialises a process group
    for var in ("RANK", "LOCAL_RANK"):
        if var in os.environ:
            try:
                return int(os.environ[var])
            except ValueError:
                continue
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Call ``fn`` only on process 0."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, stacklevel: int = 4, **kwargs: Any) -> None:
    warnings.warn(message, *args, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)


__all__ = ["rank_zero_debug", "rank_zero_info", "rank_zero_only", "rank_zero_warn"]

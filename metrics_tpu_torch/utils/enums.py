"""Option-string enums with forgiving parsing.

A copy of `metrics_tpu/utils/enums.py` (reference
`src/torchmetrics/utilities/enums.py:18-83`): the port keeps its own so it
imports nothing of the JAX package.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """String enum accepting case-insensitive, ``-``/``_``-agnostic values."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    @classmethod
    def from_str_or_raise(cls, value: Union[str, "EnumStr", None], arg: str = "value") -> "EnumStr":
        if isinstance(value, cls):
            return value
        if value is None:
            raise ValueError(f"`{arg}` must be one of {[e.value for e in cls]}, got None")
        member = cls.from_str(str(value))
        if member is None:
            raise ValueError(f"`{arg}` must be one of {[e.value for e in cls]}, got {value!r}")
        return member

    @staticmethod
    def _canon(value: str) -> str:
        return value.replace("-", "_").lower()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Enum):
            other = other.value
        if isinstance(other, str):
            return self._canon(self.value) == self._canon(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._canon(self.value))


class DataType(EnumStr):
    """Classification input kinds recognised by the input-format engine."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


__all__ = ["EnumStr", "DataType", "AverageMethod", "MDMCAverageMethod"]

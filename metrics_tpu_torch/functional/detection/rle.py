"""COCO run-length-encoded mask codec (host-side numpy).

A copy of the JAX package's `metrics_tpu/functional/detection/rle.py` (numpy
only; the port imports nothing of the JAX package). Replaces pycocotools
``mask_utils`` for mask I/O (reference `detection/mean_ap.py:30-34,127-143`):
RLE is a storage codec, not compute — masks are decoded once on the host
and the IoU itself runs on device as a dense matmul
(`functional/detection/box_ops.py mask_iou`). Both COCO RLE
forms are supported:

- uncompressed: ``{"size": [h, w], "counts": [int, ...]}``
- compressed:   ``{"size": [h, w], "counts": bytes-or-str}`` using COCO's
  modified-LEB128 string encoding (each value packed 5 bits per char offset
  by 48, with delta coding from the 3rd run onward).

COCO counts alternate runs of 0s and 1s in COLUMN-major (Fortran) order,
starting with zeros.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

import numpy as np


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """COCO's LEB128-like string → run lengths (pycocotools `rleFrString`)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)  # sign-extend
        if len(counts) > 2:
            x += counts[-2]  # delta coding
        counts.append(x)
    return counts


def _encode_compressed_counts(counts: Sequence[int]) -> bytes:
    """Run lengths → COCO LEB128-like string (pycocotools `rleToString`)."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """Decode one COCO RLE dict to a boolean ``(h, w)`` mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum to {total}, expected {h * w}")
    # runs alternate 0/1 starting with zeros, column-major
    flat = np.zeros(h * w, dtype=bool)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i] : ends[i]] = True
    return flat.reshape((w, h)).T  # column-major


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict[str, Any]:
    """Encode a boolean ``(h, w)`` mask as a COCO RLE dict."""
    mask = np.asarray(mask, dtype=bool)
    h, w = mask.shape
    flat = mask.T.reshape(-1)  # column-major
    # run-length encode, starting with a zero-run (possibly empty)
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    out: Dict[str, Any] = {"size": [h, w]}
    out["counts"] = _encode_compressed_counts(counts) if compress else counts
    return out


def masks_from_any(masks: Any) -> np.ndarray:
    """Normalize masks input to a dense boolean ``(n, h, w)`` array.

    Accepts a dense array, one RLE dict, or a sequence of RLE dicts — the
    input surface of the reference's segm path.
    """
    if isinstance(masks, dict):
        return rle_decode(masks)[None]
    if isinstance(masks, (list, tuple)) and masks and isinstance(masks[0], dict):
        return np.stack([rle_decode(m) for m in masks])
    arr = np.asarray(masks, dtype=bool)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


__all__ = ["rle_decode", "rle_encode", "masks_from_any"]

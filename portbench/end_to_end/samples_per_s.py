"""Images or rows that every completed update consumed, over the whole window (compute and reset included)."""


def read(window: dict):
    return window["samples"] / window["seconds"] if window["samples"] else None

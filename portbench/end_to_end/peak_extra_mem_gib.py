"""The allocator's peak in the window less what was allocated when it began (inputs, evaluation set), GiB."""


def read(window: dict):
    return window["peak_extra_bytes"] / 2**30

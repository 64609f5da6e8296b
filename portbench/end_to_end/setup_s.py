"""From the process's start to the first timed step: imports, inputs, the suite, the build, the warm-up."""


def read(window: dict):
    return window["setup_s"]

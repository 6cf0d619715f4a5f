"""setup_s: seconds from the run's start to its first timed call (imports,
inputs, the model's build, the warm-up, and in a first run the kernels' build)."""


def read(window):
    return window["setup_s"]

"""radtran_columns_per_s: every column completed in the window over the window's
host seconds (the window ends with the first call that finishes past its
length, so it holds whole calls only)."""


def read(window):
    return window["columns"] / window["window_s"]

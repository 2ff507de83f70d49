"""Seconds from the process's start to the window's: imports, the card's
context, the data, the kernels' build or load, ``fit``, the SVM's fit
and the warm-up (host clock)."""


def read(run):
    return run["setup_s"]

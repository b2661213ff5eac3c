"""Seconds from the process's start to the window's opening: imports,
the kernels' build or load, weights, the server, the traffic warm-up."""


def read(rec):
    return rec["setup_s"]

"""Seconds from the process's start to the first timed point: imports, the
card's context, the kernel library's build or load, and the warm-up points
of every shape the cell runs."""


def read(record):
    return record.setup_s

"""The process's start to the first timed frame: imports, the kernels'
load (or build), the world build and the warm-up frames."""


def read(rec):
    return rec.setup_s

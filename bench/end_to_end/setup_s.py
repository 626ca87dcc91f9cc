"""Seconds from the process's start to the window's: imports, the kernel
library, the artifact's load, the engine, the traffic pool, warm batches
(and, in a checkout's first run, the artifact's build)."""


def read(run):
    return run.setup_s

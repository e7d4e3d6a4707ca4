"""Seconds from the process's start to the window's: importing, the CUDA
context, loading (on a checkout's first run, building) the kernel library,
drawing and packing every scene, filling the cache, the warm-up."""


def read(run):
    return run.setup_s

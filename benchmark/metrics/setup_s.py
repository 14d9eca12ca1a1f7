"""Seconds from the harness's start to the window's first call: imports,
the CUDA context, the kernel libraries (built on a checkout's first run),
and the warm call or phases."""


def read(rec):
    return rec.get("setup_s")

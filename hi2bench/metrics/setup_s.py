"""Seconds from the process's start to the window's first request:
imports, the CUDA context, the planes and query pool on the card, the
server and runtime, graph capture and the warm traffic (an open mix's
lead-in too)."""


def read(ctx):
    return ctx.setup_s

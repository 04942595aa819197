"""Constant tensors cached on their device.

A static tensor (a DFT matrix, a gather index, a grid of coordinates) is
built once a device and kept: copying a host array in every forward would
synchronise the stream. While torch.export (or torch.compile) traces, the
tensors are fake ones, which must not stay in the cache; there the
constant is built afresh and the tracer lifts it into the program.
"""

from __future__ import annotations

import functools

import torch


def device_constant(fn):
    """`functools.lru_cache` for a function that builds a constant tensor,
    bypassed while a tracer runs (`torch.compiler.is_compiling()`)."""
    cached = functools.lru_cache(maxsize=32)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        return cached(*args)

    wrapper.cache_info = cached.cache_info
    wrapper.cache_clear = cached.cache_clear
    return wrapper

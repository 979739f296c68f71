"""Kernels run on the card per interior-point iteration in the cycle
profiled with CUDA activity alone (phase C)."""


def read(data):
    return data.launches / data.iterations if data.launches and data.iterations else None

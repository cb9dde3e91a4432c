"""Seconds spent building and loading the cell's own CUDA sources
(ops/cuda_build), a harness span inside set-up."""


def read(ctx, name):
    return ctx["build_s"]

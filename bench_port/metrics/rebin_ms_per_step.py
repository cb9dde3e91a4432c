"""Device ms per step inside the profiler ranges wrapped around
sortedforce.needs_rebuild, rebuild_if and rebuild_state (PyTorch ops only,
so the ranges hold their device time)."""


def read(ctx, name):
    t = ctx["trace"]
    s = t["ranges"].get("bench.rebin", 0.0)
    return 1e3 * s / t["steps"] if s > 0 else None

"""Percent of the window's wall time spent in Simulation.thermo (the host
clock around it, wrapped from outside), in the unprofiled window."""


def read(ctx, name):
    w = ctx["window"]
    return 100.0 * w["thermo_s"] / w["wall_s"]

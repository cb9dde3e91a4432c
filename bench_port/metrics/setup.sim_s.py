"""Seconds of the deck front end and Simulation.setup: atoms, velocities,
grid sizing, the first list and the first force pass and thermo row (the
deck's `run 0`), a harness span inside set-up."""


def read(ctx, name):
    return ctx["sim_s"]

"""Plain-PyTorch reference of the benchmark's decks.

Written from the published deck settings and LAMMPS's equations alone: it
imports no module of the port and takes no table the port built. It runs
in float64 (the `REF` precision) and, as the lower-precision control of
`check.py`, with bfloat16 pair arithmetic over float32 state (`CONTROL`).
Pairs are found from positions alone (`neighbors.half_pairs`), in blocks,
so it fits beside a 1M-atom state.
"""

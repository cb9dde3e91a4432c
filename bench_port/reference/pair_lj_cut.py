"""The reference of `pair_style lj/cut` (one type): the configuration's
`pair` block gives epsilon, sigma and the cutoff, its `mass` the mass."""

from bench_port.reference.models import LJ


def build(config: dict, potential_path, band: float):
    pair = config["pair"]
    return (LJ(pair["epsilon"], pair["sigma"], pair["cutoff"], band),
            config["mass"])

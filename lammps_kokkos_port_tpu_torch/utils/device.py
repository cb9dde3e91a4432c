"""Where an entry point runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device. A CUDA device on a machine without one
    raises instead of running on the CPU: the entry points default to the
    card, and a run that silently took the plain CPU paths would be a
    different measurement."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev

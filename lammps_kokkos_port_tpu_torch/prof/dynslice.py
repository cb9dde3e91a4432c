"""Dynamic lane windows on the card: prof_dynslice.py's microbenchmark.

Counterpart of benchmarks/prof/prof_dynslice.py: NCOL = 128 columns, each
summing NCH = 20 windows of W = 128 lanes taken at the offsets of the
script's `starts` table (`clip(arange(NCOL * NCH) * 7 % (G - W), 0, G - W)`
with G = 512), through P1 (prof/dynslice_kernels `dynslice`). It prints the
script's three labels, each `<ms> ms/iter -> <ns> ns per window`:

  roll-1d-dyn, roll-2d-dyn   mode "wrap" (pltpu.roll: (s + j) mod G);
  dynslice-2d                mode "clamp" (lax.dynamic_slice: the start
                             clamped to [0, G - W]);

on two shapes. The script's docstring and its `ext` describe windows cut
from `ext [128, 512]` of ones; its timed scan passes the scan carry as
`ext` (`f(starts, c)`, :66), a [128, 128] array of zeros (`ext[:, :W] * 0`,
:67), so its loop ran at G = 128, where the two modes differ. The first
block of lines is the documented shape (ext [128, 512] of ones, the body
`out + EPS * f(starts, ext)`); the second, labelled "as run", is the
script's loop (the carry c [128, 128] of zeros, `c + EPS * f(starts, c)`).
Each time is the slope of k = 20 and 60 iterations (prof.timing.slope_ms:
CUDA graphs on the card), where the script divides one run of 50
iterations by 50.

Run on the card: `python -m lammps_kokkos_port_tpu_torch.prof.dynslice`;
on the CPU: `main(device="cpu", k1=1, k2=2)`.
"""

from __future__ import annotations

import argparse

import torch

from ..utils.device import resolve
from .dynslice_kernels import dynslice
from .timing import EPS, device_line, say, slope_ms

G, W, NCH, NCOL = 512, 128, 20, 128  # the script's constants (:13-16)
LABELS = (("roll-1d-dyn", "wrap"), ("roll-2d-dyn", "wrap"),
          ("dynslice-2d", "clamp"))


def script_starts(device) -> torch.Tensor:
    """The script's starts [NCOL, NCH] int32 (:60)."""
    s = torch.arange(NCOL * NCH, dtype=torch.int32).reshape(NCOL, NCH)
    return torch.clamp(s * 7 % (G - W), 0, G - W).to(device)


def main(device="cuda", k1: int = 20, k2: int = 60, reps: int = 1) -> dict:
    """Print the script's lines on both shapes (f32, as the script); return
    {label: ms}."""
    dev = resolve(device)
    say(device_line(dev))
    starts = script_starts(dev)
    ext = torch.ones((NCOL, G), device=dev)
    out = {}
    for shape in ("ext [128, 512] of ones", "as run: ext = carry [128, 128]"):
        say(f"{shape}:")
        for label, mode in LABELS:
            if shape.startswith("as run"):
                def body(c, mode=mode):
                    return c + EPS * dynslice(starts, c, W, mode)

                carry = torch.zeros((NCOL, W), device=dev)
                key = f"{label} (as run)"
            else:
                def body(c, mode=mode):
                    return (c[0], c[1] + EPS * dynslice(starts, c[0], W,
                                                        mode))

                carry = (ext, torch.zeros((NCOL, W), device=dev))
                key = label
            ms = slope_ms(body, carry, k1, k2, reps)
            out[key] = ms
            say(f"{label}: {ms:.4f} ms/iter -> "
                f"{ms * 1e-3 / (NCOL * NCH) * 1e9:.0f} ns per window")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device)

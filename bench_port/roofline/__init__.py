"""The yardstick of the kernel rooflines and of `step_mfu`: the card's
published peaks, the operations per pair and per row of each kernel's
work (`kernels/<kernel>.json`) and `bound_s`, the least time the card could
take for it."""

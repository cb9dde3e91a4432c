"""Percent of the card's peak of the configuration's type (67 TFLOP/s f32,
34 f64, outside the tensor cores) in the work a step needs: the pairs within the cutoff of the end state times
the operations of each of the cell's kernels per pair, plus their per-row
operations, over the step time of the unprofiled window."""

from bench_port.roofline import peaks


def read(ctx, name):
    ops = sum(peaks.work_ops(k, ctx["pairs"], ctx["natoms"])
              for k in ctx["kernels"] if peaks.kernel_work(k))
    w = ctx["window"]
    step_s = w["wall_s"] / w["steps"]
    return 100.0 * ops / step_s / peaks.PEAK_OPS_PER_S[ctx["dtype"]]

"""Percent of the card's peak of the configuration's type (67 TFLOP/s f32,
34 f64, outside the tensor cores) in the work a step needs: each of the
cell's kernels' operations on the end state's counts (pairs within the
cutoff, atoms, triplets where a kernel counts them; roofline/peaks
.work_ops), over the step time of the unprofiled window."""

from bench_port.roofline import peaks


def read(ctx, name):
    ops = sum(peaks.work_ops(k, ctx["counts"])
              for k in ctx["kernels"] if peaks.kernel_work(k))
    w = ctx["window"]
    step_s = w["wall_s"] / w["steps"]
    return 100.0 * ops / step_s / peaks.PEAK_OPS_PER_S[ctx["dtype"]]

"""The routed experts' grouped products (the kernels named ``moe_*``) in
training: their least time over the window
(``counts_dsv2_lite.routed_bound_s``: the program's ``moe.assignments``
times each expert's 6 D I forward FLOPs, times 3, at 67 TFLOP/s f32, or
their bytes at 3.35 TB/s, the larger) over the device time of the kernels
whose name holds ``moe_``. Nothing without the counter or the kernels."""

from harness import counts_dsv2_lite


def read(m):
    assignments = getattr(m, "assignments", None)
    tower = getattr(m, "tower", None)
    spent = m.trace.kernel_seconds(r"moe_")
    if assignments is None or tower is None or spent <= 0:
        return None
    least = counts_dsv2_lite.routed_bound_s(tower, assignments,
                                            len(m.log["lengths"]))
    return 100.0 * least / spent

"""``gru_fwd`` (K1) in training: the least time of the window's K1 calls
(``counts.gru_bound_s``: live row-steps at 67 TFLOP/s f32, or each stream
once at 3.35 TB/s) over the device time of the kernels named
``gru_fwd*``."""

from harness import counts


def read(m):
    spent = m.trace.kernel_seconds(r"gru_fwd(_streamed)?_kernel")
    if not m.log["lengths"] or spent <= 0:
        return None
    least = sum(counts.gru_step_bounds(s, m.model_cfg)[0]
                for s in m.log["lengths"])
    return 100.0 * least / spent

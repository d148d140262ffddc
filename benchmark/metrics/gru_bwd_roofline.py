"""``gru_bwd`` (K2) in training: the least time of the window's K2 calls
(``counts.gru_bound_s`` with ``backward=True``) over the device time of
the kernels named ``gru_bwd*``."""

from harness import counts


def read(m):
    spent = m.trace.kernel_seconds(r"gru_bwd(_streamed)?_kernel")
    if not m.log["lengths"] or spent <= 0:
        return None
    least = sum(counts.gru_step_bounds(s, m.model_cfg)[1]
                for s in m.log["lengths"])
    return 100.0 * least / spent

"""Share of the card's float32 peak (67 TFLOP/s, TF32 off) that the
window's model FLOPs make in a cell whose sentence encoder is a DeepSeek-V2
stack: the forward matrix products over live tokens and steps
(``harness/counts_dsv2_lite.py``: the stack's token products, attention,
the routed experts from the program's ``moe.assignments`` counter, the
readout, and the rest of CMHSE as ``harness/counts.py`` counts it without
``text_low``'s GRU), times 3, over the traced window's seconds. Nothing
without the counter (a program that has no stack)."""

from harness import counts, counts_dsv2_lite


def read(m):
    steps = m.log["lengths"]
    assignments = getattr(m, "assignments", None)
    tower = getattr(m, "tower", None)
    if not steps or assignments is None or tower is None:
        return None
    flops = sum(counts_dsv2_lite.step_flops(s, m.model_cfg, tower)
                for s in steps)
    flops += counts_dsv2_lite.routed_flops(tower, assignments)
    return 100.0 * flops / m.window_s / counts.PEAKS["f32"]

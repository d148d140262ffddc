"""Share of the card's float32 peak (67 TFLOP/s, TF32 off) that the
window's model FLOPs make: forward matrix products over live steps (the
encoders, attention pools, decoders and both ranking products) times 3,
over the traced window's seconds."""

from harness import counts


def read(m):
    steps = m.log["lengths"]
    if not steps:
        return None
    flops = sum(counts.train_step_flops(s, m.model_cfg) for s in steps)
    return 100.0 * flops / m.window_s / counts.PEAKS["f32"]

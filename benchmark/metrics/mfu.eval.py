"""The whole program's share of the card's bfloat16 peak, %: the plain
reference's FLOPs an image at the cell's shapes (``FlopCounterMode``) times
the images a second of the untraced part of the window, over 989 TFLOP/s."""


def read(r):
    if r.ref_flops_per_unit is None or not r.steady_rate:
        return None
    return 100.0 * r.ref_flops_per_unit * r.steady_rate / r.peak_bf16_flops

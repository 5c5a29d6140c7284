"""The RPN, device ms an image: the kernels launched inside the program's
``glass.rpn`` span (head outputs to proposals: top-k, decoding, rotated
NMS), in the traced part of the window."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    return r.trace.span_device_s("glass.rpn") / r.traced_units * 1e3

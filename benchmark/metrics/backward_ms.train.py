"""The training step's backward, device ms a step: the kernels launched
inside the program's ``glass.backward`` span (on any thread), in the traced
part of the window."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    return r.trace.span_device_s("glass.backward") / r.traced_units * 1e3

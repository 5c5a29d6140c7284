"""Host post-processing, ms an image: the benchmark's span around the
runner's ``_model_postprocess`` and post-processor, summed over the
window's untraced part, over its images."""


def read(r):
    span = r.host_spans.get("host_post")
    if not span or not r.span_units:
        return None
    return span[0] / r.span_units * 1e3

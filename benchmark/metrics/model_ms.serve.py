"""The model program, ms an image: ``glass_inference_single`` on one
padded scene staged on the card, host clock ending in a synchronize, after
the window."""


def read(r):
    s = r.probes.get("model_s_per_image")
    return None if s is None else s * 1e3

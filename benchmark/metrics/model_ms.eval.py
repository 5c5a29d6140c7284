"""The model program, ms an image: ``batch_model_fn()`` on the cell's batch
staged on the card, host clock ending in a synchronize, after the window."""


def read(r):
    s = r.probes.get("model_s_per_image")
    return None if s is None else s * 1e3

"""The port's measurement tools, each the counterpart of a glass_tpu script
under ``tools/`` (run as ``python -m glass_tpu_torch.tools.<name>``; the
product number is ``python -m glass_tpu_torch.bench``)."""

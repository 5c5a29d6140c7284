"""The port's released-checkpoint check, the counterpart of glass_tpu's
``tools/verify_released_checkpoint.py`` (run as
``python -m glass_tpu_torch.tools.verify_released_checkpoint``)."""

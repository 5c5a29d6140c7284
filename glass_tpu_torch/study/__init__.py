"""Measurements of the port's kernels that the port itself never runs
(``python3 -m glass_tpu_torch.study.kernel_variants`` on one GPU)."""

"""Device ops: rotated-box geometry and NMS in PyTorch, and the two kernels
(``roi_align_rotated``: K1, ``crop``: K2) with their plain versions."""

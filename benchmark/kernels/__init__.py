"""Each hand kernel's yardstick file, ``<kernel>.py``, found by
``harness/roofline.py::kernels``."""

"""Native (C++) polygon geometry of the evaluator and the post-processor,
loaded through ctypes.

Built with g++ at first use into the port's build directory, without FMA
contraction so that the post-processor's rotated IoU equals its numpy clip
bit for bit; callers fall back to their numpy or Python path when the
library is unavailable.
"""

from .build import load_polyclip, polyclip_path

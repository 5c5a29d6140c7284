"""Native (C++) polygon geometry of the evaluator and the post-processor,
loaded through ctypes.

Built with g++ at first use into the port's build directory, without FMA
contraction so that the post-processor's rotated IoU equals its numpy clip
bit for bit; callers fall back to their numpy, Python or cv2 path when a
library is unavailable.  ``load_contours`` is the mask polygons' contour
tracer.
"""

from .build import load_contours, load_polyclip, polyclip_path

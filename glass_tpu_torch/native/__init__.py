"""Native (C++) components of the evaluator, loaded through ctypes.

Built with g++ at first use into the port's build directory; callers fall
back to the Python path when the library is unavailable.
"""

from .build import load_polyclip, polyclip_path

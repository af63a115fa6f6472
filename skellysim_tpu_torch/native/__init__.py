"""Native (C++) trajectory helpers, loaded through ctypes.

The port's own copies of the JAX package's `native/` sources:
``frameenc.cpp`` (the fiber-array frame encoder) and ``trajscan.cpp`` (the
frame index scanner), built with ``g++`` at first use (`build`).
"""

from .build import load_library

__all__ = ["load_library"]

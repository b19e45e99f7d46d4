"""PyTorch + CUDA port of the wavefront Whitted ray tracer.

A second package beside ``raytracer_tpu`` (the JAX reference, left unchanged).
Host-side scene building (``scene/``, ``accel/``, ``native/``) is this package's
own copy of the reference's numpy/C++ code; the device side (``ops/``,
``render/``) is torch plus hand-written CUDA kernels (``csrc/``, built and bound
by ``kernels/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .config import DEFAULT_CONFIG, RenderConfig  # noqa: F401

from . import aabb, matrix, quaternion, spline, vecmath  # noqa: F401

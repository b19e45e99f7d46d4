from .bvh import BVH, build_bvh  # noqa: F401

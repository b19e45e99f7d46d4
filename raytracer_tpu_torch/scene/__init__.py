from .camera import Camera  # noqa: F401
from .description import (  # noqa: F401
    DirectionalLight,
    Material,
    MaterialBuffer,
    MeshInstance,
    PlaneDesc,
    PointLight,
    SceneDescription,
    SphereDesc,
    SpotLight,
    Transform,
)
from .device import DeviceScene, pack_scene  # noqa: F401

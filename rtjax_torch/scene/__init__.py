"""Scene description: meshes, transforms, camera, materials, lights."""

from .camera import Camera  # noqa: F401
from .mesh import Mesh, load_ply  # noqa: F401
from .scene import Scene, SceneBuilder, scene_from_arrays  # noqa: F401
from .transform import Transform, rotate, scale, translate  # noqa: F401

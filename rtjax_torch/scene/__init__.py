"""Scene description: meshes, transforms, camera, materials, lights."""

from .camera import Camera  # noqa: F401
from .light import AREA_LIGHT, POINT_LIGHT, LightTable  # noqa: F401
from .material import GLASS, MATTE, MIRROR, MaterialTable  # noqa: F401
from .mesh import Mesh, load_ply, save_ply  # noqa: F401
from .scene import Scene, SceneBuilder, scene_from_arrays  # noqa: F401
from .transform import Transform, rotate, scale, translate  # noqa: F401

"""Multi-device rendering: sample-space sharding over torch.distributed
(port of rtjax.parallel)."""

from .multihost import (default_backend, init_from_env,  # noqa: F401
                        init_multihost, process_info)
from .sharding import (Mesh, make_mesh, rank_generator,  # noqa: F401
                       render_frame_linear_sharded, render_frame_sharded)

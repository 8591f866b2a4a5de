"""Multi-device scaling: device meshes, sharded detection and training.

- :mod:`.mesh` — 1-D data-parallel mesh helpers (jax.sharding).
- :mod:`.detect` — batched detection over image batches, sharded over the mesh.
- :mod:`.train_step` — the fully on-device boosting stage (histogram tree fit
  + SPRT threshold) whose cross-device exchange XLA lowers to all-gathers.
"""

from . import detect, mesh, train_step  # noqa: F401
from .mesh import make_mesh, shard_array  # noqa: F401
from .train_step import make_train_step  # noqa: F401

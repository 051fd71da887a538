"""Device-mesh orchestration (layer L5).

The reference parallelizes with joblib/loky processes + pickle
(utils/Parallelize.py); the device-mesh equivalents here are:

  * a ``halos`` device mesh: runners accept ``mesh=`` and shard the halo
    batch axis with jax.shard_map, psum-reducing per-device partial maps
    (SplitJoinParallel analog — same linear-sum semantics)
  * SimpleParallel: run independent runners (e.g. many shells) back to
    back, each on its own device of a multi-GPU host; each is internally
    device-parallel, so process pools add nothing — kept for API parity.
"""

from .mesh import halo_mesh, SimpleParallel, SplitJoinParallel

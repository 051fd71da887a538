"""baryonforge_tpu — a baryonification framework on JAX/XLA.

A ground-up JAX/XLA re-design with the capabilities of BaryonForge
(github.com/DhayaaAnbajagane/BaryonForge): baryonify N-body products (HEALPix
lightcone shells, 2D/3D grids, particle snapshots) against halo catalogs, and
paint thermodynamic fields from halo profiles — with the physics evaluated as
batched, jit-compiled array programs and the per-halo scatter loops replaced
by fixed-shape gather/scatter kernels sharded over a device mesh.

Layer map (mirrors SURVEY.md):
  cosmo/        L0  in-repo cosmology core (replaces pyccl)
  ops/          numerics + HEALPix geometry + scatter kernels
  profiles/     L1  halo profile models (Schneider19/25, Arico20, Mead20, ...)
  baryonification  L2  displacement model
  utils/        L3  tables, pixel windows, caching, IO
  runners/      L4  shell / grid / snapshot execution engines
  parallel/     L5  device-mesh orchestration
"""

import os

import jax

# The physics spans ~30 decades in density and the displacement function is a
# difference of nearly-equal inverse masses; the reference runs float64
# end-to-end. We enable x64 at import (opt out with BFG_TPU_NO_X64=1); hot
# map-scatter paths downcast to float32 explicitly where it is safe.
if not os.environ.get("BFG_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR by
# itself; when it is unset (and the caller chose no directory before
# importing the package) the cache lives at a fixed path in the checkout,
# so repeated processes and runs hit it.
if jax.config.jax_compilation_cache_dir is None:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))

from . import cosmo
from . import ops
from . import utils
from . import Profiles
from . import Runners
from . import parallel
from .utils.io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                       GriddedMap, ParticleSnapshot)
# star-exported public surface, mirroring the reference package root
# (BaryonForge/__init__.py:1-5)
from .Profiles import *       # noqa: F401,F403
from .Runners import *        # noqa: F401,F403

__version__ = "0.1.0"

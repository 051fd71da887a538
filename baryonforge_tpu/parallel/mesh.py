"""Mesh construction + reference-compatible parallel front-ends."""

import copy
import numpy as np
import jax

__all__ = ["halo_mesh", "SimpleParallel", "SplitJoinParallel"]


def halo_mesh(n_devices=None):
    """1D device mesh with a 'halos' axis (data-parallel over halo batches).

    Per-device partial maps are psum-reduced over the mesh. The mesh is
    flat: it assumes every device reaches every other one directly, as
    NVLink joins the GPUs of one host, and follows no torus.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.sharding.Mesh(np.array(devs), ("halos",))


class SimpleParallel:
    """Run a list of independent Runners concurrently and return their
    outputs in order (reference Parallelize.py:58-113).

    The reference farms runners to loky processes; here each runner is
    dispatched from its own thread with a round-robin ``jax.default_device``
    so independent shells occupy different devices of a multi-chip host
    (and, single-chip, host prep / H2D / compute / D2H overlap across
    runners — jax releases the GIL during device execution).

    ``njobs``: -1/None = one worker per local device (capped at the number
    of runners); 1 = sequential; N = thread count.
    """

    def __init__(self, Runner_list, njobs=-1, verbose=True):
        self.Runner_list = list(Runner_list)
        self.njobs = njobs
        self.verbose = verbose

    def process(self):
        n = len(self.Runner_list)
        devs = jax.local_devices()
        workers = (min(n, max(1, len(devs)))
                   if self.njobs in (-1, None) else max(1, int(self.njobs)))
        if workers <= 1 or n <= 1:
            return [r.process() for r in self.Runner_list]

        from concurrent.futures import ThreadPoolExecutor

        def run_one(i):
            runner = self.Runner_list[i]
            with jax.default_device(devs[i % len(devs)]):
                return runner.process()

        with ThreadPoolExecutor(max_workers=workers) as ex:
            futures = [ex.submit(run_one, i) for i in range(n)]
            return [f.result() for f in futures]


class SplitJoinParallel:
    """Split one Paint-type runner's halo catalog across the device mesh and
    sum the partial maps (reference Parallelize.py:116-320).

    This is exactly the runner's own ``mesh`` mode — this class wraps
    it for API parity: it attaches a mesh to a copy of the runner. Only
    linear-sum (Paint) runners are splittable, as in the reference
    (Parallelize.py:206-209); Baryonify runners accept a mesh natively since
    the offset accumulation is also a linear sum.
    """

    def __init__(self, Runner, njobs=-1, seed=42, verbose=True, mesh=None):
        self.Runner = Runner
        self.mesh = mesh if mesh is not None else halo_mesh(
            None if njobs in (-1, None) else njobs)
        self.seed = seed
        self.verbose = verbose

    def process(self):
        runner = copy.copy(self.Runner)
        runner.mesh = self.mesh
        return runner.process()

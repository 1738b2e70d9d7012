"""Device-mesh parallelism: chains, replicas, and spatial lattice sharding.

The reference has no distributed backend at all (SURVEY.md §5.8 — "parallel"
chains are sequential Python loops, tsu/gibbs.py:450-487). Here parallelism is
first-class:

* ``chains`` axis — independent chains/particles (the DP analog).
* ``replica`` axis — parallel-tempering temperature ladder.
* ``row`` axis — spatial decomposition of large lattices with halo exchange
  via ``ppermute`` (the TP/SP analog; same neighbor-shift pattern as ring
  attention).

Collectives are compiled by XLA, which hands them to NCCL on GPUs; there is
no hand-written transport.
"""

from tsu_tpu.parallel.mesh import make_mesh, mesh_info, plan_lattice_mesh
from tsu_tpu.parallel.lattice import sharded_checkerboard_sweeps, sharded_lattice_sample
from tsu_tpu.parallel.smc_sharded import annealed_smc_sharded

__all__ = [
    "annealed_smc_sharded",
    "make_mesh",
    "mesh_info",
    "plan_lattice_mesh",
    "sharded_checkerboard_sweeps",
    "sharded_lattice_sample",
]

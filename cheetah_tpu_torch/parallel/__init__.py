"""Multi-device execution of the port (counterpart of ``cheetah_tpu/parallel``).

Explicit SPMD on ``torch.distributed``, one process per rank: meshes
(:func:`make_mesh`, :func:`make_hybrid_mesh`), the local blocks of sharded
beams and lattices (:func:`shard_beam`, :func:`shard_segment`), the
collectives (:mod:`cheetah_tpu_torch.parallel.collectives`, on which
``SpaceChargeKick(particle_axis=...)`` sums its grid), the vectorised
tuning env (:class:`BatchedLatticeEnv`) and the communication audit
(:func:`collective_report`). Importing it needs no process group.
"""

from cheetah_tpu_torch.parallel.collectives import active_mesh
from cheetah_tpu_torch.parallel.comm_audit import (
    CollectiveReport,
    collective_report,
    parse_collectives,
)
from cheetah_tpu_torch.parallel.distributed import (
    initialize,
    make_hybrid_mesh,
    make_process_local_array,
    process_local_beam,
)
from cheetah_tpu_torch.parallel.env import BatchedLatticeEnv
from cheetah_tpu_torch.parallel.sharding import (
    beam_shardings,
    make_mesh,
    replicate,
    shard_beam,
    shard_segment,
)

__all__ = [
    "BatchedLatticeEnv",
    "CollectiveReport",
    "active_mesh",
    "beam_shardings",
    "collective_report",
    "parse_collectives",
    "initialize",
    "make_hybrid_mesh",
    "make_mesh",
    "make_process_local_array",
    "process_local_beam",
    "replicate",
    "shard_beam",
    "shard_segment",
]

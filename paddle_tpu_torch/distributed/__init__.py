"""``paddle.distributed`` of the port, for one process so far.

Counterpart of ``paddle_tpu/distributed/``: the mesh (``ProcessMesh``,
``set_mesh``, ``get_mesh``, ``auto_mesh``), ``parallelize`` and, under
``fleet.sequence_parallel``, ring context parallelism. A mesh holds the
virtual ranks of one process on one device; process groups, collectives
and the other strategies wait for the distributed slice of the port.
"""

from . import fleet  # noqa: F401
from .mesh import ProcessMesh, auto_mesh, get_mesh, set_mesh
from .parallelize import parallelize

__all__ = ["ProcessMesh", "auto_mesh", "get_mesh", "set_mesh", "parallelize", "fleet"]

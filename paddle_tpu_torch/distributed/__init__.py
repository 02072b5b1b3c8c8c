"""``paddle.distributed`` of the port, for one process so far.

Counterpart of ``paddle_tpu/distributed/``: the mesh (``ProcessMesh``,
``set_mesh``, ``get_mesh``, ``auto_mesh``), ``parallelize``, activation
recompute (``recompute``, ``recompute_sequential``; the module
``distributed/recompute.py`` also holds the policies), and under ``fleet`` the ring's context
parallelism (``fleet.sequence_parallel``) and the Mixture-of-Experts layer
(``fleet.moe``, its experts on this device). A mesh holds the virtual
ranks of one process on one device; process groups, collectives, expert
parallelism across devices and the other strategies wait for the
distributed slice of the port.
"""

from . import fleet  # noqa: F401
from .mesh import ProcessMesh, auto_mesh, get_mesh, set_mesh
from .parallelize import parallelize
from .recompute import recompute, recompute_sequential

__all__ = ["ProcessMesh", "auto_mesh", "get_mesh", "set_mesh", "parallelize", "fleet",
           "recompute", "recompute_sequential"]

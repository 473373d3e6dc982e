"""The (data, server) mesh over ``torch.distributed``: one process a
mesh position (``mesh.py``), the rendezvous and control-plane store
(``distributed.py``), the declared layouts (``partition.py``), the
launcher of local worlds (``launch.py``), one order of the
submissions of a process's threads that every rank shares
(``turns.py``), and the placements of a tree's leaves over the mesh
(``placement.py``)."""

from .mesh import DATA_AXIS, SERVER_AXIS  # noqa: F401

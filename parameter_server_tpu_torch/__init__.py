"""PyTorch/CUDA port of ``parameter_server_tpu``.

The package mirrors the JAX package's layout and names so each module
has an obvious counterpart. It imports ``torch`` and numpy only: nothing
of JAX and nothing of the JAX package. Entry points run on the CUDA
device unless the caller asks for the CPU (see :func:`device.resolve`).

Quick start, on the CPU::

    import parameter_server_tpu_torch as pst

    po = pst.Postoffice.instance().start(device="cpu")
    w = pst.KVVector(name="w", num_slots=1024, k=1, device="cpu")
    ...

The ``ps`` module is the ps.h-style interface for writing role-dispatched
programs (``ps.run_system``); ``apps.linear.main`` is the conf-driven
CLI. Importing the package builds no kernel: each CUDA kernel is built
at its first launch.
"""

from . import ps
from .parameter.kv_layer import KVLayer
from .parameter.kv_map import KVMap
from .parameter.kv_store import kv_store
from .parameter.kv_vector import KVVector
from .system.customer import App, Customer
from .system.executor import NodeGroups
from .system.message import Message, Task
from .system.postoffice import Postoffice
from .utils.range import Range

__version__ = "0.1.0"

__all__ = [
    "App",
    "Customer",
    "KVLayer",
    "KVMap",
    "KVVector",
    "kv_store",
    "Message",
    "NodeGroups",
    "Postoffice",
    "Range",
    "Task",
    "ps",
    "__version__",
]

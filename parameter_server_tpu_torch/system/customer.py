"""Customer and App: the base of the port's applications.

Counterpart of ``Customer`` and ``App`` in
``parameter_server_tpu/system/customer.py`` (the reference's
``src/system/customer.h``), only as large as the block coordinate
descent scheduler needs: a name and an :class:`Executor` (timestamps and
dependency tracking). The postoffice registration, the per-peer remote
nodes, ``submit``/``wait``/``reply`` and the app registry belong to the
system layer, which is not ported yet (ROADMAP A13).
"""

from __future__ import annotations

from typing import Any

from .executor import Executor


class Customer:
    def __init__(self, name: str = ""):
        self.name = name or "customer"
        self.executor = Executor(name=self.name)


class App(Customer):
    """Base application: ``run`` is executed by the main thread after
    construction."""

    def run(self) -> None:
        pass

    @staticmethod
    def create(conf: Any) -> "App":
        raise NotImplementedError(
            "App.create (the app registry) needs the system layer, which is not "
            "ported to the PyTorch package yet (ROADMAP A13)"
        )

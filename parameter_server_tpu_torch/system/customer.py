"""Customer and App: the base of every shared object (apps, parameters).

Counterpart of ``parameter_server_tpu/system/customer.py`` (the
reference's ``src/system/customer.h``). A customer owns an
:class:`Executor` (timestamps and dependency tracking) and registers
with the postoffice's manager under a unique id, like the reference's
``Customer(id)`` + ``Postoffice::instance().manager().AddCustomer(this)``.
``submit``/``wait``/``reply`` are the reference's communication calls;
a reply crosses the postoffice's van (framed and decoded) when the
postoffice is started, and goes straight to the peer otherwise.

Not here: the per-peer filter chains (the JAX package's
``RemoteNodeTable``) a reply is encoded by on its way (ROADMAP A13), and
the app registry behind ``App.create`` (A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .executor import Executor
from .message import Message, Task


class Customer:
    def __init__(self, id: Optional[int] = None, name: str = ""):
        from .postoffice import Postoffice

        self.po = Postoffice.instance()
        self.id = self.po.manager.next_customer_id() if id is None else id
        self.name = name or f"customer_{self.id}"
        self.executor = Executor(name=self.name)
        self._last_response: Optional[Message] = None
        self.po.manager.add_customer(self)

    # -- communication (ref customer.h Submit/Wait/Reply) --

    def submit(self, step: Callable[[], Any], task: Optional[Task] = None,
               callback: Optional[Callable[[], None]] = None) -> int:
        return self.executor.submit(step, task, callback)

    def wait(self, timestamp: int) -> Any:
        return self.executor.wait(timestamp)

    def reply(self, request: Message, response: Optional[Message] = None) -> None:
        """Mark a request processed and deliver the response to its
        sender (host side: the paired customer's ``process_response``)."""
        if response is None:
            response = Message()
        response.task.request = False
        response.task.time = request.task.time
        response.sender, response.recver = request.recver, request.sender
        request.replied = True  # ref executor.cc: the system acks once per request
        self.executor.tracker.finish(request.task.time)
        target = self.po.manager.find_customer_by_name(request.sender)
        if target is not None:
            if self.po.van is not None:
                # a copy crosses the wire; the caller keeps its response
                wire_msg = dataclasses.replace(response, task=response.task.fresh_copy(),
                                               values=list(response.values), callback=None)
                response = self.po.van.transfer(wire_msg)
            target._last_response = response  # ref customer.h LastResponse()
            target.process_response(response)
        if request.callback is not None:
            request.callback()

    def last_response(self) -> Optional[Message]:
        """The most recent response delivered to me (ref customer.h
        LastResponse, valid inside a response callback)."""
        return self._last_response

    # -- user hooks (ref ProcessRequest/ProcessResponse) --

    def process_request(self, request: Message) -> None:
        pass

    def process_response(self, response: Message) -> None:
        pass

    def remove(self) -> None:
        self.po.manager.remove_customer(self.id)


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

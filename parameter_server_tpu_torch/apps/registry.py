"""The app factory (the reference's ``App::Create`` dispatch in
``src/app/linear_method/main.cc``).

Counterpart of ``parameter_server_tpu/apps/registry.py``: the app is
picked by which sections the conf has, darlin first, then async_sgd,
then validation alone (model evaluation). ``device`` goes to the apps
that hold tensors (the darlin scheduler, model evaluation); the async
SGD scheduler holds none.
"""

from __future__ import annotations

from ..system.customer import App
from .linear.config import Config


def create_app(conf: Config, device=None) -> App:
    if conf.darlin is not None:
        from .linear.darlin import DarlinScheduler

        return DarlinScheduler(conf, device=device)
    if conf.async_sgd is not None:
        from .linear.async_sgd import AsyncSGDScheduler

        return AsyncSGDScheduler(conf)
    if conf.validation_data is not None:
        from .linear.model_evaluation import ModelEvaluation

        return ModelEvaluation(conf, device=device)
    raise ValueError("config selects no app (need darlin/async_sgd/validation_data)")

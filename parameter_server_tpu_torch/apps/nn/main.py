"""NN-through-KVLayer CLI on one device:

    python -m parameter_server_tpu_torch.apps.nn.main \\
        [--model mlp|convnet] [--steps N] [--batch B] [--num-servers S] \\
        [--num-workers D] [--device cpu]

Counterpart of ``parameter_server_tpu/apps/nn/main.py``: the same flags
and the same synthetic data from ``np.random.default_rng(0)`` (blobs for
the MLP, noisy class-centre images for the conv net), the same progress
rows. ``--device`` names the torch device (default: the CUDA device;
without one the run raises). ``--num-servers S`` (and ``--num-workers
D``, data rows, default one) start a world of ``D * S`` ranks
(``parallel/launch.py``), each running this CLI inside it on a
``D x S`` mesh: the ``KVLayer`` places the layers over the ``S`` server
ranks, each data row trains on its slice of every batch, and rank 0
prints the rows. Inside a launcher's world the mesh takes ``world / S``
data rows.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=("mlp", "convnet"), default="mlp")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--num-workers", type=int, default=0,
                    help="data rows of the mesh (0: over the launcher's world, else one)")
    ap.add_argument("--report-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ...models.convnet import ConvNet, MLP
    from ...system.postoffice import Postoffice
    from .trainer import NNTrainer

    world = max(1, args.num_workers) * args.num_servers
    if not os.environ.get("PS_COORDINATOR_ADDRESS") and world > 1:
        return _spawn(argv if argv is not None else sys.argv[1:], world, args.device)
    po = Postoffice.instance().start(num_data=args.num_workers or None,
                                     num_server=args.num_servers, device=args.device)
    rank0 = po.mesh.rank == 0

    rng = np.random.default_rng(0)
    if args.model == "convnet":
        model = ConvNet(num_classes=args.classes)
        input_shape = (16, 16, 3)
    else:
        model = MLP(num_classes=args.classes)
        input_shape = (32,)
    centers = rng.normal(size=(args.classes,) + input_shape).astype(np.float32)

    def batch():
        y = rng.integers(0, args.classes, args.batch).astype(np.int32)
        x = centers[y] + 0.5 * rng.normal(size=(args.batch,) + input_shape)
        return x.astype(np.float32), y

    trainer = NNTrainer(model, input_shape=input_shape, device=po.device, mesh=po.mesh)
    if rank0:
        print(f"{'step':>5} {'loss':>9} {'accuracy':>9}")
    for step in range(1, args.steps + 1):
        x, y = batch()
        m = trainer.train_step(x, y)
        if rank0 and (step % args.report_every == 0 or step == args.steps):
            print(f"{step:>5} {m['loss']:>9.5f} {m['accuracy']:>9.4f}", flush=True)
    trainer.kv.executor.stop()
    if po.mesh.size > 1:
        po.stop()
    return 0


def _spawn(argv, world: int, device) -> int:
    """Start the world's ranks on the card (or ``--device``'s type), each
    running this CLI inside it; the worst rank's exit code."""
    import torch

    from ...device import resolve
    from ...parallel import distributed, launch

    device_type = resolve(device).type  # the card unless --device names another
    backend = distributed.choose_backend(world, torch.device(device_type))
    print(f"starting {world} ranks on {device_type} over {backend}", flush=True)
    from . import main as cli  # by its import name: a rank cannot import a `-m` run's __main__

    # each rank runs this CLI again, inside the world
    codes = launch.run_world(cli.main, world, args=(argv,), timeout=None,
                             device_type=device_type, threads=0, quiet=True)
    return max(int(c or 0) for c in codes)


if __name__ == "__main__":
    sys.exit(main())

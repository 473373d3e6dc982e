"""NN-through-KVLayer CLI on one device:

    python -m parameter_server_tpu_torch.apps.nn.main \\
        [--model mlp|convnet] [--steps N] [--batch B] [--num-servers S] [--device cpu]

Counterpart of ``parameter_server_tpu/apps/nn/main.py``: the same flags
and the same synthetic data from ``np.random.default_rng(0)`` (blobs for
the MLP, noisy class-centre images for the conv net), the same progress
rows. ``--device`` names the torch device (default: the CUDA device;
without one the run raises); ``--num-servers`` above 1 (a ``KVLayer``
over several server shards) raises naming ROADMAP A9 slice 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=("mlp", "convnet"), default="mlp")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--report-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ...models.convnet import ConvNet, MLP
    from ...system.postoffice import Postoffice
    from .trainer import NNTrainer

    if args.num_servers != 1:
        raise NotImplementedError(
            f"--num-servers {args.num_servers}: a KVLayer over several server shards is ROADMAP "
            "A9 slice 2")
    po = Postoffice.instance().start(num_server=args.num_servers, device=args.device)

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

    trainer = NNTrainer(model, input_shape=input_shape, device=po.device)
    print(f"{'step':>5} {'loss':>9} {'accuracy':>9}")
    for step in range(1, args.steps + 1):
        x, y = batch()
        m = trainer.train_step(x, y)
        if step % args.report_every == 0 or step == args.steps:
            print(f"{step:>5} {m['loss']:>9.5f} {m['accuracy']:>9.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

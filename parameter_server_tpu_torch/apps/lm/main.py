"""Byte-level LM CLI: train the transformer on a text file (or a built-in
synthetic corpus), then generate from it:

    python -m parameter_server_tpu_torch.apps.lm.main \\
        [--data FILE] [--steps N] [--seq-len S] [--batch B] \\
        [--attention ring|ring_flash|ring_zigzag|a2a] [--window W] [--remat] [--bf16] \\
        [--moe-every K] [--optimizer adam|adafactor|lion] \\
        [--num-servers S] [--zero1] [--fsdp] [--ckpt-dir DIR] [--save-every N] [--resume] \\
        [--prompt "text"] [--gen-tokens N] [--temperature T] [--top-k K] \\
        [--top-p P] [--beam W] [--n-kv-heads G] [--device cpu]

Counterpart of ``parameter_server_tpu/apps/lm/main.py`` (the CUDA
device unless ``--device`` names another): the same flags,
defaults, validation and error texts, the same corpus and batches for a
seed, the same report lines, ``--log-file`` JSON lines and held-out
``--eval-every`` losses. Tokens are raw bytes (vocab 256). The optimizer
chain is :mod:`.optim`'s copy of the JAX CLI's optax chain; generation
is the port's ``lm_generate``, or ``lm_beam_search`` under ``--beam``.

``--ckpt-dir`` saves ``{"params", "opt"}`` through
:class:`..parameter.replica.CheckpointManager` at every ``--save-every``
step and always at the last, each write on a thread while training goes
on; ``--resume`` restores the latest step, prints ``resumed from step N``
and trains the remaining steps, the schedule and accumulation counters
going on from the optimizer state. As in the JAX CLI, a resumed run's
batch stream starts over from the seed.

**Inside a world.** Run by every rank of a world a launcher started
(``PS_COORDINATOR_ADDRESS``, ``PS_NUM_PROCESSES``, ``PS_PROCESS_ID`` and
``PS_DEVICE`` on every rank, e.g. ``parallel/launch.run_world(main, N,
args=(argv,))``), the CLI trains on a ``data x server`` mesh of ``(world
/ S) x S`` ranks (``--num-servers S``, which must divide the world), as
the JAX CLI on its mesh over every device: every rank samples the same
global batch and keeps its shard of the sequence over ``data``
(``models/transformer.shard_tokens``; ``--seq-len`` must divide by the
data axis, by twice it under ``ring_zigzag``), attention runs as the
schedule ``--attention`` names across the data ranks (``a2a`` needs
``--n-heads`` divisible by the data axis), MoE layers shard their
experts over them, and the optimizer steps on the gradients summed over
them (so ``--clip-norm`` sees the global norm). Held-out batches are
sharded alike.

The parameters and optimizer state are placed in the JAX CLI's order:
Megatron tensor parallelism over ``server`` when S > 1
(``shard_lm_params``), FSDP over ``data`` under ``--fsdp``
(``fsdp_shard_lm_params``), the optimizer's state from the placed
parameters, then ZeRO-1 over ``data`` under ``--zero1``
(``zero1_shard_opt_state``). Checkpoints hold whole leaves (every rank
gathers, rank 0 writes), so a run resumes under any placement, the JAX
CLI's too. Rank 0 alone prints, logs and profiles; every rank restores
a ``--resume``; generation runs on the server row of data row 0, every
rank of which decodes alike (the FSDP leaves first gathered over
``data`` by every rank).

``--profile DIR`` runs the training loop under a ``torch.profiler``
capture (``utils/profiling.device_trace``), a Chrome trace written under
DIR. The training step is an entry point of the device inventory
(``telemetry/device.py``, ``lm_train_step``), declaring its least FLOP
and bytes for the roofline gauges.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import optim


def _load_corpus(path: "str | None", rng: np.random.Generator) -> np.ndarray:
    """The training byte stream. Synthetic fallback: a periodic pattern
    with noise — learnable only by attending a full period back."""
    if path:
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        if data.size < 1 << 12:
            print(f"warning: tiny corpus ({data.size} bytes)", file=sys.stderr)
        return data
    base = rng.integers(0, 256, 64, dtype=np.uint8)
    reps = np.tile(base, 4096)
    noise = rng.integers(0, 256, reps.size, dtype=np.uint8)
    return np.where(rng.random(reps.size) < 0.02, noise, reps)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default=None, help="text/bytes file (default: synthetic)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-kv-heads", type=int, default=None,
                    help="grouped-query attention: K/V heads (default: n-heads)")
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--attention", default="ring_flash",
                    choices=("ring", "ring_flash", "ring_zigzag", "a2a"),
                    help="attention schedule across the ranks of a world")
    ap.add_argument("--window", type=int, default=None, help="sliding-window span (flash modes)")
    ap.add_argument("--rope", action="store_true", help="rotary position embeddings")
    ap.add_argument("--rope-theta", type=float, default=10000.0)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize layers (torch.utils.checkpoint)")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 decoder activations")
    ap.add_argument("--moe-every", type=int, default=0,
                    help="every K-th layer's FFN is a mixture of 8 switch-routed experts")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--kv-cache", choices=("auto", "int8"), default="auto",
                    help="decode KV-cache storage (generation only)")
    ap.add_argument("--log-file", metavar="PATH", default=None,
                    help="append one JSON line per report interval")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the training loop into DIR")
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--optimizer", choices=("adam", "adafactor", "lion"), default="adam",
                    help="adam, adafactor (factored second moment) or lion (sign momentum)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear LR warmup steps, then cosine decay to 10%% of --lr by "
                    "--steps (0 = constant LR)")
    ap.add_argument("--clip-norm", type=float, default=None, help="global-norm gradient clipping")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="average N microbatch gradients per optimizer step")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate held-out loss every N steps")
    ap.add_argument("--eval-frac", type=float, default=0.1,
                    help="fraction of the corpus tail held out for --eval-every")
    ap.add_argument("--steps-per-launch", type=int, default=1,
                    help="run N optimizer steps a launch; must divide --steps and --save-every")
    ap.add_argument("--report-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (enables save/resume)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every N steps (needs --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--prompt", default=None, help="generate after training from this text")
    ap.add_argument("--gen-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling (needs --temperature > 0)")
    ap.add_argument("--beam", type=int, default=0, metavar="W",
                    help="beam search with W beams instead of greedy/sampled decoding")
    ap.add_argument("--eos-byte", type=int, default=None, metavar="B",
                    help="stop-token byte: a generation that emits byte B freezes")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA device)")
    return ap


def train_step_cost(params, opt_state, tokens, *targets_and_weights) -> dict:
    """The least work of one training step, for the device inventory's
    roofline gauges: 6 FLOP a token for every weight of a dense matrix
    product (forward, then the two products of the backward), counting
    the layers' 2-D weights and the tied embedding as the output
    projection (expert stacks and routers left out: a token meets one
    expert); every parameter and token read once."""
    n_tok = tokens.numel()
    n_mat = 0
    n_bytes = tokens.numel() * tokens.element_size()
    for key, leaf in params.items():
        leaves = leaf.items() if isinstance(leaf, dict) else [(key, leaf)]
        for name, t in leaves:
            n_bytes += t.numel() * t.element_size()
            if t.dim() == 2 and "router" not in name:
                n_mat += t.numel()
    return {"flops": 6.0 * n_mat * n_tok, "bytes_accessed": float(n_bytes)}


def _validate(ap, args, n: int) -> None:
    """The JAX CLI's flag checks that do not need the corpus, in its
    order; ``n``: the ranks of the data axis."""
    zig = args.attention == "ring_zigzag"
    if args.seq_len % (2 * n if zig else n):
        ap.error(f"--seq-len must divide by {2 * n if zig else n}")
    if args.attention == "a2a" and args.n_heads % n:
        ap.error(f"--attention a2a needs --n-heads divisible by the {n}-device data axis "
                 f"(got {args.n_heads})")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    if args.top_k is not None:
        if args.temperature == 0:
            ap.error("--top-k requires --temperature > 0 (sampling)")
        if not 1 <= args.top_k <= 256:
            ap.error(f"--top-k must be in [1, 256], got {args.top_k}")
    if args.top_p is not None:
        if args.temperature == 0:
            ap.error("--top-p requires --temperature > 0 (sampling)")
        if not 0.0 < args.top_p <= 1.0:
            ap.error(f"--top-p must be in (0, 1], got {args.top_p}")
    spl = args.steps_per_launch
    if spl < 1:
        ap.error(f"--steps-per-launch must be >= 1, got {spl}")
    if spl > 1 and args.steps % spl:
        ap.error(f"--steps-per-launch {spl} must divide --steps {args.steps}")
    if spl > 1 and args.save_every and args.save_every % spl:
        ap.error(f"--steps-per-launch {spl} must divide --save-every {args.save_every} "
                 "(checkpoints land on launch boundaries)")


def config(args):
    """The ``LMConfig`` of the parsed flags (raises ``ValueError`` for an
    invalid combination)."""
    from ...models.transformer import LMConfig

    return LMConfig(
        vocab=256, d_model=args.d_model, n_heads=args.n_heads, n_layers=args.n_layers,
        d_ff=args.d_ff, attention=args.attention, window=args.window, remat=args.remat,
        compute_dtype="bfloat16" if args.bf16 else "float32", moe_every=args.moe_every,
        n_kv_heads=args.n_kv_heads, rope=args.rope, rope_theta=args.rope_theta,
        kv_cache_dtype=None if args.kv_cache == "auto" else args.kv_cache,
    )


def place(args, params, tx, mesh):
    """The parameters and the optimizer's state placed as the JAX CLI
    places them, in its order: Megatron over ``server`` (``--num-servers``
    > 1), FSDP over ``data`` (``--fsdp``), ``tx.init`` of the placed
    parameters, ZeRO-1 over ``data`` (``--zero1``). Without a placement
    the whole trees, as on one card."""
    from ...models.transformer import (fsdp_shard_lm_params, shard_lm_params,
                                       zero1_shard_opt_state)

    if args.num_servers > 1:
        params = shard_lm_params(params, mesh, "server")
    if args.fsdp:
        params = fsdp_shard_lm_params(params, mesh, "data")
    opt = tx.init(params)
    if args.zero1:
        opt = zero1_shard_opt_state(opt, mesh, "data")
    return params, opt


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)

    from ...device import resolve
    from ...models.transformer import (init_lm, lm_beam_search, lm_generate, lm_loss,
                                       lm_loss_with_targets, shard_tokens, value_and_grad,
                                       zigzag_lm_arrays)
    from ...parallel import distributed, placement
    from ...parallel import mesh as meshlib
    from ...parameter.replica import CheckpointManager
    from ...telemetry import device as device_tel
    from ...utils.profiling import device_trace

    # inside a launcher's world every rank runs this CLI on a data x server
    # mesh of its ranks
    in_world = distributed.initialize()
    n_dev = torch.distributed.get_world_size() if in_world else 1
    if args.num_servers < 1 or n_dev % args.num_servers:
        ap.error(f"--num-servers {args.num_servers} must divide the device count ({n_dev})")
    n = n_dev // args.num_servers  # the data axis

    try:
        cfg = config(args)
    except ValueError as e:
        # LMConfig rejects invalid combinations (e.g. --window with
        # --attention ring); surface them as flag errors, not tracebacks
        ap.error(str(e))
    _validate(ap, args, n)
    spl = args.steps_per_launch
    zig = args.attention == "ring_zigzag"

    rng = np.random.default_rng(args.seed)
    corpus = _load_corpus(args.data, rng)
    if corpus.size <= args.seq_len + 1:
        ap.error(f"corpus has {corpus.size} bytes but --seq-len {args.seq_len} "
                 "needs at least seq_len+2")
    if args.grad_accum < 1:
        ap.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    if args.grad_accum > args.steps:
        ap.error(f"--grad-accum {args.grad_accum} exceeds --steps {args.steps}: no "
                 "accumulation window would ever complete, so the model would never update")
    if args.steps % args.grad_accum:
        ap.error(f"--grad-accum {args.grad_accum} must divide --steps {args.steps}: a trailing "
                 "partial window would compute gradients that never reach the optimizer")
    if args.clip_norm is not None and args.clip_norm <= 0:
        ap.error(f"--clip-norm must be > 0, got {args.clip_norm}")
    if args.warmup and args.warmup >= args.steps:
        ap.error(f"--warmup {args.warmup} must be < --steps {args.steps}")
    if args.eval_every < 0:
        ap.error(f"--eval-every must be >= 0, got {args.eval_every}")
    eval_corpus = None
    if args.eval_every:
        if not 0.0 < args.eval_frac < 1.0:
            ap.error(f"--eval-frac must be in (0, 1), got {args.eval_frac}")
        split = int(corpus.size * (1.0 - args.eval_frac))
        corpus, eval_corpus = corpus[:split], corpus[split:]
        if min(corpus.size, eval_corpus.size) <= args.seq_len + 1:
            ap.error(f"--eval-frac {args.eval_frac} leaves a split too small for --seq-len "
                     f"{args.seq_len} (train {corpus.size} / eval {eval_corpus.size} bytes)")

    device = distributed.rank_device() if in_world and args.device is None else resolve(
        args.device)
    mesh = meshlib.make_mesh(num_data=n, num_server=args.num_servers, device=device)
    lead = mesh.rank == 0  # rank 0 alone prints, logs, profiles and writes the checkpoints
    say = print if lead else (lambda *a, **k: None)
    tx = optim.build(args.lr, args.steps, args.warmup, args.clip_norm, args.grad_accum,
                     args.optimizer)
    params, opt = place(args, init_lm(args.seed, cfg, device), tx, mesh)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume:
            latest = mgr.latest_step()
            if latest is not None:
                # the schedule and accumulation counters are in opt; the
                # leaves are whole, each rank keeps its blocks
                tree = mgr.restore(latest, like={"params": placement.template(params),
                                                 "opt": placement.template(opt)})
                params = placement.place_like(tree["params"], params)
                opt = placement.place_like(tree["opt"], opt)
                start_step = latest
                say(f"resumed from step {latest}", flush=True)
    elif args.save_every or args.resume:
        ap.error("--save-every/--resume need --ckpt-dir")

    def sample_tokens():
        starts = rng.integers(0, corpus.size - args.seq_len - 1, args.batch)
        return np.stack([corpus[s:s + args.seq_len] for s in starts]).astype(np.int32)

    if spl > 1 and (args.steps - start_step) % spl:
        ap.error(f"resumed at step {start_step}: the remaining {args.steps - start_step} steps "
                 f"must divide by --steps-per-launch {spl}")

    def shards(tokens):
        """This rank's shards of a global batch: its tokens, and under
        the zigzag layout the targets and weights carried along."""
        arrays = zigzag_lm_arrays(tokens, n) if zig else (tokens,)
        return tuple(shard_tokens(a, mesh) for a in arrays)

    def loss_of(p, *data):
        if zig:
            return lm_loss_with_targets(p, *data, cfg, mesh=mesh)
        return lm_loss(p, *data, cfg, mesh=mesh)

    def one(p, opt_state, *data):
        """One optimizer step: loss and the gradients summed over the
        ranks, then the chain."""
        loss, grads = value_and_grad(lambda leaves: loss_of(leaves, *data), p, mesh=mesh)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, p)
            return optim.apply_updates(p, updates), opt_state, loss

    one = device_tel.instrument("lm_train_step", one, cost=train_step_cost)

    eval_fn = None
    if args.eval_every:
        # fixed held-out batches (never trained on), scored with the same
        # loss the training step uses
        erng = np.random.default_rng(args.seed + 7)
        fixed_eval = []
        for _ in range(4):
            starts = erng.integers(0, eval_corpus.size - args.seq_len - 1, args.batch)
            fixed_eval.append(shards(np.stack(
                [eval_corpus[s:s + args.seq_len] for s in starts]).astype(np.int32)))

        def eval_fn(p):
            with torch.no_grad():
                return float(np.mean([float(loss_of(p, *data)) for data in fixed_eval]))

    say(f"devices={n_dev} (data={n} x server={args.num_servers}) attention={cfg.attention} "
        f"corpus={corpus.size} bytes"
        + (f" (+{eval_corpus.size} held out)" if eval_corpus is not None else "")
        + f" on {device}")
    say(f"{'step':>5} {'loss':>9} {'bits/byte':>10}")
    log_f = open(args.log_file, "a") if args.log_file and lead else None
    t_start = time.perf_counter()
    last_t, last_i = t_start, start_step
    loop_raised = False
    with device_trace(args.profile if lead else None):
        try:
            for i in range(start_step + spl, args.steps + 1, spl):
                # a launch: spl sequential steps, each on its own batch
                batches = [shards(sample_tokens()) for _ in range(spl)]
                for data in batches:
                    params, opt, loss = one(params, opt, *data)
                report = i % args.report_every < spl or i == args.steps
                ev = rec = None
                if report:
                    ll = float(loss)
                    say(f"{i:>5} {ll:>9.4f} {ll / np.log(2):>10.4f}", flush=True)
                    # the throughput window closes BEFORE any eval below, so
                    # held-out evaluation never pollutes tokens_per_sec
                    now = time.perf_counter()
                    rec = {"step": i, "wall_s": round(now - t_start, 2), "loss": round(ll, 6),
                           "bits_per_byte": round(ll / float(np.log(2)), 6),
                           "tokens_per_sec": round((i - last_i) * args.batch * args.seq_len
                                                   / max(now - last_t, 1e-9), 1)}
                    last_t, last_i = now, i
                if eval_fn is not None and (i % args.eval_every < spl or i == args.steps):
                    ev_t0 = time.perf_counter()
                    ev = eval_fn(params)
                    # shift the open window past the eval's wall time
                    last_t += time.perf_counter() - ev_t0
                    say(f" eval@{i:<4} {ev:>8.4f} {ev / np.log(2):>10.4f}", flush=True)
                # a line per report interval, plus one for any eval measured off
                # the report grid
                if log_f is not None and (rec is not None or ev is not None):
                    if rec is None:
                        rec = {"step": i, "wall_s": round(time.perf_counter() - t_start, 2)}
                    if ev is not None:
                        rec["eval_loss"] = round(float(ev), 6)
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                if mgr is not None and (i == args.steps
                                        or (args.save_every and i % args.save_every == 0)):
                    # the final step is always saved, so a later --resume finds
                    # it; every rank gathers the whole leaves (collectives, here
                    # on the training thread), rank 0 takes the host snapshot,
                    # and the write overlaps the next steps
                    whole = {"params": placement.gather(params), "opt": placement.gather(opt)}
                    if lead:
                        mgr.save_async(i, whole)
        except BaseException:
            # a flag, not sys.exc_info(): inside the drain's handler below that
            # reports the exception being handled, and would hide a failed
            # save on a clean run
            loop_raised = True
            raise
        finally:
            if log_f is not None:
                log_f.close()
            if lead and mgr is not None:
                # drain even when the loop raised: a completed save beats a
                # discarded one
                try:
                    mgr.wait()
                except RuntimeError as e:
                    # a failed save fails a clean run, and never masks the
                    # loop's own exception (or a Ctrl-C)
                    if not loop_raised:
                        raise
                    print(f"async checkpoint failure during shutdown: {e}", file=sys.stderr)

    if args.prompt is not None:
        # FSDP's leaves whole over data (every rank), Megatron's blocks kept:
        # the server row of data row 0 decodes, each of its ranks alike
        params = placement.gather_axis(params, "data")
    if args.prompt is not None and mesh.data_index == 0:
        prompt = np.frombuffer(args.prompt.encode("utf-8", "replace") or b"\n",
                               np.uint8).astype(np.int64)[None, :]
        if args.beam:
            beams, scores = lm_beam_search(params, prompt, cfg, steps=args.gen_tokens,
                                           beam_width=args.beam, eos_id=args.eos_byte, mesh=mesh)
            out = beams[0, 0].cpu().numpy()
            note = f"beam {args.beam}, logprob {float(scores[0, 0]):.2f}"
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            out = lm_generate(params, prompt, cfg, steps=args.gen_tokens,
                              temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                              eos_id=args.eos_byte, generator=gen, mesh=mesh)[0].cpu().numpy()
            note = "greedy" if not args.temperature else "sampled"
        if args.eos_byte is not None:
            # "eos then pads": truncate at the first stop byte inside the
            # GENERATED region so the terminal never sees the pads
            gen_start = prompt.shape[1]
            hits = np.flatnonzero(out[gen_start:] == args.eos_byte)
            if hits.size:
                out = out[:gen_start + hits[0] + 1]
        text = bytes(out.astype(np.uint8)).decode("utf-8", "replace")
        say(f"--- generation ({args.gen_tokens} tokens, {note}) ---")
        say(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

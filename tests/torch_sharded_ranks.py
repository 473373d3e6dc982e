"""Rank functions of the port's tests of the LM's parameters and optimizer
state placed across ranks: Megatron tensor parallelism over ``server``,
ZeRO-1 and FSDP over ``data``. Each runs in every process of a gloo world
of CPU ranks that ``parallel.launch.run_world`` starts and returns plain
numpy results for the test process to hold against the JAX package.
Imports the port only (no JAX: the ranks never load it).

Inputs arrive whole; each rank cuts its own blocks
(``parallel/placement.block``), as ``shard_map`` hands each device its
block. A mesh of fewer ranks than the world leaves the others idle: they
make the mesh with the rest (its groups are made by every rank) and skip
its cases.
"""

import contextlib
import io

import numpy as np
import torch

from parameter_server_tpu_torch.apps.lm import optim
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.models.speculative import speculative_generate
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parallel import placement

DATA, SERVER = meshlib.DATA_AXIS, meshlib.SERVER_AXIS


def _mesh(d, s):
    return meshlib.make_mesh(num_data=d, num_server=s, device="cpu")


def _block(a, spec, m):
    return placement.block(torch.as_tensor(np.asarray(a)), tuple(spec), m)


def _np(tree):
    return {k if len(k) > 1 else k[0]: t.detach().numpy() for k, t in placement.leaves(tree)}


def _specs(tree):
    return {p: tuple(s) for p, s in getattr(tree, "specs", {}).items()}


# -- the collectives of tensor and data parallelism --

#: each shard_map case: (input spec, function, output spec) over a 4 x 2
#: mesh; the test runs the JAX primitive alike. A gather whose every rank
#: then uses the result on its own (an FSDP weight) stacks it on a new
#: leading dim split over the gathered axis, so that each rank's cotangent
#: is its own; ``all_gather_invariant``'s result is replicated over it
SHARDED = {
    "all_gather server dim 1": (("data", "server", None),
                                lambda x, m: meshlib.all_gather_dim(x, SERVER, m, 1)[None],
                                ("server", "data", None, None)),
    "all_gather data dim 0": (("data", "server", None),
                              lambda x, m: meshlib.all_gather_dim(x, DATA, m, 0)[None],
                              ("data", None, "server", None)),
    "all_gather server dim 2": (("data", None, "server"),
                                lambda x, m: meshlib.all_gather_dim(x, SERVER, m, -1)[None],
                                ("server", "data", None, None)),
    "all_gather_invariant server dim 1": (
        ("data", "server", None), lambda x, m: meshlib.all_gather_invariant(x, SERVER, m, 1),
        ("data", None, None)),
    "psum_scatter server dim 1": (("data", "server", None),
                                  lambda x, m: meshlib.psum_scatter(x, SERVER, m, 1),
                                  ("data", "server", None)),
    "psum_scatter data dim 2": (("data", "server", None),
                                lambda x, m: meshlib.psum_scatter(x, DATA, m, 2),
                                (None, "server", "data")),
}


def collectives_world(x, x2, w, v, cts):
    """On a 4 x 2 mesh: each :data:`SHARDED` case on this rank's block of
    ``x`` (its value, and the gradient for its block of ``cts[name]``);
    Megatron's column projection ``pvary(x2) @ w`` (``w`` split by
    columns over ``server``) and the gathered-heads chain
    ``psum_invariant(split(gather_invariant(pvary(x2) @ w) ** 2) @ v)``,
    their values and the gradients of ``x2`` and of the weights (the
    weights' summed over ``data``, as a step sums them)."""
    m = _mesh(4, 2)
    out = {}
    for name, (in_spec, fn, out_spec) in SHARDED.items():
        t = _block(x, in_spec, m).requires_grad_()
        y = fn(t, m)
        (g,) = torch.autograd.grad(y, t, _block(cts[name], out_spec, m))
        out[name] = (y.detach().numpy(), g.numpy())
    xb = _block(x2, ("data", None), m).requires_grad_()
    wb = _block(w, (None, "server"), m).requires_grad_()
    y = meshlib.pvary(xb, SERVER, m) @ wb
    gx, gw = torch.autograd.grad(y, (xb, wb), _block(cts["pvary"], ("data", "server"), m))
    out["pvary"] = (y.detach().numpy(), gx.numpy(), meshlib.psum(gw, DATA, m).numpy())
    xb = _block(x2, ("data", None), m).requires_grad_()
    wb = _block(w, (None, "server"), m).requires_grad_()
    vb = _block(v, ("server", None), m).requires_grad_()
    q = meshlib.all_gather_invariant(meshlib.pvary(xb, SERVER, m) @ wb, SERVER, m, -1)
    y = meshlib.psum_invariant(meshlib.split(q ** 2, SERVER, m, -1) @ vb, SERVER, m)
    gx, gw, gv = torch.autograd.grad(y, (xb, wb, vb), _block(cts["gathered"], ("data", None), m))
    out["gathered"] = (y.detach().numpy(), gx.numpy(), meshlib.psum(gw, DATA, m).numpy(),
                       meshlib.psum(gv, DATA, m).numpy())
    return out


# -- tensor parallelism in training and decoding --


def _tp_case(m, cfg, params, tokens):
    """Logits, loss and gradients of ``params`` placed by
    ``shard_lm_params`` on ``m``, on this rank's sequence shard."""
    tp = T.shard_lm_params(params, m)
    data = T.shard_tokens(tokens, m)
    with torch.no_grad():
        logits = T.lm_forward(tp, data, cfg, mesh=m).numpy()
    loss, grads = T.value_and_grad(lambda p: T.lm_loss(p, data, cfg, mesh=m), tp, mesh=m)
    return dict(logits=logits, loss=float(loss), grads=_np(placement.gather(grads)),
                local={k: g.numpy() for k, g in grads.items() if (k,) not in grads.specs},
                specs=_specs(tp), coords=m.coords)


def _train_case(m, cfg, params, steps, lr):
    """``make_lm_train_step`` on Megatron-placed parameters: each step's
    loss on a batch of repeated tokens (``np.random.default_rng(0)``), and
    whether ``l0/wq`` kept its placement."""
    p = T.shard_lm_params(params, m)
    step = T.make_lm_train_step(cfg, lr=lr, mesh=m)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        tok = np.repeat(rng.integers(0, cfg.vocab, (4, 1)), 32, axis=1).astype(np.int32)
        p, loss = step(p, T.shard_tokens(tok, m))
        losses.append(float(loss))
    return dict(losses=losses, wq_spec=placement.spec(p, "l0/wq", 2))


def _decode_cases(m, cases):
    """Each decode case ``(name, kind, cfg kwargs, seed, args)`` with whole
    weights and with Megatron's on ``m``: the tokens of both (and the
    beam scores)."""
    out = {}
    for name, kind, kw, seed, args in cases:
        cfg = T.LMConfig(**kw)
        p = T.init_lm(seed, cfg, "cpu")
        tp = T.shard_lm_params(p, m)
        prompt = torch.as_tensor(args["prompt"]).long()
        runs = []
        for params, mesh in ((p, None), (tp, m)):
            if kind == "generate":
                gen = torch.Generator().manual_seed(5) if args.get("temperature") else None
                toks = T.lm_generate(params, prompt, cfg, steps=args["steps"], mesh=mesh,
                                     temperature=args.get("temperature"), top_k=args.get("top_k"),
                                     prompt_lengths=args.get("lengths"), generator=gen)
                runs.append((toks.numpy(),))
            elif kind == "continue":
                o1, st = T.lm_generate(params, prompt, cfg, steps=5, return_state=True,
                                       max_len=40, mesh=mesh)
                o2, _ = T.lm_generate_continue(params, st, cfg, steps=4, mesh=mesh,
                                               new_tokens=torch.as_tensor(args["turn"]).long())
                runs.append((o1.numpy(), o2.numpy()))
            elif kind == "speculative":
                if mesh is None:
                    runs.append((T.lm_generate(params, prompt, cfg, steps=8).numpy(),))
                else:
                    dcfg = T.LMConfig(vocab=kw["vocab"], d_model=16, n_heads=2, n_layers=1,
                                      d_ff=32)
                    draft = T.init_lm(7, dcfg, "cpu")
                    runs.append((speculative_generate(params, cfg, draft, dcfg, prompt, steps=8,
                                                      gamma=3, mesh=mesh).numpy(),))
            else:  # beam
                toks, scores = T.lm_beam_search(params, prompt, cfg, steps=5, beam_width=3,
                                                mesh=mesh)
                runs.append((toks.numpy(), scores.numpy()))
        out[name] = dict(whole=runs[0], tp=runs[1], kv_heads=T._heads(tp, cfg).kv_heads)
    return out


def tp_world(cases, tokens, train, decode):
    """Every training case ``(name, (d, s), cfg kwargs, params)`` on its
    mesh (:func:`_tp_case`; ranks outside a ``1 x 2`` mesh skip it), the
    training run ``(cfg kwargs, params, steps, lr)`` and the decode cases
    on the 4 x 2 mesh."""
    meshes = {(4, 2): _mesh(4, 2), (1, 2): _mesh(1, 2)}
    out = {}
    for name, shape, kw, params in cases:
        m = meshes[tuple(shape)]
        if m.active:
            p = {k: torch.as_tensor(v) for k, v in params.items()}
            out[name] = _tp_case(m, T.LMConfig(**kw), p, tokens)
    kw, params, steps, lr = train
    out["train"] = _train_case(meshes[(4, 2)], T.LMConfig(**kw),
                               {k: torch.as_tensor(v) for k, v in params.items()}, steps, lr)
    out["decode"] = _decode_cases(meshes[(4, 2)], decode)
    return out


# -- ZeRO-1 and FSDP --


def _leaf_bytes(tree):
    return {p: t.numel() * t.element_size() for p, t in placement.leaves(tree)}


def _placements(m, m_tp, params):
    """The placements of the JAX package's ZeRO-1 and FSDP tests: each
    tree's specs and this rank's bytes beside the whole tree's."""
    adam = optim.Adam(1e-2)
    out = {}

    def rec(name, tree, whole):
        out[name] = dict(specs=_specs(tree), nbytes=_leaf_bytes(tree), whole=_leaf_bytes(whole))

    opt = adam.init(params)
    rec("zero1", T.zero1_shard_opt_state(opt, m), opt)
    tp = T.shard_lm_params(params, m)
    rec("zero1 tp", T.zero1_shard_opt_state(adam.init(tp), m), opt)
    rec("zero1 trivial data", T.zero1_shard_opt_state(adam.init(T.shard_lm_params(params, m_tp)),
                                                      m_tp), opt)
    odd = {"w": torch.zeros(3, 5)}
    rec("zero1 indivisible", T.zero1_shard_opt_state(odd, m), odd)
    fsdp = T.fsdp_shard_lm_params(params, m)
    rec("fsdp", fsdp, params)
    rec("fsdp opt", adam.init(fsdp), opt)
    rec("fsdp tp", T.fsdp_shard_lm_params(tp, m), params)
    rec("fsdp indivisible", T.fsdp_shard_lm_params(odd, m), odd)
    return out


def _trajectory(m, cfg, params, batches, tx, place):
    """``tx`` on the placed ``params`` over ``batches`` (one step each):
    the losses and the final parameters, whole."""
    p, opt = place(params, tx)
    losses = []
    for tokens in batches:
        data = T.shard_tokens(tokens, m)
        loss, grads = T.value_and_grad(lambda q: T.lm_loss(q, data, cfg, mesh=m), p, mesh=m)
        with torch.no_grad():
            updates, opt = tx.update(grads, opt, p)
            p = optim.apply_updates(p, updates)
        losses.append(float(loss))
    return dict(losses=losses, params=_np(placement.gather(p)), specs=_specs(p),
                opt_specs=_specs(opt))


def _placer(names):
    """The CLI's placement for a set of flag names (``tp``, ``fsdp``,
    ``zero1``), in its order."""
    def place(params, tx, m):
        if "tp" in names:
            params = T.shard_lm_params(params, m)
        if "fsdp" in names:
            params = T.fsdp_shard_lm_params(params, m)
        opt = tx.init(params)
        if "zero1" in names:
            opt = T.zero1_shard_opt_state(opt, m)
        return params, opt

    return place


def zero1_fsdp_world(params, trajectories, batches, sgd):
    """On a 4 x 2 mesh (and a 1 x 8 one for a trivial data axis):
    :func:`_placements` of ``params`` (the tests' config); each trajectory
    ``(name, cfg kwargs, params, optimizer, optimizer kwargs, placement
    names)`` over ``batches``; and ``sgd`` ``(cfg kwargs, params, tokens)``:
    two SGD steps (lr 0.1) of FSDP parameters under remat, RoPE and
    ``ring``."""
    m, m_tp = _mesh(4, 2), _mesh(1, 8)
    torch_params = {k: torch.as_tensor(v) for k, v in params.items()}
    out = {"placements": _placements(m, m_tp, torch_params), "runs": {}}
    for name, kw, init, opt_name, opt_kw, names in trajectories:
        tx = optim.OPTIMIZERS[opt_name](1e-2, **opt_kw)
        place = _placer(names)
        out["runs"][name] = _trajectory(m, T.LMConfig(**kw),
                                        {k: torch.as_tensor(v) for k, v in init.items()},
                                        batches, tx, lambda p, t: place(p, t, m))
    kw, init, tokens = sgd
    cfg = T.LMConfig(**kw)
    p = T.fsdp_shard_lm_params({k: torch.as_tensor(v) for k, v in init.items()}, m)
    step = T.make_lm_train_step(cfg, lr=0.1, mesh=m)
    losses = []
    for _ in range(2):
        p, loss = step(p, T.shard_tokens(tokens, m))
        losses.append(float(loss))
    out["sgd"] = dict(losses=losses, emb_spec=placement.spec(p, "emb", 2))
    return out


# -- the LM CLI on a data x server world --


def cli_world(runs):
    """The LM CLI on this rank once a run ``(argv, params_file)``, with the
    port's ``init_lm`` returning the float32 weights saved in
    ``params_file`` (the JAX ``init_lm``'s, carried across by
    ``convert``): each run's exit code (a flag error's 2) and what it
    printed (rank 0 alone prints)."""
    from parameter_server_tpu_torch.apps.lm import main as lm_main

    real = T.init_lm
    out = []
    try:
        for argv, params_file in runs:
            saved = dict(np.load(params_file))
            T.init_lm = lambda seed, cfg, device=None, saved=saved: {
                k: torch.as_tensor(v).to(device) for k, v in saved.items()}
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                try:
                    code = lm_main.main(list(argv))
                except SystemExit as e:
                    code = e.code
            out.append((code, buf.getvalue()))
    finally:
        T.init_lm = real
    return out

"""Per-rank bodies of the multi-device checks: module-level functions,
so ``launch.mesh.spawn`` can start them (a spawned rank imports its
function by name).  Each takes ``(rank, device, ...)`` with numpy or
tensor inputs, builds its mesh over the running ranks, and returns what
its check compares (tensors on the CPU): the CPU tests run them on gloo
ranks, the card test and ``chip_smoke.py`` on two gloo ranks sharing
``cuda:0``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.launch.mesh import mesh_over_ranks
from repro_torch.launch.mesh_lowering import mesh_for_cores
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.weights import params_from_numpy
from repro_torch.sharding import set_rules_for_mesh
from repro_torch.sharding.collectives import gather_spec, psum
from repro_torch.sharding.rules import local_slice
from repro_torch.serve import distributed_decode as dd

AXES = ("data", "model")


def _cpu(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def decode_attention(rank, device, shape, q, k, v, lengths, wo) -> dict:
    """``distributed_decode_attention`` and
    ``head_parallel_decode_attention`` on a (data, model) mesh of
    ``shape`` over the running ranks, each on this rank's blocks of the
    global inputs (the rows over "data"; the time columns, or the
    heads, over "model"), each output's rows gathered."""
    mesh = mesh_over_ranks(shape, AXES, device=device)

    def block(t, *spec):
        return local_slice(t.to(device), ("data",) + spec, mesh)

    with set_rules_for_mesh(mesh):
        out = {"dist": dd.distributed_decode_attention(
                   block(q), block(k, None, "model"), block(v, None, "model"),
                   block(lengths)),
               "hp": dd.head_parallel_decode_attention(
                   block(q, "model"), block(k, "model"), block(v, "model"),
                   block(lengths), local_slice(wo.to(device), ("model",),
                                               mesh))}
        out = {k_: gather_spec(v_, ("data",), mesh) for k_, v_ in out.items()}
    return {k_: _cpu(v_) for k_, v_ in out.items()}


def mesh_ledger(plan) -> list:
    """The downgrades and notes the multi-device decode paths left on
    a serving plan's ExecutionPlans, in order (none without a plan)."""
    out = []
    for p in ([] if plan is None else plan.plans()):
        out += [("downgrade", d.reason, d.from_path, d.to_path)
                for d in p.downgrades if "decode" in d.reason
                and ("shard" in d.reason or "partial" in d.reason)]
        out += [("note", n) for n in p.notes if "decode over axis" in n]
    return out


#: the attention function each decode flag routes through
_FLAG_CALLS = {"head_parallel_decode": "head_parallel_decode_attention",
               "distributed_decode": "distributed_decode_attention"}


def _serve(device, cfg, params_np, prompts, max_len, steps, flags, shape,
           swap_at=None, chunk=None) -> tuple:
    """The mesh parity run on the sharded serving state: ``cfg`` with
    each of ``flags`` set, its weights placed as this rank's blocks of
    ``params_np``, two prompts through a ``ContinuousBatchingEngine``
    (batch 2) with a serving plan for ``steps`` engine steps, on
    ``mesh_for_cores(2)`` (``shape`` None) or a (data, model) mesh of
    ``shape``, prefilled in ``chunk``-token chunks (None: whole
    prompts).  ``swap_at``: after that many steps both rows are
    preempted and resumed in each other's slot, so each row's blocks
    travel through a snapshot (the tokens of later steps come back in
    swapped columns).  Returns (the tokens of every step, how often the
    decode flag's attention ran, the plan's mesh ledger, the engine)."""
    from repro_torch import lower
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          make_serving_plan)
    from repro_torch.serve.layout import serving_layout

    flags = (flags,) if isinstance(flags, str) else tuple(flags)
    cfg = dataclasses.replace(cfg, **{f: True for f in flags})
    mesh = mesh_for_cores(2, device=device) if shape is None \
        else mesh_over_ranks(shape, AXES, device=device)
    params = params_from_numpy(params_np, cfg, device=device,
                               fsdp=serving_layout(cfg, mesh))
    name = next(_FLAG_CALLS[f] for f in flags if f in _FLAG_CALLS)
    calls = {"n": 0}
    orig = getattr(attn_mod, name)

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    setattr(attn_mod, name, counting)
    try:
        lower.clear_plan_cache()
        plan = make_serving_plan(cfg, max_len, device=device)
        with set_rules_for_mesh(mesh):
            eng = ContinuousBatchingEngine(params, cfg, batch_size=2,
                                           max_len=max_len, plan=plan,
                                           prefill_chunk=chunk,
                                           device=device)
            for slot, p in enumerate(prompts):
                eng.begin_prefill(slot, p)
            toks = []
            for i in range(steps):
                if i == swap_at:
                    pre = [eng.preempt(slot) for slot in (0, 1)]
                    eng.resume(pre[0], 1)
                    eng.resume(pre[1], 0)
                t, _ins = eng.step()
                toks.append(None if t is None else np.asarray(t).tolist())
    finally:
        setattr(attn_mod, name, orig)
    return toks, calls["n"], mesh_ledger(plan), eng


def serve_state(rank, device, cfg, params_np, prompts, max_len: int,
                steps: int, flag, shape=None, swap_at=None,
                chunk=None) -> dict:
    """The mesh parity run (:func:`_serve`, ``flag`` a flag name or a
    tuple of them) and what the rank holds: the tokens of every step,
    how often the decode flag's attention ran and the plan's mesh
    ledger, then the local shape of every parameter and decode-state
    leaf by its path (``launch.dryrun``'s paths), the bytes it holds of
    each, and their sums."""
    from repro_torch.launch.dryrun import _paths
    from repro_torch.sharding.fsdp import held_bytes

    toks, calls, ledger, eng = _serve(device, cfg, params_np, prompts,
                                      max_len, steps, flag, shape, swap_at,
                                      chunk)
    leaves = {"params": dict(_paths(eng.params)),
              "state": dict(_paths(eng.state))}
    return {"tokens": toks, "calls": calls, "ledger": ledger,
            "shapes": {part: {k: tuple(x.shape) for k, x in t.items()}
                       for part, t in leaves.items()},
            "bytes": {part: {k: held_bytes(x) for k, x in t.items()}
                      for part, t in leaves.items()},
            "held": {"params": held_bytes(eng.params),
                     "caches": held_bytes(eng.state)}}


def moe_paths(rank, device, shapes, cfg, params_np, x) -> dict:
    """``moe.moe_forward`` on the global path (no mesh) and, on each
    (data, model) mesh of ``shapes``, with ``moe_shard_map_ep`` and with
    ``moe_local_dispatch``: (y, aux, gradients of sum(y**2) by leaf)
    for each."""
    params = params_from_numpy(params_np, cfg, device=device)
    x = x.to(device)

    def run(c):
        leaves = tree.map(lambda p: p.detach().requires_grad_(), params)
        y, aux = moe_mod.moe_forward(leaves, c, x)
        (y.float() ** 2).sum().backward()
        return {"y": _cpu(y), "aux": {k: _cpu(v) for k, v in aux.items()},
                "grads": tree.map(lambda p: _cpu(p.grad), leaves)}

    out = {"global": run(cfg)}
    for shape in shapes:
        mesh = mesh_over_ranks(shape, AXES, device=device)
        with set_rules_for_mesh(mesh):
            for flag in ("moe_shard_map_ep", "moe_local_dispatch"):
                out[(tuple(shape), flag)] = run(
                    dataclasses.replace(cfg, **{flag: True}))
    return out


def fsdp_train(cfg, mesh, device, **loop_kw) -> tuple:
    """``launch.train.train_loop`` on ``mesh`` (its blocks; every rank
    calls it): (this rank's state of blocks, the losses, the bytes it
    holds of parameters, gradients and AdamW state).  The gradient
    buffers a step makes are ``zeros_like`` the parameter blocks
    (``train.step.value_and_grad``), so their bytes are the blocks'."""
    from repro_torch.launch import train as train_mod
    from repro_torch.sharding.fsdp import held_bytes

    state, losses = train_mod.train_loop(cfg, mesh=mesh, device=device,
                                         **loop_kw)
    return state, losses, {"params": held_bytes(state.params),
                           "grads": held_bytes(state.params),
                           "optimizer": held_bytes(state.opt)}


def train_mesh(device, shape=None):
    """The training mesh over every running rank: a (data, model) mesh
    of ``shape``, or (None) a data mesh of them all."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if shape is None:
        return make_host_mesh(data=dist.get_world_size(), device=device)
    return mesh_over_ranks(tuple(shape), AXES, device=device)


def train_data_parallel(rank, device, cfg, params_np, loop_kw,
                        shape=None) -> dict:
    """:func:`fsdp_train` on :func:`train_mesh` (``shape``), from
    ``params_np``: its losses, the final parameters gathered from the
    ranks' blocks, the bytes this rank holds and its blocks' shapes."""
    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    params = params_from_numpy(params_np, cfg, device=device)
    state, losses, held = fsdp_train(cfg, mesh, device, params=params,
                                     **loop_kw)
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    return {"losses": losses,
            "params": tree.map(_cpu, fsdp.full(state.params)),
            "held": held,
            "block_shapes": tree.map(lambda x: tuple(x.shape),
                                     state.params)}


def train_step_on_mesh(rank, device, cfg, params_np, batch, lr,
                       shape=None) -> dict:
    """One ``train.step.train_step`` on :func:`train_mesh` (``shape``),
    from the blocks of ``params_np``, on the global ``batch`` (a dict of
    CPU tensors): its metrics, the step's gradients (``value_and_grad``
    on this rank's rows, as the step takes them) and the parameters
    after the step, both gathered from the blocks; the bytes this rank
    holds and its blocks' shapes."""
    from repro_torch.sharding.fsdp import held_bytes
    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    params = fsdp.place(params_from_numpy(params_np, cfg, device=device))
    state = step_mod.init_train_state(None, cfg, device=device,
                                      params=params)
    batch = {k: v.to(device) for k, v in batch.items()}
    rows = {k: local_slice(v, (fsdp.axes,), mesh) for k, v in batch.items()}
    with set_rules_for_mesh(mesh):
        _, grads = step_mod.value_and_grad(state.params, cfg, rows,
                                           fsdp=fsdp)
        state, metrics = step_mod.train_step(state, batch, cfg, lr=lr)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tree.map(_cpu, fsdp.full(grads)),
            "params": tree.map(_cpu, fsdp.full(state.params)),
            "held": {"params": held_bytes(state.params),
                     "grads": held_bytes(grads),
                     "optimizer": held_bytes(state.opt)},
            "block_shapes": tree.map(lambda x: tuple(x.shape),
                                     state.params)}


def seq_stream_step(rank, device, cfg, params_np, batch, shape,
                    rules=None) -> dict:
    """``train.step.loss_fn`` and its backward on :func:`train_mesh`
    (``shape``) under ``rules`` (None: the default, whose
    ``seq_stream`` holds the residual stream as sequence blocks of the
    model axis), from the blocks of ``params_np``, on the global
    ``batch``: the metrics, the gradients gathered from the blocks
    (rank 0's; None on the others), the residual stream each layer's
    forward returned on this rank, the bytes autograd saved of the
    layers' inputs (``saved_tensors_hooks``: a checkpointed layer saves
    its input alone), each stream spec the forward resolved with its
    global shape, and this rank's model-axis index."""
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import rules as shrules
    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    params = fsdp.place(params_from_numpy(params_np, cfg, device=device))
    grads = tree.map(torch.zeros_like, params)
    leaves = step_mod._trainable(params, grads)
    rows = {k: local_slice(v.to(device), (fsdp.axes,), mesh)
            for k, v in batch.items()}
    streams, inputs, saved, specs = [], set(), [], []
    layer, resolve = tf._layer_forward, shrules.stream_spec
    forward = [True]                # a recompute in the backward: False

    def recorded_layer(lp, c, kinds, x, *a, **kw):
        out = layer(lp, c, kinds, x, *a, **kw)
        if forward[0]:
            inputs.add(x.data_ptr())
            streams.append(_cpu(out[0]))
        return out

    def recorded_spec(shp, *a, **kw):
        spec = resolve(shp, *a, **kw)
        specs.append((tuple(shp), spec))
        return spec

    def pack(t):
        saved.append((t.data_ptr(), t.numel() * t.element_size()))
        return t

    tf._layer_forward, shrules.stream_spec = recorded_layer, recorded_spec
    try:
        with set_rules_for_mesh(mesh, rules):
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                total, metrics = step_mod.loss_fn(leaves, cfg, rows,
                                                  fsdp=fsdp)
            forward[0] = False
            total.backward()
    finally:
        tf._layer_forward, shrules.stream_spec = layer, resolve
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "total": float(total.detach()),
            "grads": fsdp.full(grads, device="cpu", keep=rank == 0),
            "streams": streams,
            "saved_inputs": sum(n for ptr, n in saved if ptr in inputs),
            "specs": specs,
            "model_index": mesh.axis_index("model")}


def seq_collectives(rank, device, shape) -> dict:
    """``collectives.seq_gather`` and ``seq_scatter`` over the model
    axis of a (data, model) mesh of ``shape``, fp32 and bf16, each
    rank's input ``rank + arange``: their outputs, their inputs'
    gradients under a cotangent of ``1 + rank`` times the output's
    index, and the bytes counted under each collective op."""
    from repro_torch.launch import cost_analysis
    from repro_torch.sharding.collectives import seq_gather, seq_scatter

    mesh = mesh_over_ranks(tuple(shape), AXES, device=device)
    n = mesh.axis_size("model")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, fn, rows in (("gather", seq_gather, 4),
                               ("scatter", seq_scatter, 4 * n)):
            x = (torch.arange(2 * rows * 3, dtype=torch.float32)
                 .reshape(2, rows, 3) + rank).to(device, dtype)
            x.requires_grad_()
            with cost_analysis.count() as c:
                y = fn(x, mesh)
                ct = (torch.arange(y.numel(), dtype=torch.float32)
                      .reshape(y.shape) * (1 + rank)).to(device, dtype)
                y.backward(ct)
            out[name, str(dtype)] = {
                "y": _cpu(y), "grad": _cpu(x.grad),
                "bytes": c.result()["collective_bytes"]}
    return out


class _Crash(Exception):
    """The failure :func:`fsdp_state` injects into a training run."""


def fsdp_state(rank, device, cfg, params_np, loop_kw, ckpt_dir,
               shape=None) -> dict:
    """``launch.train.train_loop`` with int8 gradient compression on
    :func:`train_mesh` (``shape``), three times: uninterrupted,
    checkpointing its last step; crashed after the step before it,
    checkpointed there; resumed from that checkpoint.  Returns the
    losses, the uninterrupted run's checkpoint restored as this rank's
    blocks (``restore(shardings=)``) beside its final state, the
    resumed run's final state, the whole state as every rank and as
    rank 0 alone keeps it, and the gradient norm and int8 scales of the
    parameter blocks beside the whole tensors'."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.compression import _quant_int8
    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    steps = loop_kw["steps"]

    def run(name, **kw):
        params = params_from_numpy(params_np, cfg, device=device)
        return train_mod.train_loop(
            cfg, mesh=mesh, params=params, device=device,
            ckpt_dir=os.path.join(ckpt_dir, name), grad_compression=True,
            **loop_kw, **kw)

    def crash(step, metrics, seconds):
        if step == steps - 1:
            raise _Crash

    state, losses = run("whole", checkpoint_every=steps)
    dist.barrier()                      # rank 0 has written it
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    restored, extras = CheckpointManager(
        os.path.join(ckpt_dir, "whole")).restore(
        state, shardings=step_mod.state_shardings(state, fsdp))
    try:
        run("crash", checkpoint_every=steps - 1, on_step=crash)
    except _Crash:
        pass
    dist.barrier()
    resumed, resumed_losses = run("crash", checkpoint_every=steps)
    whole = step_mod.whole_state(state, fsdp)
    kept = step_mod.whole_state(state, fsdp, keep=mesh.rank == 0)
    shardings = tree.leaves(fsdp.shardings())
    return {
        "kept": None if kept is None else tree.map(_cpu, kept),
        "losses": losses, "resumed_losses": resumed_losses,
        "extras": extras, "restored": tree.map(_cpu, restored),
        "state": tree.map(_cpu, state), "resumed": tree.map(_cpu, resumed),
        "whole": tree.map(_cpu, whole),
        "norm": (float(global_norm(state.params, fsdp.shardings())),
                 float(global_norm(whole.params))),
        "scales": ([float(_quant_int8(x.float(), sh)[1]) for x, sh in
                    zip(tree.leaves(state.params), shardings)],
                   [float(_quant_int8(x.float())[1])
                    for x in tree.leaves(whole.params)]),
        "specs": [sh.spec for sh in shardings]}


def remesh(rank, device, state, axes, shape, ckpt_dir) -> dict:
    """The elastic round trips from a (data, model) mesh of ``shape``
    over the running ranks to this rank alone: ``remesh_state`` of this
    rank's blocks of ``state``, and ``ElasticRunner`` restoring a
    checkpoint of ``state`` on the large mesh, then on the small."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import ElasticRunner, remesh_state
    from repro_torch.sharding import param_shardings

    big = mesh_over_ranks(shape, AXES, device=device)
    alone = Mesh(AXES, (1, 1), device=device)
    blocks = tree.map(lambda s, x: s.local(x).clone(),
                      param_shardings(axes, big), state)
    moved = remesh_state(blocks, axes, alone, mesh=big)
    ckpt = CheckpointManager(ckpt_dir)
    if rank == 0:
        ckpt.save(0, state, extras={"next_step": 1}, blocking=True)
    dist.barrier()
    restored = {}
    for name, factory in (("big", lambda: big), ("alone", lambda: alone)):
        runner = ElasticRunner(ckpt, axes, factory)
        got, extras, mesh = runner.restore_on_current_mesh(state)
        restored[name] = (tree.map(_cpu, got), extras,
                          tuple(mesh.devices.shape))
    dist.barrier()
    shapes = tree.map(lambda x: tuple(x.shape), blocks)
    return {"blocks": shapes, "moved": tree.map(_cpu, moved),
            "restored": restored}


def in_turn(rank, device, calls) -> list:
    """Each ``(body, args)`` of ``calls`` in turn on the same ranks (one
    spawn pays process and device start-up once): their results."""
    return [body(rank, device, *args) for body, args in calls]


def sharded_pieces(rank, device, cfg, params_np, x, prefix, start: int,
                   tokens) -> dict:
    """Two items of the sharded serving state alone, on
    ``mesh_for_cores(2)`` under ``distributed_decode``, beside the whole
    state on this rank without a mesh: layer 0's ``gqa_forward`` of the
    chunk ``x`` (B, S, d) at ``start`` over a cache whose K and V
    (``prefix``, global (B, Hkv, max_len, D)) are this rank's time
    columns (the chunk's K/V gathered over the heads, the columns turned
    into heads by an ``all_to_all``): its output and the cache after,
    gathered; the vocabulary lookup of ``tokens`` (B, S) on this rank's
    ``embed`` rows, and a cache-free ``forward``'s logits on the
    blocks."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.layout import serving_layout

    cfg = dataclasses.replace(cfg, distributed_decode=True)
    mesh = mesh_for_cores(2, device=device)
    layout = serving_layout(cfg, mesh)
    whole = params_from_numpy(params_np, cfg, device=device)
    blocks = params_from_numpy(params_np, cfg, device=device, fsdp=layout)
    x, tokens = x.to(device), tokens.to(device)
    positions = (start + torch.arange(x.shape[1], device=device))[None]
    cspec = (None, None, "model", None)

    def layer0(p):
        return {k: v[0] for k, v in p["layers"][0]["attn"].items()}

    cache = {n: t.to(device).clone() for n, t in zip("kv", prefix)}
    want, _ = attn_mod.gqa_forward(layer0(whole), cfg, x, positions,
                                   cache=cache, cache_len=start)
    mine = {n: local_slice(t.to(device), cspec, mesh).clone()
            for n, t in zip("kv", prefix)}
    with set_rules_for_mesh(mesh):
        got, _ = attn_mod.gqa_forward(
            layer0(blocks), cfg, x, positions, cache=mine, cache_len=start,
            specs=tf._unstack(layout.specs["layers"][0])["attn"])
        got_cache = {n: gather_spec(t, cspec, mesh) for n, t in mine.items()}
        lookup, partial = tf._rows(blocks["embed"], tokens,
                                   layout.specs["embed"])
        if partial:
            lookup = psum(lookup, mesh, "model")
        logits = tf.forward(blocks, cfg, tokens, fsdp=layout)
    return {"attn": (_cpu(got), _cpu(want)),
            "cache": {n: (_cpu(got_cache[n]), _cpu(cache[n])) for n in "kv"},
            "lookup": (_cpu(lookup), _cpu(whole["embed"][tokens])),
            "logits": (_cpu(logits), _cpu(tf.forward(whole, cfg, tokens))),
            "embed_rows": tuple(blocks["embed"].shape)}


def _layer0(params, key: str, specs=None):
    """The first body layer's ``key`` sublayer of ``params`` (or of the
    layout's ``specs``): a period's views, or the specs without their
    period axis."""
    from repro_torch.models import transformer as tf
    if specs is not None:
        return tf._unstack(specs["layers"][0])[key]
    return {k: v[0] for k, v in params["layers"][0][key].items()}


def mla_blocks_alone(rank, device, cfg, params_np, x, latent, start: int,
                     x1, lengths) -> dict:
    """MLA's layer alone on the sharded serving state, on
    ``mesh_for_cores(2)`` under ``distributed_decode``, beside the whole
    layer on this rank without a mesh: a chunk ``x`` (1, S, d) at
    ``start`` over a latent cache whose prefix ``latent`` (global (1,
    max_len, r_kv + rope)) is this rank's time columns, and a decode
    step of ``x1`` (B, 1, d) at per-row ``lengths`` over the same prefix
    repeated per row: each output and the cache after (gathered), and
    the specs of every ``gather_spec`` the decode step made."""
    from repro_torch.serve.layout import serving_layout

    cfg = dataclasses.replace(cfg, distributed_decode=True)
    mesh = mesh_for_cores(2, device=device)
    layout = serving_layout(cfg, mesh, max_len=latent.shape[1])
    whole = _layer0(params_from_numpy(params_np, cfg, device=device), "attn")
    blocks = _layer0(params_from_numpy(params_np, cfg, device=device,
                                       fsdp=layout), "attn")
    specs = _layer0(None, "attn", layout.specs)
    cspec = (None, "model", None)
    x, x1, latent = x.to(device), x1.to(device), latent.to(device)
    lengths = lengths.to(device)
    out = {}
    for name, inp, at, prefix in (
            ("chunk", x, start, latent),
            ("decode", x1, lengths - 1,
             latent.expand(x1.shape[0], -1, -1))):
        pos = (at + torch.arange(inp.shape[1], device=device))[None] \
            if name == "chunk" else at[:, None].to(torch.int32)
        cache = {"latent": prefix.clone()}
        want, _ = attn_mod.mla_forward(whole, cfg, inp, pos, cache=cache,
                                       cache_len=at)
        mine = {"latent": local_slice(prefix, cspec, mesh).clone()}
        seen = []
        gather = attn_mod.gather_spec

        def recorded(t, spec, m):
            seen.append(tuple(spec))
            return gather(t, spec, m)
        attn_mod.gather_spec = recorded
        try:
            with set_rules_for_mesh(mesh):
                got, _ = attn_mod.mla_forward(blocks, cfg, inp, pos,
                                              cache=mine, cache_len=at,
                                              specs=specs)
                got_cache = gather_spec(mine["latent"], cspec, mesh)
        finally:
            attn_mod.gather_spec = gather
        out[name] = {"out": (_cpu(got), _cpu(want)),
                     "cache": (_cpu(got_cache), _cpu(cache["latent"])),
                     "gathers": seen}
    out["latent_block"] = tuple(mine["latent"].shape)
    return out


def mamba_blocks_alone(rank, device, cfg, params_np, x, conv, ssm) -> dict:
    """Mamba-2's layer alone on the sharded serving state, on
    ``mesh_for_cores(2)``, beside the whole layer on this rank without a
    mesh: a decode step (``x[:, :1]``) and a prefill chunk (``x``) over
    the conv tail ``conv`` and SSM state ``ssm`` (global), each output
    and the conv tail and SSM state after (gathered from the blocks);
    and the block norm of random rows (``inner`` split) against
    ``rms_norm``."""
    from repro_torch.models import mamba as mb
    from repro_torch.models.common import rms_norm
    from repro_torch.serve.layout import cache_spec, serving_layout

    cfg = dataclasses.replace(cfg, head_parallel_decode=True)
    mesh = mesh_for_cores(2, device=device)
    layout = serving_layout(cfg, mesh)
    whole = _layer0(params_from_numpy(params_np, cfg, device=device),
                    "mamba")
    blocks = _layer0(params_from_numpy(params_np, cfg, device=device,
                                       fsdp=layout), "mamba")
    specs = _layer0(None, "mamba", layout.specs)
    x, conv, ssm = x.to(device), conv.to(device), ssm.to(device)
    cspec = {k: cache_spec(layout, cfg, f"/{k}", t.shape)
             for k, t in (("conv", conv), ("ssm", ssm))}
    out = {}
    for name, inp in (("decode", x[:, :1]), ("chunk", x)):
        cache = {"conv": conv.clone(), "ssm": ssm.clone()}
        want, _ = mb.mamba_forward(whole, cfg, inp, cache=cache)
        mine = {k: local_slice(t, cspec[k], mesh).clone()
                for k, t in (("conv", conv), ("ssm", ssm))}
        with set_rules_for_mesh(mesh):
            got, _ = mb.mamba_forward(blocks, cfg, inp, cache=mine,
                                      specs=specs)
            after = {k: gather_spec(t, cspec[k], mesh)
                     for k, t in mine.items()}
        out[name] = {"out": (_cpu(got), _cpu(want)),
                     **{k: (_cpu(after[k]), _cpu(cache[k]))
                        for k in mine}}
    d_in = cfg.inner_dim
    y = torch.randn(6, d_in, generator=torch.Generator().manual_seed(5))
    y = y.to(device)
    with set_rules_for_mesh(mesh):
        got = rms_norm(mb._block(y, True, mesh.axis_index("model"), 2),
                       blocks["norm"], mesh=mesh, width=d_in)
        got = gather_spec(got, (None, "model"), mesh)
    out["norm"] = (_cpu(got), _cpu(rms_norm(y, whole["norm"])))
    out["blocks"] = {k: tuple(v.shape) for k, v in blocks.items()}
    return out


def moe_blocks_alone(rank, device, cfg, params, x) -> dict:
    """deepseek-v3's MoE layer on the sharded serving state alone, on
    ``mesh_for_cores(2)`` under ``distributed_decode``: the first body
    layer's ``moe_forward`` of ``x`` (B, S, d) on this rank's blocks
    (its experts and router columns, the shared MLP's column blocks),
    beside the whole layer on this rank without a mesh, its routed
    experts alone (no ``shared`` leaf) and, with a shared expert, every
    rank's partial of the shared MLP on its column block before the
    ``psum`` (stacked in rank order).  ``params``: the whole tree, CPU
    tensors."""
    from repro_torch.models.common import mlp_forward
    from repro_torch.serve.layout import serving_layout

    cfg = dataclasses.replace(cfg, distributed_decode=True)
    mesh = mesh_for_cores(2, device=device)
    layout = serving_layout(cfg, mesh)
    whole = tree.map(lambda t: t.to(device), params)
    blocks = layout.place(whole)
    x = x.to(device)

    def period0(p):
        return tree.map(lambda v: v[0], p["layers"][0]["moe"])

    mine, layer = period0(blocks), period0(whole)
    specs = _layer0(None, "moe", layout.specs)
    want, want_aux = moe_mod.moe_forward(layer, cfg, x)
    routed = dataclasses.replace(cfg, n_shared_experts=0)
    routed_y, _ = moe_mod.moe_forward(
        {k: v for k, v in layer.items() if k != "shared"}, routed, x)
    out = {"whole": _cpu(want), "whole_aux": tree.map(_cpu, want_aux),
           "routed": _cpu(routed_y)}
    with set_rules_for_mesh(mesh):
        got, aux = moe_mod.moe_forward(mine, cfg, x, specs=specs)
        if "shared" in mine:
            part = mlp_forward(mine["shared"], x, cfg.mlp)
            out["partials"] = _cpu(gather_spec(part[None], ("model",), mesh))
    out.update(blocks=_cpu(got), blocks_aux=tree.map(_cpu, aux))
    return out


def roofline_cells(rank, device, cells) -> list:
    """``launch.dryrun.rank_program`` of each (arch, shape, keyword
    arguments) of ``cells`` on every running rank (one process group for
    all): this rank's counts."""
    from repro_torch.launch import dryrun

    return [dryrun.rank_program(arch, shape, device=device, **kw)
            for arch, shape, kw in cells]


def remesh_blocks(rank, device, cfg, params_np, batch, lr, shape,
                  new_shape) -> dict:
    """One ``train_step`` on :func:`train_mesh` (``shape``) from the
    blocks of ``params_np``, then ``runtime.remesh_state`` of the
    state's parameters and AdamW moments onto a (data, model) mesh of
    ``new_shape`` over the same ranks: the moved blocks, and the state
    gathered from the first mesh's blocks."""
    from repro_torch.models.weights import param_axes
    from repro_torch.runtime import remesh_state
    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    state = step_mod.init_train_state(
        None, cfg, device=device,
        params=fsdp.place(params_from_numpy(params_np, cfg, device=device)))
    with set_rules_for_mesh(mesh):
        state, _ = step_mod.train_step(
            state, {k: v.to(device) for k, v in batch.items()}, cfg, lr=lr)
    new = mesh_over_ranks(tuple(new_shape), AXES, device=device)
    axes = param_axes(cfg)
    trees = {"params": state.params, "mu": state.opt.mu,
             "nu": state.opt.nu}
    return {"moved": {k: tree.map(_cpu, remesh_state(t, axes, new,
                                                       mesh=mesh))
                      for k, t in trees.items()},
            "whole": {k: tree.map(_cpu, fsdp.full(t))
                      for k, t in trees.items()}}


def grads_backward_elsewhere(rank, device, cfg, params_np, batch,
                             shape) -> dict:
    """The gradients of ``train.step.loss_fn`` on :func:`train_mesh`
    (``shape``) from the blocks of ``params_np``, on the global
    ``batch``, the forward under the mesh's rules and the backward run
    in another thread, where they are unset (as the autograd engine
    runs a CUDA graph's backward, and a checkpointed layer's recompute
    with it): gathered from the blocks."""
    import threading

    from repro_torch.train import step as step_mod

    mesh = train_mesh(device, shape)
    fsdp = step_mod.fsdp_layout(cfg, mesh)
    params = fsdp.place(params_from_numpy(params_np, cfg, device=device))
    grads = tree.map(torch.zeros_like, params)
    leaves = step_mod._trainable(params, grads)
    rows = {k: local_slice(v.to(device), (fsdp.axes,), mesh)
            for k, v in batch.items()}
    with set_rules_for_mesh(mesh):
        total, _ = step_mod.loss_fn(leaves, cfg, rows, fsdp=fsdp)
    failed = []

    def backward():
        try:
            total.backward()
        except BaseException as e:      # re-raised in the rank's thread
            failed.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    if failed:
        raise failed[0]
    return {"grads": tree.map(_cpu, fsdp.full(grads))}

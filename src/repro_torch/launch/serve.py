"""Serving entry point of the port: the continuous-batching loop over the
per-slot engine, on the card by default.

Requests of different prompt lengths are prefilled on the side
(chunked, interleaved with decode) and inserted into free batch rows
mid-stream; every decode step is one whole-batch step whose per-row
``cache_len`` feeds the masked kernels.  Weights are random, drawn
from a seeded generator.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --requests 6 --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --layers 4 --max-len 2048 \
        --prefill-chunk 1024

A Mamba-2 config has no serving plan: its prefill chunks run the SSD
scan kernel seeded with each row's state, its decode the one-token
update.  An MLA config (deepseek-v3) has none either: the engine
resolves its latent attention on the shape-only plan at each chunk and
step.  The attention/Mamba-2 hybrid (jamba) has none: its Mamba layers
run as mamba2's, its attention layers resolve the shape-only plan at
the cache's max_len.  ``--layers`` keeps the config's dense prefix, so
deepseek-v3 cut to 4 layers runs its 3 dense-FFN layers and one MoE
layer.

``--mesh hp`` (``head_parallel_decode``) or ``--mesh dist``
(``distributed_decode``) serves on ``--ranks`` gloo ranks laid out as
``mesh_for_cores(ranks)`` (a (1, ranks) mesh), each holding only its
blocks of the serving state (``serve.layout.serving_layout``): its
heads, MLP columns, vocabulary rows, experts and cache slice (a GQA
layer's K/V columns or KV heads, MLA's latent time columns, a Mamba-2
layer's conv channels and SSM heads, with its columns of ``in_proj``
and rows of ``inner``), drawn from the same seed as a single rank's
weights.  On the card the ranks
share the cards round-robin (two ranks on one card: gloo stages their
collectives through host memory); on the CPU pass ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \
        --smoke --mesh dist --ranks 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \
        --layers 4 --max-len 1024 --prefill-chunk 256 --mesh hp
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --mesh dist --ranks 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --smoke --mesh hp --ranks 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --mesh dist --ranks 2 \
        --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.common import resolve_device
from repro_torch.models.weights import init_params
from repro_torch.serve.batcher import Request, RequestBatcher
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      make_serving_plan)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers "
                         "(default: the config's)")
    ap.add_argument("--mesh", choices=sorted(MESH_FLAGS), default=None,
                    help="serve the sharded serving state on --ranks "
                         "ranks: head-parallel or sequence-sharded decode")
    ap.add_argument("--ranks", type=int, default=2,
                    help="with --mesh: the rank count (the model axis)")
    ap.add_argument("--init-file", default=None,
                    help="with --mesh: the file:// rendezvous file "
                         "(default: one under the checkout's build/)")
    return ap


#: ``--mesh``'s choices: the config flag each sets
MESH_FLAGS = {"hp": "head_parallel_decode", "dist": "distributed_decode"}


def config_for(args):
    """The config of the parsed arguments, with ``--mesh``'s flag."""
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if getattr(args, "mesh", None):
        cfg = dataclasses.replace(cfg, **{MESH_FLAGS[args.mesh]: True})
    return cfg


def model_for(args, fsdp=None):
    """(config, random params) for the parsed arguments; ``fsdp`` (a
    serving layout): this rank's blocks of the same draws."""
    cfg = config_for(args)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    if fsdp is not None:
        return cfg, fsdp.init(cfg, g, dev)
    return cfg, init_params(cfg, g, dev)


def make_requests(cfg, n: int, max_new: int, prompt_lens=(4, 12),
                  seed: int = 0) -> list:
    """``n`` requests whose prompts draw their lengths from
    ``[prompt_lens[0], prompt_lens[1])`` and their tokens uniformly."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(*prompt_lens)
                                        ).tolist(),
                    max_new_tokens=max_new)
            for uid in range(n)]


def run(args, cfg, params, requests) -> dict:
    """Serve ``requests`` through the batcher and the engine.  Returns
    the finished requests, the wall time, each decode step's time (the
    step ends in a host read of its tokens, so the host clock brackets
    the device work), the plan (None for a config the plan does not
    cover) and the engine."""
    dev = resolve_device(args.device)
    plan = make_serving_plan(cfg, max_len=args.max_len, device=dev)
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len,
        plan=plan, dtype=cfg.torch_dtype(),
        prefill_chunk=args.prefill_chunk, device=dev)
    step_s = []
    decode_once = eng.decode_once

    def timed_decode():
        t = time.perf_counter()
        out = decode_once()
        if out is not None:
            step_s.append(time.perf_counter() - t)
        return out

    eng.decode_once = timed_decode
    batcher = RequestBatcher(args.batch, max_len=args.max_len)
    for req in requests:
        batcher.submit(req)
    t0 = time.perf_counter()
    finished = batcher.serve(
        eng, max_steps=args.max_new * len(requests) + 64 * len(requests))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"finished": finished, "seconds": time.perf_counter() - t0,
            "decode_step_s": step_s, "plan": plan, "engine": eng}


def _rank_serve(rank, device, args) -> dict:
    """One rank of a ``--mesh`` serve: its blocks drawn, the requests
    served on ``mesh_for_cores(args.ranks)``.  Returns what ``main``
    prints and the bytes this rank holds."""
    from repro_torch.launch.mesh_lowering import mesh_for_cores
    from repro_torch.sharding import set_rules_for_mesh
    from repro_torch.serve.layout import serving_layout
    from repro_torch.sharding.fsdp import held_bytes

    args.device = str(device)
    mesh = mesh_for_cores(args.ranks, device=device)
    layout = serving_layout(config_for(args), mesh)
    cfg, params = model_for(args, layout)
    with set_rules_for_mesh(mesh):
        out = run(args, cfg, params,
                  make_requests(cfg, args.requests, args.max_new))
    eng = out.pop("engine")
    out["held"] = {"params": held_bytes(eng.params),
                   "caches": held_bytes(eng.state)}
    out["finished"] = [(r.uid, r.prompt, r.generated)
                       for r in out["finished"]]
    out["plan"] = None if out["plan"] is None else \
        sorted({p for (ph, _, _, p, _) in out["plan"].resolutions
                if ph == "decode"})
    return out


def _serve_on_mesh(args) -> dict:
    """``--mesh``: ``args.ranks`` gloo ranks over the cards (or the
    CPU), each serving on its blocks; rank 0's result."""
    from repro_torch.launch.mesh import spawn

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(args.ranks)]
    else:
        devices = ["cpu"] * args.ranks
    init_file = args.init_file or str(
        Path(__file__).resolve().parents[3] / "build" / "serve_mesh_init")
    Path(init_file).parent.mkdir(parents=True, exist_ok=True)
    outs = spawn(args.ranks, _rank_serve, backend="gloo", devices=devices,
                 init_file=init_file, args=(args,), timeout=24 * 3600)
    for rank, o in enumerate(outs):
        print(f"rank {rank} holds params {o['held']['params'] / 1e9:.3f} "
              f"GB, caches {o['held']['caches'] / 1e9:.3f} GB")
    return outs[0]


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mesh:
        out = _serve_on_mesh(args)
        finished = [Request(uid=u, prompt=p, max_new_tokens=args.max_new,
                            generated=g) for u, p, g in out["finished"]]
        paths = out["plan"]
    else:
        cfg, params = model_for(args)
        out = run(args, cfg, params,
                  make_requests(cfg, args.requests, args.max_new))
        finished = out["finished"]
        paths = None if out["plan"] is None else sorted(
            {p for (ph, _, _, p, _) in out["plan"].resolutions
             if ph == "decode"})
    dt = out["seconds"]
    total_tokens = sum(len(r.generated) for r in finished)
    print(f"served {len(finished)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)")
    if paths is not None:
        print(f"decode kernel paths used: {paths}")
    for r in finished[:3]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks -> "
              f"{r.generated[:8]}...")


if __name__ == "__main__":
    main()

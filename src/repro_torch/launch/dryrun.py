"""Multi-pod dry-run of the port: the sharding rules' layout of every
cell's state on the production meshes, whether it fits a card, and the
roofline terms of rank 0's program.

The JAX package's ``launch/dryrun.py`` compiles every (arch x input
shape) cell for 512 forced devices and reads the compiler's memory
analysis, cost analysis and the collective bytes of the HLO.  The port
has no compiler for a mesh it does not have.  Its dry-run instead, for
every cell on the single-pod (16, 16) and multi-pod (2, 16, 16)
production meshes:

* builds the cell's parameters, its AdamW state (train cells) and its
  decode caches (prefill and decode cells) on the ``meta`` device (shapes
  and dtypes, no storage);
* resolves each leaf's spec with the port's rules
  (``sharding.param_shardings``, shape-aware; caches by their role, as
  the JAX dry-run's ``decode_state_shardings``) and its shard shape;
* sums the per-device bytes of that state and holds them to one H100's
  80 GB of memory (:func:`run_cell`);
* runs rank 0's program of the cell on the ``meta`` device, as rank 0
  of a ``fake`` process group of the mesh's size
  (``launch.mesh.fake_world``, in a child process), and counts its
  FLOPs, bytes accessed and collective bytes by JAX's op keys
  (``launch/cost_analysis.py``; :func:`roofline_cell`).  The port runs
  eagerly, with no scan, so the program runs at full depth and needs no
  trip-count correction.

Rank 0's program, by the cell's kind:

* train: ``train.step.train_step`` on ``step.fsdp_layout``, on rank
  0's rows of the global batch (the data axes'; every rank of the
  model axis takes the same rows), at the config's remat, with bf16
  moments.  Every stack trains on JAX's ``param_shardings``: FSDP
  over the data axes and its heads, KV heads, Mamba-2 ``inner``,
  ``ssm_heads`` and conv channels, MLP columns, vocabulary rows and
  experts over "model" where they divide, so the rank holds what
  ``run_cell`` counts and computes on those blocks (``held`` gives its
  parameter and optimizer bytes);
* decode: ``serve.engine.decode_step`` on the sharded serving state
  (``serve/layout.py``) under ``distributed_decode``, JAX's dry-run
  layout (the cache's time over "model"; the config's own decode flag
  or ``flags=`` selects another),
  on rank 0's rows, every cache column counted valid (a filled prefix,
  as JAX's dry-run takes it);
* prefill: ``serve.engine.prefill`` on the same layout, a B=1 prefill
  for each of rank 0's requests (the global batch over the data axes),
  as the port's engine prefills; an encoder-only arch runs
  ``models.transformer.forward`` on rank 0's rows of the embeds.

The roofline seconds are the card's, not the TPU's: the NVIDIA H100
SXM5 80GB data sheet (700 W), 989 TFLOP/s dense bf16 and 3.35 TB/s of
HBM3, and 50 GB/s a GPU for collectives, one 400 Gb/s NDR InfiniBand
port: every production axis (16 or 2 devices) spans more than one
8-GPU NVLink node.  An axis within one node would see NVLink 4's 450
GB/s each way.  What it does not prove: the activation peak (no
allocator runs on ``meta``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out build/dryrun_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --roofline --out build/roofline_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape \\
        train_4k --roofline --out build/roofline_train.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch import configs, tree
from repro_torch.kernels import cost
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import (Mesh, fake_world, in_child,
                                     make_production_mesh, mesh_over_ranks)
from repro_torch.models import transformer as tf
from repro_torch.models.weights import init_params, param_axes
from repro_torch.optim import adamw_init
from repro_torch.serve import engine
from repro_torch.serve import layout as sl
from repro_torch.serve.engine import init_decode_state
from repro_torch.serve.layout import cache_logical
from repro_torch.sharding import rules as shrules
from repro_torch.sharding.fsdp import held_bytes
from repro_torch.train import step as train_step_mod

#: one NVIDIA H100 SXM's device memory (NVIDIA's data sheet)
H100_BYTES = 80e9

#: the roofline's rates: the NVIDIA H100 SXM5 80GB data sheet (700 W),
#: dense bf16 and HBM3 (``kernels/cost.py``), and a GPU's collective
#: rate across nodes, one 400 Gb/s NDR InfiniBand port (every production
#: axis spans more than one 8-GPU NVLink node; within a node NVLink 4
#: gives 450 GB/s each way)
HW = {"peak_flops": cost.PEAK_BF16, "hbm_bw": cost.PEAK_BYTES,
      "link_bw": 50e9}

#: the decode flag of a serving cell's layout: JAX's dry-run lays the
#: cache's time over "model"
DEFAULT_FLAGS = ("distributed_decode",)


def abstract_params(cfg) -> tuple:
    """(the parameter tree on the meta device, its logical axes)."""
    return init_params(cfg, None, "meta"), param_axes(cfg)


def _paths(node, prefix="") -> list:
    """(path, leaf) of every tensor leaf of a dict/list/dataclass tree."""
    if isinstance(node, torch.Tensor):
        return [(prefix, node)]
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _paths(node[k],
                                                        f"{prefix}/{k}")]
    if isinstance(node, (list, tuple)):
        return [p for i, v in enumerate(node)
                for p in _paths(v, f"{prefix}/{i}")]
    if hasattr(node, "__dataclass_fields__"):
        return [p for k in node.__dataclass_fields__
                for p in _paths(getattr(node, k), f"{prefix}/{k}")]
    return []


def decode_state_specs(state, mesh) -> list:
    """(path, spec) of every leaf of a decode state, by role."""
    return [(path, shrules.logical_to_mesh_axes(
        cache_logical(path, x.ndim), mesh=mesh, shape=x.shape))
        for path, x in _paths(state)]


def param_specs(cfg, mesh, params=None, axes=None) -> list:
    """(path, global shape, spec) of every parameter leaf, the specs
    shape-aware (``param_shardings(axes, mesh, like=params)``)."""
    if params is None:
        params, axes = abstract_params(cfg)
    shardings = shrules.param_shardings(axes, mesh, like=params)
    return [(path, tuple(x.shape), s.spec) for (path, x), s in
            zip(_paths(params), tree.leaves(shardings))]


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             moment_dtype: str = "bfloat16", cfg=None, mesh=None,
             batch: Optional[int] = None,
             max_len: Optional[int] = None, costs: bool = True) -> dict:
    """One cell's per-device state bytes on a production mesh (or on
    ``mesh``, a mesh's shape, and of ``cfg`` in place of the arch's
    full config: what a training rank holds there).  A decode cell
    takes ``batch`` and ``max_len`` in place of the shape's, so its
    figure is a serve's of that geometry (what a rank of the sharded
    serving state holds).  With ``costs``, also :func:`roofline_cell`'s
    terms of the same cell (counted in a child process): ``per_device``
    FLOPs, bytes accessed and collective bytes, ``roofline_seconds``,
    ``bottleneck``, ``layout`` and ``data_ranks``."""
    ok, why = configs.applicable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    cfg = cfg or configs.get_config(arch)
    sh = configs.SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    params, axes = abstract_params(cfg)
    dtypes = {path: x.dtype for path, x in _paths(params)}
    per_device = {"params": 0, "optimizer": 0, "caches": 0, "inputs": 0}
    pspecs = param_specs(cfg, mesh, params, axes)
    leaves = []
    for path, shape, spec in pspecs:
        local = shrules.shard_shape(shape, spec, mesh)
        per_device["params"] += _nbytes(local, dtypes[path])
        leaves.append({"path": path, "shape": shape, "spec": spec,
                       "shard": local})
    if sh.kind == "train":
        # AdamW's moments take their parameter's spec; its step is one
        # replicated scalar
        opt = adamw_init(params, moment_dtype)
        per_device["optimizer"] += _nbytes((), opt.step.dtype)
        for moments in (opt.mu, opt.nu):
            for (_, x), (_, _, spec) in zip(_paths(moments), pspecs):
                per_device["optimizer"] += _nbytes(
                    shrules.shard_shape(x.shape, spec, mesh), x.dtype)
    specs = configs.input_specs(arch, shape_name, cfg)
    if sh.kind == "train":
        inputs = specs["batch"]
    elif sh.kind == "prefill":
        inputs = specs
    else:
        inputs = {}
    for x in inputs.values():
        spec = shrules.logical_to_mesh_axes(
            ("batch",) + (None,) * (x.ndim - 1), mesh=mesh, shape=x.shape)
        per_device["inputs"] += _nbytes(
            shrules.shard_shape(x.shape, spec, mesh), x.dtype)
    if (batch is not None or max_len is not None) and sh.kind != "decode":
        raise ValueError(f"{shape_name}: batch= and max_len= are a decode "
                         "cell's")
    if sh.kind != "train" and arch not in configs.ENCODER_ONLY:
        b = sh.global_batch if sh.kind == "prefill" else specs["batch"]
        state = init_decode_state(cfg, batch or b, max_len or sh.seq_len,
                                  cfg.torch_dtype(), device="meta")
        for (path, x), (_, spec) in zip(_paths(state),
                                        decode_state_specs(state, mesh)):
            per_device["caches"] += _nbytes(
                shrules.shard_shape(x.shape, spec, mesh), x.dtype)
    total = sum(per_device.values())
    out = {"arch": arch, "shape": shape_name, "kind": sh.kind,
           "mesh": "x".join(str(n) for n in mesh.devices.shape),
           "devices": mesh.size,
           "n_params": sum(math.prod(x.shape) for x in tree.leaves(params)),
           "per_device_bytes": per_device,
           "per_device_state_bytes": total,
           "device_bytes": H100_BYTES,
           "fits_device": total <= H100_BYTES,
           "not_proven": ["activation peak", "collective bytes", "FLOPs"],
           "leaves": leaves}
    if costs:
        out.update(_cost_terms(roofline_cell(
            arch, shape_name, multi_pod=multi_pod,
            moment_dtype=moment_dtype, cfg=cfg, mesh=mesh, batch=batch,
            seq=max_len)))
        out["not_proven"] = ["activation peak"]
    return out


_COST_KEYS = ("per_device", "roofline_seconds", "bottleneck", "layout",
              "data_ranks", "kernels", "count_seconds")


def _cost_terms(r: dict) -> dict:
    return {k: r[k] for k in _COST_KEYS}


# ---------------------------------------------------------------------------
# the roofline: rank 0's program counted on the meta device
# ---------------------------------------------------------------------------

def _mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def _like(x: torch.Tensor, device) -> torch.Tensor:
    """A meta input on ``device``: itself on meta, zeros elsewhere (a
    valid token id, a finite embedding)."""
    if torch.device(device).type == "meta":
        return x
    return torch.zeros(x.shape, dtype=x.dtype, device=device)


def _data_ranks(mesh) -> int:
    return math.prod(mesh.axis_size(a) for a in shrules.data_axes(mesh))


def rank_program(arch: str, shape_name: str, *, cfg=None,
                 mesh_shape: Sequence[int] = (16, 16),
                 axes: Sequence[str] = ("data", "model"), device="meta",
                 flags: Optional[Sequence[str]] = None,
                 batch: Optional[int] = None, seq: Optional[int] = None,
                 moment_dtype: str = "bfloat16") -> dict:
    """Rank 0's program of a cell, counted (``cost_analysis.count``):
    this process is a rank of a running process group of
    ``prod(mesh_shape)`` ranks (a fake one on ``meta``, or real gloo
    ranks on the CPU, each calling it).  ``batch``/``seq``: the global
    batch and sequence (a decode cell's cache ``max_len``) in place of
    the shape's; ``flags``: the config flags of a serving cell's layout
    (default: the config's own decode flag, else ``distributed_decode``).
    Returns the count's result with
    ``layout`` (what the rank ran) and ``data_ranks`` (the ranks of the
    mesh's data axes)."""
    cfg = cfg or configs.get_config(arch)
    sh = configs.SHAPES[shape_name]
    b = batch or sh.global_batch
    s = seq or sh.seq_len
    sh = dataclasses.replace(sh, global_batch=b, seq_len=s)
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator().manual_seed(0)
    mesh = mesh_over_ranks(tuple(mesh_shape), tuple(axes), device=dev)
    if sh.kind == "train":
        return _train_program(cfg, mesh, sh, dev, gen, moment_dtype, arch)
    if flags is None:               # the config's own flag, else JAX's
        flags = () if cfg.distributed_decode or cfg.head_parallel_decode \
            else DEFAULT_FLAGS
    cfg = dataclasses.replace(cfg, **{f: True for f in flags})
    return _serve_program(cfg, mesh, sh, dev, gen, arch)


def _model_blocks(cfg, mesh) -> str:
    """Which of the model axis's logical dims a training layout on
    ``mesh`` splits over "model", which it splits in some leaves and
    leaves whole in others (named by their key), and which stay whole
    (they do not divide)."""
    rules = shrules.DEFAULT_RULES
    params, axes = abstract_params(cfg)
    split, whole = {}, {}
    for (path, _, spec), ax in zip(param_specs(cfg, mesh, params, axes),
                                   tree.leaves(axes, is_leaf=shrules.is_axes)):
        key = path.rsplit("/", 1)[1]
        for name, entry in zip(ax, spec):
            if name is not None and rules.get(name) == "model":
                (split if "model" in shrules.spec_axes(entry)
                 else whole).setdefault(name, set()).add(key)
    text = ", ".join(
        name + (f" (whole in {', '.join(sorted(whole[name]))})"
                if name in whole else "")
        for name in sorted(split)) or "nothing"
    rest = sorted(set(whole) - set(split))
    return text + (f" (whole: {', '.join(rest)})" if rest else "")


def _train_program(cfg, mesh, sh, dev, gen, moment_dtype, arch) -> dict:
    fsdp = train_step_mod.fsdp_layout(cfg, mesh)
    params = fsdp.init(cfg, gen, dev) if fsdp is not None \
        else init_params(cfg, gen, dev)
    state = train_step_mod.init_train_state(
        None, cfg, moment_dtype=moment_dtype, device=dev, params=params)
    held = {"params": held_bytes(state.params),
            "optimizer": held_bytes(state.opt)}
    batch = {k: _like(v, dev) for k, v in configs.input_specs(
        arch, sh.name, cfg, sh)["batch"].items()}
    with shrules.set_rules_for_mesh(mesh), cost_analysis.count() as c:
        train_step_mod.train_step(state, batch, cfg, lr=1e-4)
    n = _data_ranks(mesh)
    model = mesh.size // n
    layout = (f"train_step on FSDP blocks over {n} data ranks, rank 0's "
              f"{sh.global_batch // n} of {sh.global_batch} rows of "
              f"{sh.seq_len}, remat {cfg.remat}, {moment_dtype} moments")
    if model > 1:
        layout += (f"; over the {model} ranks of its model axis: "
                   f"{_model_blocks(cfg, mesh)}")
    return dict(c.result(), layout=layout, data_ranks=n, held=held)


def _serve_program(cfg, mesh, sh, dev, gen, arch) -> dict:
    dt = cfg.torch_dtype()
    flag = "distributed_decode" if cfg.distributed_decode \
        else "head_parallel_decode"
    with shrules.set_rules_for_mesh(mesh):
        layout = sl.serving_layout(cfg, mesh, max_len=sh.seq_len)
        params = layout.init(cfg, gen, dev) if layout is not None \
            else init_params(cfg, gen, dev)
        where = "the sharded serving state" if layout is not None \
            else "whole weights"
        n = _data_ranks(mesh)
        if sh.kind == "decode":
            state = init_decode_state(cfg, sh.global_batch, sh.seq_len, dt,
                                      device=dev, fsdp=layout)
            with cost_analysis.count() as c:
                engine.decode_step(params, cfg, state, fsdp=layout)
            rows = sh.global_batch if layout is None else \
                sl.batch_block(layout, sh.global_batch)[1]
            text = (f"decode_step on {where} under {flag}, rank 0's "
                    f"{rows} of {sh.global_batch} rows over a cache of "
                    f"{sh.seq_len} columns, every column valid")
            return dict(c.result(), layout=text, data_ranks=n)
        requests = max(1, sh.global_batch // n)
        if arch in configs.ENCODER_ONLY:
            emb = configs.input_specs(arch, sh.name, cfg, sh)["embeds"]
            embeds = _like(emb[:requests], dev)
            with torch.no_grad(), cost_analysis.count() as c:
                tf.forward(params, cfg, None, embeds, fsdp=layout)
            text = (f"forward on {where}, rank 0's {requests} of "
                    f"{sh.global_batch} rows of {sh.seq_len} embeds")
            return dict(c.result(), layout=text, data_ranks=n)
        state = init_decode_state(cfg, 1, sh.seq_len, dt, device=dev,
                                  fsdp=layout)
        tokens = _like(torch.empty((1, sh.seq_len), dtype=torch.int32,
                                   device="meta"), dev)
        with cost_analysis.count() as c:
            engine.prefill(params, cfg, tokens, state, fsdp=layout)
        text = (f"prefill on {where} under {flag}: rank 0's {requests} of "
                f"{sh.global_batch} requests, each a B=1 prefill of "
                f"{sh.seq_len} tokens (counted once, times {requests})")
        return dict(_times(c.result(), requests), layout=text,
                    data_ranks=n)


def _times(r: dict, n: int) -> dict:
    """A count's result for ``n`` identical calls."""
    return dict(r, flops=r["flops"] * n,
                bytes_accessed=r["bytes_accessed"] * n,
                collective_bytes={k: v * n for k, v in
                                  r["collective_bytes"].items()},
                kernels={k: v * n for k, v in r["kernels"].items()})


def _count_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               moment_dtype: str = "bfloat16", cfg=None, mesh=None,
               flags: Optional[Sequence[str]] = None,
               batch: Optional[int] = None,
               seq: Optional[int] = None) -> dict:
    """:func:`roofline_cell` in this process, which must run no process
    group: rank 0's program on the meta device inside a fake world of
    the mesh's size (``launch.mesh.fake_world``)."""
    ok, why = configs.applicable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    with fake_world(mesh.size):
        r = rank_program(arch, shape_name, cfg=cfg, mesh_shape=mesh.shape,
                         axes=mesh.axis_names, device="meta", flags=flags,
                         batch=batch, seq=seq, moment_dtype=moment_dtype)
    flops, byts = r["flops"], r["bytes_accessed"]
    coll = r["collective_bytes"]
    rt = {"compute": flops / HW["peak_flops"],
          "memory": byts / HW["hbm_bw"],
          "collective": coll["total"] / HW["link_bw"]}
    return {"arch": arch, "shape": shape_name,
            "kind": configs.SHAPES[shape_name].kind,
            "mesh": _mesh_name(mesh.shape), "devices": mesh.size,
            "per_device": {"flops": flops, "bytes_accessed": byts,
                           "collective_bytes": coll},
            "roofline_seconds": rt, "bottleneck": max(rt, key=rt.get),
            "layout": r["layout"], "data_ranks": r["data_ranks"],
            "kernels": r["kernels"],
            "count_seconds": time.perf_counter() - t0,
            **({"held": r["held"]} if "held" in r else {})}


def _count_cells(cells: list) -> list:
    """:func:`_count_cell` of each (args, kwargs) in ``cells``, an error
    recorded (and the rest counted) where one raises."""
    out = []
    for args, kw in cells:
        try:
            out.append(_count_cell(*args, **kw))
        except Exception as e:          # reported per cell by the caller
            out.append({"arch": args[0], "shape": args[1],
                        "error": f"{type(e).__name__}: {e}"})
    return out


def roofline_cells(cells: list) -> list:
    """:func:`_count_cell` of every (args, kwargs) of ``cells`` in one
    child process (no fake process group outlives it); a cell that
    fails carries ``error``."""
    meshes = []
    for args, kw in cells:
        mesh = kw.get("mesh")
        if mesh is not None:
            # a shape-only mesh crosses the process boundary as its axes
            # and shape
            kw = dict(kw, mesh=Mesh(mesh.axis_names, mesh.shape))
        meshes.append((args, kw))
    return in_child(_count_cells, meshes, timeout=600 + 300 * len(cells))


def roofline_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  moment_dtype: str = "bfloat16", cfg=None, mesh=None,
                  flags: Optional[Sequence[str]] = None,
                  batch: Optional[int] = None,
                  seq: Optional[int] = None) -> dict:
    """The roofline terms of one cell (JAX's ``roofline_cell``'s keys,
    but ``scan_trips``): ``per_device`` FLOPs, bytes accessed and
    collective bytes by op, ``roofline_seconds`` (compute, memory,
    collective) on the H100's rates (:data:`HW`) and ``bottleneck``;
    with ``layout`` (what rank 0 ran), ``data_ranks`` (the ranks of the
    mesh's data axes; every cell's ranks each run their own blocks, so
    its mesh does rank 0's work times every rank, whatever it repeats:
    a dim whole on "model"),
    ``kernels`` (closed-form kernel calls counted),
    ``count_seconds`` and, for a train cell, ``held`` (rank 0's
    parameter and optimizer bytes).  Counted in a child process
    (:func:`roofline_cells`); raises RuntimeError where it fails."""
    r = roofline_cells([((arch, shape_name), dict(
        multi_pod=multi_pod, moment_dtype=moment_dtype, cfg=cfg, mesh=mesh,
        flags=flags, batch=batch, seq=seq))])[0]
    if "error" in r:
        raise RuntimeError(f"{arch} x {shape_name}: {r['error']}")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=configs.list_archs())
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="also count rank 0's program of every cell on "
                         "the meta device (FLOPs, bytes accessed, "
                         "collective bytes) and its roofline seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        # every arch, of one shape where --shape names it
        cells = [(a, s) for a, s, _, _ in configs.cells()
                 if args.shape in (None, s)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    runs = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    counted = {}
    if args.roofline:
        todo = [(a, s, mp) for a, s, mp in runs
                if configs.applicable(a, s)[0]]
        counted = dict(zip(todo, roofline_cells(
            [((a, s), {"multi_pod": mp}) for a, s, mp in todo])))
    results = []
    for arch, shape, mp in runs:
        tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
        r = run_cell(arch, shape, multi_pod=mp, costs=False)
        c = counted.get((arch, shape, mp))
        if c is not None and "error" in c:
            r = {"arch": arch, "shape": shape, "mesh": r["mesh"],
                 "error": c["error"]}
            print(f"[FAIL] {tag}: {c['error'][:300]}", flush=True)
        elif "skipped" in r:
            print(f"[skip] {tag}: {r['skipped']}", flush=True)
        else:
            pd = r["per_device_bytes"]
            print(f"[ok]   {tag}: state/device "
                  f"{r['per_device_state_bytes'] / 1e9:.3f} GB "
                  f"(params {pd['params'] / 1e9:.3f}, optimizer "
                  f"{pd['optimizer'] / 1e9:.3f}, caches "
                  f"{pd['caches'] / 1e9:.3f}, inputs "
                  f"{pd['inputs'] / 1e9:.3f}) of the H100's "
                  f"{H100_BYTES / 1e9:.0f} GB: fits="
                  f"{r['fits_device']}", flush=True)
            if c is not None:
                r.update(_cost_terms(c))
                r["not_proven"] = ["activation peak"]
                rt = r["roofline_seconds"]
                print(f"       flops/dev {r['per_device']['flops']:.4e} "
                      f"bytes/dev {r['per_device']['bytes_accessed']:.4e} "
                      f"collective/dev "
                      f"{r['per_device']['collective_bytes']['total']:.4e}"
                      f" bottleneck {r['bottleneck']} (c={rt['compute']:.4f}"
                      f"s m={rt['memory']:.4f}s n={rt['collective']:.4f}s; "
                      f"counted in {r['count_seconds']:.1f}s)", flush=True)
        results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=list)
        print(f"wrote {args.out}")
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-pod dry-run of the port: the sharding rules' layout of every
cell's state on the production meshes, and whether it fits a card.

The JAX package's ``launch/dryrun.py`` compiles every (arch x input
shape) cell for 512 forced devices and reads the compiler's memory
analysis, cost analysis and the collective bytes of the HLO.  The port
cannot compile for a mesh it does not have.  Its dry-run instead, for
every cell on the single-pod (16, 16) and multi-pod (2, 16, 16)
production meshes (shapes only, no processes):

* builds the cell's parameters, its AdamW state (train cells) and its
  decode caches (prefill and decode cells) on the ``meta`` device (shapes
  and dtypes, no storage);
* resolves each leaf's spec with the port's rules
  (``sharding.param_shardings``, shape-aware; caches by their role, as
  the JAX dry-run's ``decode_state_shardings``) and its shard shape;
* sums the per-device bytes of that state and holds them to one H100's
  80 GB of memory.

What it proves: the rules' layout of the state (every leaf's spec and
shard shape, each dim dividing its mesh axes), and whether that state
fits per device.  What it does not prove: the activation peak, the
collective bytes and the FLOPs, which need a compiler for the mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out build/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional

import torch

from repro_torch import configs, tree
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.weights import init_params, param_axes
from repro_torch.optim import adamw_init
from repro_torch.serve.engine import init_decode_state
from repro_torch.serve.layout import cache_logical
from repro_torch.sharding import rules as shrules

#: one NVIDIA H100 SXM's device memory (NVIDIA's data sheet)
H100_BYTES = 80e9


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
             max_len: Optional[int] = None) -> dict:
    """One cell's per-device state bytes on a production mesh (or on
    ``mesh``, a mesh's shape, and of ``cfg`` in place of the arch's
    full config: what a training rank holds there).  A decode cell
    takes ``batch`` and ``max_len`` in place of the shape's, so its
    figure is a serve's of that geometry (what a rank of the sharded
    serving state holds)."""
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
    return {"arch": arch, "shape": shape_name, "kind": sh.kind,
            "mesh": "x".join(str(n) for n in mesh.devices.shape),
            "devices": mesh.size,
            "n_params": sum(math.prod(x.shape) for x in tree.leaves(params)),
            "per_device_bytes": per_device,
            "per_device_state_bytes": total,
            "device_bytes": H100_BYTES,
            "fits_device": total <= H100_BYTES,
            "not_proven": ["activation peak", "collective bytes", "FLOPs"],
            "leaves": leaves}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=configs.list_archs())
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a, s, _, _ in configs.cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            r = run_cell(arch, shape, multi_pod=mp)
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            if "skipped" in r:
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
            results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=list)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

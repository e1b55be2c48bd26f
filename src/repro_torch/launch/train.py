"""Training entry point of the port: data pipeline -> train step ->
checkpoint, on the card by default (a copy of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --steps 20 --batch 8 --seq 128 --device cpu

``--mesh`` trains on a data mesh, as the JAX launcher's
``make_host_mesh(data=len(jax.devices()))`` does (``train_loop(mesh=)``
takes any (data, model) mesh, as JAX's ``build(mesh=)``): one rank per
device the host exposes (``torch.cuda.device_count()``; on the CPU the
``--ranks`` the caller passes, where JAX's tests force host devices),
each holding its FSDP blocks of the training state (JAX's
``param_shardings`` placement, drawn as blocks) and running its block
of every batch's rows (``train/step.py``).  Rank 0 logs; a checkpoint
gathers the blocks leaf by leaf, rank 0 alone keeping and writing the
global tensors, so its format is the single-rank one, and a restore
takes each rank's blocks back (``restore(shardings=)``).

Every arch trains (``configs.list_archs()``, as the JAX launcher takes
it), on token batches as the JAX launcher does: the encoder
hubert-xlarge non-causal with ``targets = tokens``, the VLM internvl2-2b
on text alone (its patch-embedding batches go through ``train.step``
directly), the Mixture-of-Experts stacks (phi3.5-moe, deepseek-v3,
jamba) with their load-balance and z-loss terms added to the loss, and
the Mamba-2 layers (mamba2-130m, jamba's) through the plain SSD scan,
which ``kernels.ops.ssd`` takes under autograd (the kernel has no
backward, nor has the JAX package's ssd_scan kernel, and JAX trains
through its lax scan).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenDataset, make_batch_iterator
from repro_torch.models.common import resolve_device
from repro_torch.models.weights import init_params
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.runtime import StepTimer
from repro_torch.sharding import set_rules_for_mesh
from repro_torch.train import step as train_mod


def build(cfg, *, batch: int, seq: int, lr: float, steps: int,
          moment_dtype="float32", grad_compression=False, microbatches=1,
          seed=0, structured_data=True, device="cuda", params=None,
          mesh=None):
    """(state, step_fn, dataset).  Weights are drawn from a generator
    seeded with ``seed`` on ``device`` unless ``params`` are given.
    Under a (data, model) ``mesh`` the state is this rank's blocks
    (``train.step.fsdp_layout``: FSDP over the data axes and the
    model-axis blocks of every stack): random weights are drawn as
    blocks, each slice cut as it is drawn (the single rank's draws);
    given ``params`` are sliced; the moments are made as blocks."""
    dev = resolve_device(device)
    fsdp = train_mod.fsdp_layout(cfg, mesh)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = (init_params(cfg, gen, dev) if fsdp is None
                  else fsdp.init(cfg, gen, dev))
    elif fsdp is not None:
        params = fsdp.place(params)
    state = train_mod.init_train_state(
        None, cfg, moment_dtype=moment_dtype,
        grad_compression=grad_compression, device=dev, params=params)
    sched = cosine_schedule(lr, warmup_steps=max(steps // 20, 1),
                            total_steps=steps)
    step_fn = functools.partial(train_mod.train_step, cfg=cfg, lr=sched,
                                microbatches=microbatches)
    ds = SyntheticTokenDataset(cfg.vocab_size, seq, batch, seed=seed,
                               structured=structured_data)
    return state, step_fn, ds


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float,
               ckpt_dir=None, checkpoint_every=50, log_every=10,
               on_step=None, mesh=None, **kw):
    """Train ``steps`` steps; returns (state, losses).  ``on_step(step,
    metrics, seconds)`` (optional) sees each step's metrics and its time
    on the host clock, the device synchronised.  ``mesh``: train under
    it, any (data, model) mesh of the running ranks, as JAX's
    ``build(mesh=)`` takes one (FSDP over its data axes, tensor
    parallelism over "model"; every rank of it calls
    this, and the state returned is this rank's blocks); rank 0 alone
    logs and writes checkpoints.  Keyword arguments go to
    :func:`build`."""
    state, step_fn, ds = build(cfg, batch=batch, seq=seq, lr=lr,
                               steps=steps, mesh=mesh, **kw)
    dev = state.opt.step.device
    lead = mesh is None or mesh.rank == 0
    fsdp = train_mod.fsdp_layout(cfg, mesh)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        state, extras = ckpt.restore(
            state, shardings=None if fsdp is None
            else train_mod.state_shardings(state, fsdp))
        start = extras["next_step"]
        print(f"resumed from step {start}")
    timer = StepTimer()
    it = make_batch_iterator(ds, start_step=start)
    losses = []
    try:
        for step, rows in it:
            if step >= steps:
                break
            timer.start()
            batch_tree = {"tokens": torch.from_numpy(rows).long().to(dev)}
            with (set_rules_for_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                state, metrics = step_fn(state, batch_tree)
            loss = float(metrics["loss"])        # waits for the step
            straggler = timer.stop()
            losses.append(loss)
            if on_step is not None:
                on_step(step, metrics, timer.times[-1])
            if lead and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}"
                      + (" [straggler]" if straggler else ""), flush=True)
            if ckpt and (step + 1) % checkpoint_every == 0:
                # FSDP: every rank gathers, leaf by leaf; rank 0 alone
                # keeps them, on the host
                whole = state if fsdp is None else train_mod.whole_state(
                    state, fsdp, device="cpu", keep=lead)
                if lead:
                    ckpt.save(step, whole, extras={"next_step": step + 1})
    finally:
        it.close()
        if ckpt:
            ckpt.wait()
    return state, losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers "
                         "(default: the config's)")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="AdamW moment dtype (bfloat16 halves their "
                         "memory)")
    ap.add_argument("--mesh", action="store_true",
                    help="FSDP on a data mesh of one rank per device")
    ap.add_argument("--ranks", type=int, default=None,
                    help="with --mesh on the CPU: the rank count "
                         "(on the card: torch.cuda.device_count())")
    ap.add_argument("--init-file", default=None,
                    help="with --mesh: the file:// rendezvous file "
                         "(default: one under the checkout's build/)")
    return ap


def _rank_train(rank, device, cfg, loop_kw):
    """One data-parallel rank of :func:`main`: its losses."""
    mesh = make_host_mesh(data=torch.distributed.get_world_size(),
                          device=device)
    _, losses = train_loop(cfg, mesh=mesh, device=device, **loop_kw)
    return losses


def main(argv=None):
    """Parse ``argv``, train, print the summary; returns the losses."""
    args = parser().parse_args(argv)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    loop_kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                   lr=args.lr, ckpt_dir=args.ckpt_dir,
                   microbatches=args.microbatches,
                   moment_dtype=args.moment_dtype)
    t0 = time.time()
    if args.mesh:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            world = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(world)]
        else:
            if args.ranks is None:
                raise SystemExit("--mesh on the CPU needs --ranks")
            world, devices = args.ranks, ["cpu"] * args.ranks
        init_file = args.init_file or str(
            Path(__file__).resolve().parents[3] / "build" / "train_mesh_init")
        Path(init_file).parent.mkdir(parents=True, exist_ok=True)
        # one rank per card: NCCL; CPU ranks: gloo
        backend = "nccl" if dev.type == "cuda" else "gloo"
        losses = spawn(world, _rank_train, backend=backend, devices=devices,
                       init_file=init_file, args=(cfg, loop_kw),
                       timeout=24 * 3600)[0]
    else:
        _, losses = train_loop(cfg, device=args.device, **loop_kw)
    print(f"done: {len(losses)} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()

"""The port's multi-device decode against the JAX package's, on 2 gloo
ranks (``launch.mesh.spawn``) beside JAX on 2 forced host devices (a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``,
as tests/test_mesh_parity.py runs it):

* ``distributed_decode_attention`` and ``head_parallel_decode_attention``
  on ``mesh_for_cores(2)`` against JAX's within 5e-6, at mixed lengths
  (24, 7, 1 and 13 of 24 columns: the second shard sees rows 1 and 2
  empty), and on a (2, 1) mesh (the batch over data);
* the head-parallel and the sequence-sharded engines (the mesh-parity
  config, a serving plan, 6 steps) emit JAX's token streams, which equal
  the mesh-less engine's; the sharded path ran, and the plan's mesh
  downgrades and notes are JAX's strings;
* the refusals: heads or max_len that do not divide the axis (the
  sharded serving state's layout and cache), paged KV under a mesh
  path, ``mesh_for_cores`` on too few ranks.

Both decode functions take each rank's blocks (``mesh_ranks`` cuts them
from the global inputs), and both engines serve the sharded serving
state (``serve/layout.py``).

The ranks run ``torch.set_num_threads(1)``; every spawn joins within a
timeout and rendezvous through a file under ``tmp_path``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params_and_axes as jax_init
from repro.models.common import ModelConfig as JaxConfig

from repro_torch import lower
from repro_torch.launch import mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.launch.mesh_lowering import mesh_for_cores
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      init_decode_state, make_serving_plan)
from repro_torch.sharding import set_rules_for_mesh
from repro_torch.serve.layout import serving_layout

torch.set_num_threads(2)

TOL = 5e-6
SPAWN_TIMEOUT = 120
CFG = dict(name="mesh-parity", n_layers=2, d_model=32, n_heads=4,
           d_ff=64, vocab_size=64, n_kv_heads=2, attn_impl="reference",
           param_dtype="float32", compute_dtype="float32")
MAX_LEN, STEPS = 32, 6
PROMPTS = [(np.arange(5) % 60).tolist(), ((np.arange(9) * 7) % 60).tolist()]
FLAGS = ("head_parallel_decode", "distributed_decode")


def _decode_inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(q=rng.standard_normal((4, 4, 1, 16)).astype(f32),
                k=rng.standard_normal((4, 2, 24, 16)).astype(f32),
                v=rng.standard_normal((4, 2, 24, 16)).astype(f32),
                lengths=np.array([24, 7, 1, 13], np.int32),
                wo=(rng.standard_normal((4, 16, 32)) * 0.1).astype(f32))


JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.common import ModelConfig
from repro.models import init_params_and_axes
from repro.serve import ContinuousBatchingEngine, make_serving_plan
from repro.sharding import set_rules_for_mesh
from repro.launch.mesh_lowering import mesh_for_cores
from repro import lower
from repro.serve.distributed_decode import (distributed_decode_attention,
                                            head_parallel_decode_attention)

assert len(jax.devices()) == 2
inp, cfg_kw, prompts, max_len, steps, out_path = json.load(
    open(sys.argv[1]))
a = {k: np.asarray(v, np.int32 if k == "lengths" else np.float32)
     for k, v in inp.items()}
mesh = mesh_for_cores(2)
out = {}
with set_rules_for_mesh(mesh):
    out["dist"] = np.asarray(jax.jit(distributed_decode_attention)(
        a["q"], a["k"], a["v"], a["lengths"])).tolist()
    out["hp"] = np.asarray(jax.jit(head_parallel_decode_attention)(
        a["q"], a["k"], a["v"], a["lengths"], a["wo"])).tolist()

cfg = ModelConfig(**cfg_kw)
params, _ = init_params_and_axes(jax.random.PRNGKey(0), cfg)

def ledger(plans):
    rows = []
    for p in plans:
        rows += [["downgrade", d.reason, d.from_path, d.to_path]
                 for d in p.downgrades if "decode" in d.reason
                 and ("shard" in d.reason or "partial" in d.reason)]
        rows += [["note", n] for n in p.notes if "decode over axis" in n]
    return rows

def run(flag):
    c = dataclasses.replace(cfg, **{flag: True})
    lower.clear_plan_cache()
    plan = make_serving_plan(c, max_len)
    seen = {}                  # the ExecutionPlans, in first-use order
    resolve = plan._dispatch
    def record(*a, **kw):
        d = resolve(*a, **kw)
        seen.setdefault(id(d.plan), d.plan)
        return d
    plan._dispatch = record
    eng = ContinuousBatchingEngine(params, c, batch_size=2,
                                   max_len=max_len, plan=plan)
    for slot, p in enumerate(prompts):
        eng.begin_prefill(slot, np.asarray(p))
    toks = []
    for _ in range(steps):
        t, _ins = eng.step()
        toks.append(None if t is None else np.asarray(t).tolist())
    return {"tokens": toks, "ledger": ledger(seen.values())}

out["engine"] = {}
with set_rules_for_mesh(mesh):
    for flag in ("head_parallel_decode", "distributed_decode"):
        out["engine"][flag] = run(flag)
json.dump(out, open(out_path, "w"))
print("OK")
"""


def start_jax(tmp_path, script: str, args) -> tuple:
    """JAX's ``script`` started on 2 forced host devices: (the process,
    the path of the JSON it writes).  It reads ``args`` and that path
    from a JSON file (a command line holds too few bytes)."""
    out = tmp_path / "jax_out.json"
    arg = tmp_path / "jax_args.json"
    arg.write_text(json.dumps([*args, str(out)]))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.Popen([sys.executable, "-c", script, str(arg)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_jax(proc, out) -> dict:
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.read_text())


def _params_np():
    params, _ = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs on 2 forced host devices, the port's bodies on 2
    gloo ranks in one spawn: decode attention on (1, 2) and (2, 1)
    meshes, then each flag's engine), the two run side by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = _decode_inputs()
    proc, out = start_jax(tmp, JAX_SCRIPT, [
        {k: v.tolist() for k, v in inp.items()}, CFG, PROMPTS, MAX_LEN,
        STEPS])
    try:
        a = {k: torch.from_numpy(v) for k, v in inp.items()}
        args = (a["q"], a["k"], a["v"], a["lengths"], a["wo"])
        cfg, params = ModelConfig(**CFG), _params_np()
        calls = [(mesh_ranks.decode_attention, ((1, 2), *args)),
                 (mesh_ranks.decode_attention, ((2, 1), *args))]
        calls += [(mesh_ranks.serve_state,
                   (cfg, params, PROMPTS, MAX_LEN, STEPS, flag))
                  for flag in FLAGS]
        port = spawn(2, mesh_ranks.in_turn, backend="gloo",
                     devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                     args=(calls,), timeout=SPAWN_TIMEOUT)
    finally:
        ref = finish_jax(proc, out)
    return ref, port


@pytest.mark.parametrize("shape", [0, 1], ids=["1x2", "2x1"])
@pytest.mark.parametrize("path", ["dist", "hp"])
def test_decode_attention_matches_jax(runs, shape, path):
    jax_ref, port_runs = runs
    want = np.asarray(jax_ref[path], np.float32)
    for rank in range(2):
        got = port_runs[rank][shape][path].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < TOL, (rank, path)


def _meshless_tokens():
    cfg = ModelConfig(**CFG)
    params = params_from_numpy(_params_np(), cfg, device="cpu")
    lower.clear_plan_cache()
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=2, max_len=MAX_LEN,
        plan=make_serving_plan(cfg, MAX_LEN, device="cpu"), device="cpu")
    for slot, p in enumerate(PROMPTS):
        eng.begin_prefill(slot, p)
    return [None if t is None else np.asarray(t).tolist()
            for t, _ in (eng.step() for _ in range(STEPS))]


@pytest.mark.parametrize("flag", FLAGS)
def test_engine_tokens_and_ledger_match_jax(runs, flag):
    jax_ref, port_runs = runs
    want = jax_ref["engine"][flag]
    assert want["tokens"] == _meshless_tokens()
    for rank in range(2):
        got = port_runs[rank][2 + FLAGS.index(flag)]
        assert got["tokens"] == want["tokens"], rank
        assert got["calls"] >= STEPS - 1, "the sharded path never ran"
        assert [list(r) for r in got["ledger"]] == want["ledger"]
        assert any(r[0] == "note" for r in want["ledger"])


def test_refusals_before_any_collective():
    """Heads or max_len not dividing the axis, and paged KV, raise as
    JAX's ``shard_map`` and attention do (a shape-only (1, 2) mesh:
    nothing reaches a collective).  The decode functions take each
    rank's blocks, so the divisibility refusals are the sharded serving
    state's, on the global shapes: its layout (3 query heads, 1 KV
    head) and its cache (max_len 23)."""
    mesh = Mesh(("data", "model"), (1, 2))
    with set_rules_for_mesh(mesh):
        with pytest.raises(ValueError, match="heads divisible"):
            serving_layout(ModelConfig(**dict(
                CFG, n_heads=3, n_kv_heads=1, d_head=16,
                head_parallel_decode=True)))
        seq = ModelConfig(**dict(CFG, distributed_decode=True))
        with pytest.raises(ValueError, match="max_len 23"):
            init_decode_state(seq, 4, 23, device="cpu",
                              fsdp=serving_layout(seq))
        cfg = dataclasses.replace(ModelConfig(**CFG),
                                  head_parallel_decode=True)
        params = params_from_numpy(_params_np(), cfg, device="cpu")
        lp = params["layers"][0]["attn"]
        attn = {k: v[0] for k, v in lp.items()}
        pool = {"k": torch.zeros(4, 2, 16, 8), "v": torch.zeros(4, 2, 16, 8)}
        with pytest.raises(NotImplementedError, match="paged KV"):
            attn_mod.gqa_forward(
                attn, cfg, torch.zeros(2, 1, 32), torch.zeros(2, 1),
                cache=pool, cache_len=torch.tensor([3, 5]),
                block_tables=torch.ones(2, 2, dtype=torch.int32))


def test_mesh_for_cores_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="devices"):
        mesh_for_cores(2)

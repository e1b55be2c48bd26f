"""MLA's latent cache on the sharded serving state (``serve/layout.py``:
each rank holds its heads of ``wq_b``/``wk_b``/``wv_b``/``wo``, its
MLP columns and experts, and its time columns of the latent) on 2 gloo
ranks (``launch.mesh.spawn``, one spawn for the file) beside the JAX
package on 2 forced host devices (``start_jax``/``finish_jax`` of
tests/test_torch_mesh.py), from JAX's weights, on deepseek-v3's smoke
config (a dense prefix layer, then MoE layers with a shared expert):

* (a) for ``head_parallel_decode`` and ``distributed_decode`` on
  ``mesh_for_cores(2)``: prompts of 5 and 19 tokens prefilled in chunks
  of 8 (a later chunk reads a prefix split over the ranks' columns) and
  6 engine steps emit JAX's token streams;
* (b) every parameter and decode-state leaf a rank holds has the shape
  of JAX's shard for it (``param_shardings``,
  ``decode_state_shardings``), and its held bytes equal
  ``dryrun.run_cell(..., batch=, max_len=)``'s per-device figure;
* (c) a ``max_len`` of 33, which does not divide the 2 ranks: the latent
  stays whole on every rank, as JAX's shape-aware rule keeps it, and
  the tokens are still JAX's;
* (d) ``mla_forward`` on blocks alone against the whole layer within
  1e-5 in fp32: a chunk straddling both ranks' columns and a decode
  step where a row's prefix ends inside rank 0, whose gathers move the
  queries and never the latent.

The JAX script and the spawn's plumbing are shared with
tests/test_torch_serve_state_ssm.py.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import init_params_and_axes as jax_init
from repro.models.common import ModelConfig as JaxConfig

from repro_torch.launch import dryrun, mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.common import ModelConfig
from test_torch_mesh import finish_jax, start_jax

torch.set_num_threads(2)

TOL = 1e-5
MAX_LEN, STEPS, CHUNK = 32, 6, 8
PROMPTS = [(np.arange(5) % 60).tolist(), ((np.arange(19) * 7) % 60).tolist()]
FLAGS = ("head_parallel_decode", "distributed_decode")
#: the spawn's join timeout (every serve of a file in one spawn)
SPAWN_TIMEOUT = 170
ARCH = "deepseek-v3-671b"
#: (config, flag, max_len) of (a) and (c)
RUNS = [(ARCH, f, MAX_LEN) for f in FLAGS] + [(ARCH, FLAGS[1], 33)]


def cfg_kw(name, variants=None) -> dict:
    """A smoke config's fields by arch name, or a variant's of
    ``variants`` ({name: (arch, overrides)})."""
    if variants and name in variants:
        arch, over = variants[name]
        return dict(cfg_kw(arch), name=name, **over)
    return dataclasses.asdict(jax_configs.get_config(name, smoke=True))


def params_np(name, variants=None):
    params, _ = jax_init(jax.random.PRNGKey(0),
                         JaxConfig(**cfg_kw(name, variants)))
    return jax.tree.map(np.asarray, params)


def run_id(run) -> str:
    name, flag, max_len = run
    return f"{name}-{flag.split('_')[0]}-{max_len}"


#: JAX's engine on mesh_for_cores(2) for each (config, flag, max_len):
#: its tokens and each leaf's shard shape under JAX's layout (the
#: forward under jax.jit: eagerly each call compiles its layer scan)
JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import lower
from repro.launch.mesh_lowering import mesh_for_cores
from repro.models import init_params_and_axes
from repro.models import transformer as tf
from repro.models.common import ModelConfig
from repro.serve import ContinuousBatchingEngine, make_serving_plan
from repro.serve import engine as jax_engine
from repro.sharding import set_rules_for_mesh
from repro.sharding.rules import param_shardings

assert len(jax.devices()) == 2
# after the backend has its 2 devices: the module sets XLA_FLAGS for its
# 512 when imported
from repro.launch.dryrun import decode_state_shardings
runs, cfgs, prompts, steps, chunk, out_path = json.load(open(sys.argv[1]))

FORWARD, JIT = tf.forward, {}


def jitted(params, cfg, tokens=None, embeds=None, *, cache_len=None, **kw):
    static = not isinstance(cache_len, jax.Array)
    if static not in JIT:
        JIT[static] = jax.jit(FORWARD, static_argnames=(
            "cfg", "interpret", "return_aux", "plan")
            + (("cache_len",) if static else ()))
    return JIT[static](params, cfg, tokens, embeds, cache_len=cache_len, **kw)


tf.forward = jitted


def walk(node, prefix, out):
    if isinstance(node, dict):
        for k in sorted(node):
            walk(node[k], f"{prefix}/{k}", out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            walk(v, f"{prefix}/{i}", out)
    elif hasattr(node, "cache_len"):
        for k in ("cache", "cache_len", "last_token"):
            walk(getattr(node, k), f"{prefix}/{k}", out)
    else:
        out[prefix] = node
    return out


def shards(c, params, axes, mesh, hp, max_len):
    sh = walk(param_shardings(axes, mesh, like=params), "", {})
    out = {"params": {k: list(s.shard_shape(v.shape)) for (k, v), s in
                      zip(walk(params, "", {}).items(), sh.values())}}
    sds = jax.eval_shape(lambda: jax_engine.init_decode_state(
        c, 2, max_len, jnp.float32))
    specs = walk(decode_state_shardings(sds, mesh), "", {})
    state = {}
    for k, x in walk(sds, "", {}).items():
        s = specs[k]
        if hp and (k.endswith("/k") or k.endswith("/v")):
            # head_parallel_decode_attention's in-specs: batch, heads
            lead = (None,) * (len(x.shape) - 4)
            s = NamedSharding(mesh, P(*lead, "data", "model", None, None))
        state[k] = list(s.shard_shape(x.shape))
    out["state"] = state
    return out


out = {}
for name, flag, max_len in runs:
    cfg = ModelConfig(**cfgs[name])
    params, axes = init_params_and_axes(jax.random.PRNGKey(0), cfg)
    c = dataclasses.replace(cfg, **{flag: True})
    mesh = mesh_for_cores(2)
    lower.clear_plan_cache()
    plan = make_serving_plan(c, max_len)
    with set_rules_for_mesh(mesh):
        eng = ContinuousBatchingEngine(params, c, batch_size=2,
                                       max_len=max_len, plan=plan,
                                       prefill_chunk=chunk)
        for slot, p in enumerate(prompts):
            eng.begin_prefill(slot, np.asarray(p))
        toks = []
        for _ in range(steps):
            t, _ins = eng.step()
            toks.append(None if t is None else np.asarray(t).tolist())
    out[json.dumps([name, flag, max_len])] = {
        "tokens": toks,
        "shards": shards(c, params, axes, mesh,
                         flag == "head_parallel_decode", max_len)}
json.dump(out, open(out_path, "w"))
print("OK")
"""


def serve_calls(runs, variants=None) -> list:
    """``mesh_ranks.serve_state`` of each run, on JAX's weights."""
    weights = {}
    calls = []
    for name, flag, max_len in runs:
        if name not in weights:
            weights[name] = params_np(name, variants)
        calls.append((mesh_ranks.serve_state,
                      (ModelConfig(**cfg_kw(name, variants)),
                       weights[name], PROMPTS, max_len, STEPS, flag, None,
                       None, CHUNK)))
    return calls


def jax_and_port(tmp, runs, extra, variants=None) -> tuple:
    """(JAX's runs, the port's rank results: each run's
    ``serve_state``, then the ``extra`` calls), JAX and the spawn side by
    side."""
    names = {name for name, _, _ in runs}
    proc, out = start_jax(tmp, JAX_SCRIPT, [
        [list(r) for r in runs], {n: cfg_kw(n, variants) for n in names},
        PROMPTS, STEPS, CHUNK])
    try:
        port = spawn(2, mesh_ranks.in_turn, backend="gloo",
                     devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                     args=(serve_calls(runs, variants) + extra,),
                     timeout=SPAWN_TIMEOUT)
    finally:
        ref = finish_jax(proc, out)
    return ref, port


def key(run) -> str:
    return json.dumps(list(run))


def check_tokens(ref, port, runs, i) -> None:
    """(a): JAX's token streams on every rank, the flag's mesh path
    run where it has one."""
    want = ref[key(runs[i])]
    for rank in range(2):
        assert port[rank][i]["tokens"] == want["tokens"], rank


def check_shards(ref, port, runs, i, arch, variants=None) -> dict:
    """(b): every leaf's local shape is JAX's shard of it, and the
    rank's bytes are the dry-run's per-device figure for the serve's
    geometry.  Returns rank 0's local shapes."""
    name, flag, max_len = runs[i]
    want = ref[key(runs[i])]["shards"]
    cfg = dataclasses.replace(ModelConfig(**cfg_kw(name, variants)),
                              **{flag: True})
    cell = dryrun.run_cell(arch, "decode_32k", cfg=cfg,
                           mesh=Mesh(("data", "model"), (1, 2)), batch=2,
                           max_len=max_len, costs=False)["per_device_bytes"]
    for rank in range(2):
        got = port[rank][i]
        for part in ("params", "state"):
            assert {k: list(v) for k, v in got["shapes"][part].items()} \
                == want[part], (rank, part)
        assert got["held"] == {"params": cell["params"],
                               "caches": cell["caches"]}, rank
    return port[0][i]["shapes"]


def _alone_inputs():
    """(x, the latent prefix, start, x1, lengths) of (d): a chunk of 8 at
    12 (columns 12-19, both ranks') over a random latent in the first 12
    columns of 32, and a decode step of 2 rows whose prefixes end at 5
    (inside rank 0's columns 0-15) and 20."""
    cfg = ModelConfig(**cfg_kw(ARCH))
    rng = np.random.default_rng(4)
    f32 = np.float32
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    latent = rng.standard_normal((1, MAX_LEN, width)).astype(f32)
    latent[:, 12:] = 0.0
    t = torch.from_numpy
    return (t(rng.standard_normal((1, 8, cfg.d_model)).astype(f32)),
            t(latent), 12,
            t(rng.standard_normal((2, 1, cfg.d_model)).astype(f32)),
            torch.tensor([5, 20], dtype=torch.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_state_mla")
    alone = (mesh_ranks.mla_blocks_alone,
             (ModelConfig(**cfg_kw(ARCH)), params_np(ARCH),
              *_alone_inputs()))
    return jax_and_port(tmp, RUNS, [alone])


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[run_id(r) for r in RUNS])
def test_tokens_match_jax(runs, i):
    """(a), (c): JAX's token streams on every rank."""
    ref, port = runs
    check_tokens(ref, port, RUNS, i)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[run_id(r) for r in RUNS])
def test_blocks_are_jax_shards_and_dryrun_bytes(runs, i):
    """(b), (c): JAX's shard shapes and the dry-run's bytes; the heads
    of the up-projections and ``wo`` split, the latent's time columns
    split where max_len divides and whole where it does not."""
    ref, port = runs
    shapes = check_shards(ref, port, RUNS, i, ARCH)
    cfg = ModelConfig(**cfg_kw(ARCH))
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    max_len = RUNS[i][2]
    latent = {k: v for k, v in shapes["state"].items()
              if k.endswith("latent")}
    assert latent and all(
        v[-2:] == ((max_len // 2 if max_len % 2 == 0 else max_len), width)
        for v in latent.values())
    for leaf in ("wq_b", "wk_b", "wv_b"):
        got = shapes["params"][f"/prefix_layers/0/attn/{leaf}"]
        assert got[1] == cfg.n_heads // 2, leaf
    assert shapes["params"]["/prefix_layers/0/attn/wo"][0] \
        == cfg.n_heads // 2


def test_mla_forward_on_blocks_alone(runs):
    """(d): a chunk straddling both ranks' columns and a decode step
    whose row 0 ends inside rank 0 (rank 1's partial for it is zeroed):
    outputs and the latent after within 1e-5 of the whole layer's; the
    decode step gathers the queries over the heads and no latent
    columns, the chunk gathers the columns once."""
    _, port = runs
    for rank in range(2):
        got = port[rank][len(RUNS)]
        assert got["latent_block"][1] == MAX_LEN // 2
        for name in ("chunk", "decode"):
            for part in ("out", "cache"):
                a, b = got[name][part]
                assert a.shape == b.shape
                assert (a - b).abs().max().item() <= TOL, (rank, name, part)
        assert got["decode"]["gathers"] == [(None, "model")]
        assert got["chunk"]["gathers"] == [(None, None, "model")]

"""The sharded serving state of the port (``serve/layout.py``'s serving
layout: each rank holds its heads, MLP columns, vocabulary rows,
experts and cache slice) on 2 gloo ranks (``launch.mesh.spawn``, one
spawn for the file) beside the JAX package on 2 forced host devices
(``start_jax``/``finish_jax`` of tests/test_torch_mesh.py), from JAX's
weights:

* (a) on the mesh-parity config and on starcoder2-7b's and phi3.5-moe's
  smoke configs, for ``head_parallel_decode`` and ``distributed_decode``
  on ``mesh_for_cores(2)`` (phi3.5-moe with ``moe_shard_map_ep`` too,
  and head-parallel with ``moe_local_dispatch`` on prompts of 6 and 18
  tokens, whose chunks split over the ranks, as JAX's local dispatch
  needs): prompts of 5 and 19 tokens prefilled in chunks of 8 (a later
  chunk attends over a prefix split over the ranks' time columns) and 6
  engine steps emit JAX's token streams, and the plan's mesh ledger is
  JAX's strings; ``distributed_decode`` also on two mesh-parity
  variants whose head counts do not divide the 2 ranks, where JAX's
  rules keep those leaves whole: one KV head under 4 query heads (the
  query heads split, the KV heads whole) and 3 query heads over 1 with
  a vocabulary and MLP width of 63 (only the caches split);
* (b) every parameter and decode-state leaf a rank holds has the shape
  of JAX's spec's shard for it (``param_shardings``; the caches
  ``decode_state_shardings`` under ``distributed_decode``, the
  ``head_parallel_decode_attention`` in-specs under
  ``head_parallel_decode``), so no rank holds a whole leaf that JAX's
  layout shards, and its held bytes equal ``dryrun.run_cell(...,
  batch=, max_len=)``'s per-device figure to the byte;
* (c) a (2, 1) mesh: the batch over data, the ``embed`` blocks gathered
  at use; JAX's tokens on the same mesh, also across a preempt of both
  rows resumed in each other's slot (rows moved between the ranks);
* (d) the distributed prefill's all-to-all and the vocabulary-parallel
  lookup and logits alone, against the whole state without a mesh,
  within 1e-5 in fp32;
* (e) MLA, Mamba-2 and the hybrid now have a serving layout under
  either flag and none without one; the refusals of paged KV and of
  whole weights handed to the sharded engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import init_params_and_axes as jax_init
from repro.models.common import ModelConfig as JaxConfig

from repro_torch import configs, tree
from repro_torch.launch import dryrun, mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.common import ModelConfig
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      init_paged_decode_state)
from repro_torch.sharding import set_rules_for_mesh
from repro_torch.serve.layout import serving_layout
from test_torch_mesh import CFG, SPAWN_TIMEOUT, finish_jax, start_jax

torch.set_num_threads(2)

TOL = 1e-5
MAX_LEN, STEPS, CHUNK = 32, 6, 8
PROMPTS = [(np.arange(5) % 60).tolist(), ((np.arange(19) * 7) % 60).tolist()]
#: ``moe_local_dispatch``'s prompts: every chunk's tokens split over the
#: 2 ranks (JAX's fallback for those that do not recurses without end)
EVEN_PROMPTS = [(np.arange(6) % 60).tolist(),
                ((np.arange(18) * 7) % 60).tolist()]
FLAGS = ("head_parallel_decode", "distributed_decode")
EP = "moe_shard_map_ep"
LOCAL = "moe_local_dispatch"
PHI = "phi3.5-moe-42b-a6.6b"
#: mesh-parity with head counts that do not divide 2 ranks
VARIANTS = {"mesh-parity-mqa": dict(n_kv_heads=1),
            "mesh-parity-odd": dict(n_heads=3, n_kv_heads=1, d_head=16,
                                    d_ff=63, vocab_size=63)}
#: the configs of (a) by name: mesh-parity's, two smoke configs and the
#: variants
ARCHS = ("mesh-parity", "starcoder2-7b", PHI, *VARIANTS)
#: (config, flags, mesh shape or None for mesh_for_cores(2), swap_at)
RUNS = ([(a, (f,), None, None) for a in ARCHS[:3] for f in FLAGS]
        + [(PHI, (f, EP), None, None) for f in FLAGS]
        + [(PHI, (FLAGS[0], LOCAL), None, None)]
        + [(v, (FLAGS[1],), None, None) for v in VARIANTS]
        + [("mesh-parity", (f,), (2, 1), 3) for f in FLAGS])


def _cfg_kw(name) -> dict:
    if name == "mesh-parity":
        return dict(CFG)
    if name in VARIANTS:
        return dict(CFG, name=name, **VARIANTS[name])
    return dataclasses.asdict(jax_configs.get_config(name, smoke=True))


def _prompts(flags) -> list:
    return EVEN_PROMPTS if LOCAL in flags else PROMPTS


def _params_np(name):
    params, _ = jax_init(jax.random.PRNGKey(0), JaxConfig(**_cfg_kw(name)))
    return jax.tree.map(np.asarray, params)


def _id(run) -> str:
    name, flags, shape, swap = run
    return "-".join([name.split("-")[0]] + [f.split("_")[0] for f in flags]
                    + ([f"{shape[0]}x{shape[1]}"] if shape else []))


JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import lower
from repro.launch.mesh_lowering import mesh_for_cores
from repro.models import init_params_and_axes
from repro.models.common import ModelConfig
from repro.serve import ContinuousBatchingEngine, make_serving_plan
from repro.serve import engine as jax_engine
from repro.sharding import set_rules_for_mesh
from repro.sharding.rules import param_shardings

assert len(jax.devices()) == 2
# after the backend has its 2 devices: the module sets XLA_FLAGS for its
# 512 when imported
from repro.launch.dryrun import decode_state_shardings
runs, cfgs, prompts, max_len, steps, chunk, out_path = json.load(
    open(sys.argv[1]))


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


def ledger(plans):
    rows = []
    for p in plans:
        rows += [["downgrade", d.reason, d.from_path, d.to_path]
                 for d in p.downgrades if "decode" in d.reason
                 and ("shard" in d.reason or "partial" in d.reason)]
        rows += [["note", n] for n in p.notes if "decode over axis" in n]
    return rows


def shards(c, params, axes, mesh, hp):
    # each leaf's shard shape under JAX's layout, by path
    sh = walk(param_shardings(axes, mesh, like=params), "", {})
    out = {"params": {k: list(s.shard_shape(v.shape)) for (k, v), s in
                      zip(walk(params, "", {}).items(), sh.values())}}
    sds = jax.eval_shape(lambda: jax_engine.init_decode_state(
        c, 2, max_len, jnp.float32))
    specs = walk(decode_state_shardings(sds, mesh), "", {})
    leaves = walk(sds, "", {})
    state = {}
    for k, x in leaves.items():
        s = specs[k]
        if hp and (k.endswith("/k") or k.endswith("/v")):
            # head_parallel_decode_attention's in-specs: batch, heads
            lead = (None,) * (len(x.shape) - 4)
            s = NamedSharding(mesh, P(*lead, "data", "model", None, None))
        state[k] = list(s.shard_shape(x.shape))
    out["state"] = state
    return out


out = {}
for name, flags, shape, swap in runs:
    ps = prompts[1] if "moe_local_dispatch" in flags else prompts[0]
    cfg = ModelConfig(**cfgs[name])
    params, axes = init_params_and_axes(jax.random.PRNGKey(0), cfg)
    c = dataclasses.replace(cfg, **{f: True for f in flags})
    mesh = mesh_for_cores(2) if shape is None else mesh_for_cores(
        shape[1], data=shape[0])
    lower.clear_plan_cache()
    plan = make_serving_plan(c, max_len)
    seen = {}
    resolve = plan._dispatch

    def record(*a, **kw):
        d = resolve(*a, **kw)
        seen.setdefault(id(d.plan), d.plan)
        return d
    plan._dispatch = record
    with set_rules_for_mesh(mesh):
        eng = ContinuousBatchingEngine(params, c, batch_size=2,
                                       max_len=max_len, plan=plan,
                                       prefill_chunk=chunk)
        for slot, p in enumerate(ps):
            eng.begin_prefill(slot, np.asarray(p))
        toks = []
        for _ in range(steps):
            t, _ins = eng.step()
            toks.append(None if t is None else np.asarray(t).tolist())
    key = json.dumps([name, flags, shape])
    out[key] = {"tokens": toks, "ledger": ledger(seen.values())}
    if shape is None:
        out[key]["shards"] = shards(c, params, axes, mesh,
                                    "distributed_decode" not in flags)
json.dump(out, open(out_path, "w"))
print("OK")
"""


def _key(run) -> str:
    import json
    name, flags, shape, _ = run
    return json.dumps([name, list(flags), None if shape is None
                       else list(shape)])


def _pieces_inputs():
    """(x, the cache's K and V prefix, start, tokens) of (d) on the
    mesh-parity config: a chunk of 8 at 12 (its columns on both ranks)
    over random K/V in the first 12 columns."""
    cfg = ModelConfig(**CFG)
    rng = np.random.default_rng(3)
    f32 = np.float32
    kv = rng.standard_normal((2, 1, cfg.kv_heads, MAX_LEN, cfg.head_dim))
    kv[..., 12:, :] = 0.0
    return (torch.from_numpy(rng.standard_normal(
                (1, 8, cfg.d_model)).astype(f32)),
            tuple(torch.from_numpy(t.astype(f32)) for t in kv), 12,
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 7))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's runs on 2 forced host devices, the port's rank results:
    each of RUNS through ``serve_state``, then (d)'s pieces), the two
    run side by side."""
    tmp = tmp_path_factory.mktemp("serve_state")
    proc, out = start_jax(tmp, JAX_SCRIPT, [
        [list(r) for r in RUNS], {a: _cfg_kw(a) for a in ARCHS},
        [PROMPTS, EVEN_PROMPTS], MAX_LEN, STEPS, CHUNK])
    try:
        params = {a: _params_np(a) for a in ARCHS}
        calls = [(mesh_ranks.serve_state,
                  (ModelConfig(**_cfg_kw(name)), params[name],
                   _prompts(flags), MAX_LEN, STEPS, flags, shape, swap,
                   CHUNK))
                 for name, flags, shape, swap in RUNS]
        calls.append((mesh_ranks.sharded_pieces,
                      (ModelConfig(**CFG), params["mesh-parity"],
                       *_pieces_inputs())))
        port = spawn(2, mesh_ranks.in_turn, backend="gloo",
                     devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                     args=(calls,), timeout=SPAWN_TIMEOUT)
    finally:
        ref = finish_jax(proc, out)
    return ref, port


def _unswap(tokens, swap_at):
    """The token columns of the steps after a swap of the two rows put
    back in request order."""
    if swap_at is None:
        return tokens
    return tokens[:swap_at] + [None if t is None else t[::-1]
                               for t in tokens[swap_at:]]


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[_id(r) for r in RUNS])
def test_tokens_and_ledger_match_jax(runs, i):
    """(a), (c): JAX's token streams and mesh ledger on every rank."""
    ref, port = runs
    want = ref[_key(RUNS[i])]
    for rank in range(2):
        got = port[rank][i]
        assert _unswap(got["tokens"], RUNS[i][3]) == want["tokens"], rank
        assert got["calls"] >= STEPS - 1, "the mesh path never ran"
        assert [list(r) for r in got["ledger"]] == want["ledger"]
    assert any(r[0] == "note" for r in want["ledger"])


SHARDED = [i for i, r in enumerate(RUNS) if r[2] is None]


@pytest.mark.parametrize("i", SHARDED, ids=[_id(RUNS[i]) for i in SHARDED])
def test_blocks_are_jax_shards_and_dryrun_bytes(runs, i):
    """(b): every leaf's local shape is JAX's shard of it (so nothing JAX
    shards is whole, and a leaf whose dim does not divide is whole as
    JAX keeps it), the query projections cut exactly where their heads
    divide, and the rank's bytes are the dry-run's per-device figure for
    the serve's geometry."""
    ref, port = runs
    name, flags, _, _ = RUNS[i]
    want = ref[_key(RUNS[i])]["shards"]
    cfg = dataclasses.replace(ModelConfig(**_cfg_kw(name)),
                              **{f: True for f in flags})
    cell = dryrun.run_cell(
        "starcoder2-7b" if name.startswith("mesh-parity") else name,
        "decode_32k",
        cfg=cfg, mesh=Mesh(("data", "model"), (1, 2)), batch=2,
        max_len=MAX_LEN, costs=False)["per_device_bytes"]
    whole = _params_np(name)
    for rank in range(2):
        got = port[rank][i]
        for part in ("params", "state"):
            assert {k: list(v) for k, v in got["shapes"][part].items()} \
                == want[part], (rank, part)
        cut = [k for k, v in got["shapes"]["params"].items()
               if "/" in k and np.prod(v) < np.prod(
                   _leaf(whole, k).shape)]
        assert any("/wq" in k for k in cut) == (cfg.n_heads % 2 == 0)
        assert ("/embed" in cut) == (cfg.vocab_size % 2 == 0)
        assert got["held"] == {"params": cell["params"],
                               "caches": cell["caches"]}, rank
        assert sum(got["bytes"]["params"].values()) == got["held"]["params"]


def _leaf(tree_, path):
    for part in path.strip("/").split("/"):
        tree_ = tree_[int(part)] if isinstance(tree_, list) else tree_[part]
    return tree_


def test_prefill_all_to_all_and_vocab_alone(runs):
    """(d): the distributed prefill chunk over a prefix split over the
    ranks' time columns, and the vocabulary-parallel lookup and logits,
    against the whole state without a mesh within 1e-5 (fp32)."""
    _, port = runs
    for rank in range(2):
        got = port[rank][len(RUNS)]
        assert got["embed_rows"][0] == CFG["vocab_size"] // 2
        for name in ("attn", "logits"):
            a, b = got[name]
            assert a.shape == b.shape
            assert (a - b).abs().max().item() <= TOL, (rank, name)
        for a, b in got["cache"].values():
            assert (a - b).abs().max().item() <= TOL, rank
        a, b = got["lookup"]
        assert torch.equal(a, b), rank


SHAPE_ONLY = Mesh(("data", "model"), (1, 2))


@pytest.mark.parametrize("arch,what", [
    ("deepseek-v3-671b", "MLA"), ("mamba2-130m", "Mamba-2"),
    ("jamba-1.5-large-398b", "hybrid")])
@pytest.mark.parametrize("flag", FLAGS)
def test_unported_serving_states_refuse(arch, what, flag):
    """(e): the states that refused before the latent cache, the conv
    tail and the SSM state were laid out on a mesh now have a serving
    layout under either decode flag (their blocks:
    tests/test_torch_serve_state_mla.py and _ssm.py); with no decode
    flag the same mesh serves the whole state (no layout)."""
    cfg = configs.get_config(arch, smoke=True)
    with set_rules_for_mesh(SHAPE_ONLY):
        assert serving_layout(cfg) is None
        layout = serving_layout(dataclasses.replace(cfg, **{flag: True}))
        assert layout is not None and layout.serve, what


def test_paged_kv_and_whole_weights_refuse():
    """(e): paged KV under a mesh path, and whole weights handed to the
    sharded engine (no rank rebuilds a whole leaf), raise."""
    cfg = dataclasses.replace(ModelConfig(**CFG), head_parallel_decode=True)
    params = params_from_numpy(_params_np("mesh-parity"), cfg, device="cpu")
    with set_rules_for_mesh(SHAPE_ONLY):
        with pytest.raises(NotImplementedError, match="paged KV"):
            init_paged_decode_state(cfg, 2, MAX_LEN, num_pages=8,
                                    page_size=16, device="cpu")
        with pytest.raises(ValueError, match="each rank's blocks"):
            ContinuousBatchingEngine(params, cfg, batch_size=2,
                                     max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("arch,extra", [
    ("starcoder2-7b", ["--mesh", "dist"]),
    (PHI, ["--mesh", "hp"])], ids=["starcoder2-dist", "phi-hp"])
def test_launch_serve_on_two_ranks(tmp_path, arch, extra):
    """``launch.serve --mesh``: 2 gloo ranks draw their blocks of the
    single rank's seed-0 weights and serve the same requests to the same
    tokens as the single rank, each holding less than the whole
    state."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests",
            "3", "--max-len", "64", "--max-new", "6", "--prefill-chunk",
            "8"]
    args = serve.parser().parse_args(
        argv + extra + ["--init-file", str(tmp_path / "init")])
    got = serve._serve_on_mesh(args)
    one = serve.parser().parse_args(argv)
    cfg, params = serve.model_for(one)
    want = serve.run(one, cfg, params,
                     serve.make_requests(cfg, one.requests, one.max_new))
    assert sorted((u, g) for u, _, g in got["finished"]) == sorted(
        (r.uid, r.generated) for r in want["finished"])
    whole = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    assert 0 < got["held"]["params"] < whole

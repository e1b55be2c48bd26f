"""The dry-run's roofline (``launch/dryrun.py`` ``roofline_cell``): rank
0's program of a cell counted on the meta device under a fake process
group (``launch/cost_analysis.py``), and each kernel's closed-form cost
(``kernels/cost.py``):

* (a) starcoder2's smoke config (2 layers) on a (2, 2) data x model mesh,
  a train, a prefill and a decode cell at small shapes, the decode cell
  under each decode flag: the meta count
  of rank 0 in a child process equals rank 0's count of the same program
  on 4 real gloo CPU ranks (one spawn for the file), FLOPs, kernel calls
  and every collective key exactly, bytes accessed within 1% (both run
  the same aten ops; the CPU run also reads back the cache lengths the
  masked-kernel dispatch checks on the host);
* (b) the smoke train cell (remat none, the tensor-parallel layout)
  against closed forms summed here from the config's widths: its FLOPs
  (three times each forward product, and #7-#9's closed forms over the
  causal half, on the rank's half of the heads, MLP and vocabulary),
  and its collective bytes from the layout's specs (each use of a leaf
  gathers its model-axis block over "data" and all-reduces its fp32
  gradient; the residual stream's sequence all-gathers and
  reduce-scatters over "model" (``seq_stream``); the cross entropy's
  sums over "model"; the loss's means and the gradient norm's partial
  sums, fp32 scalars);
* (c) ``kernels/cost.py`` at PERF.md's main shapes gives its bound
  column to four digits, and on the meta device each wrapper and each
  plain version reports exactly its closed form, its plain body's ops
  adding nothing;
* (d) at full width on (16, 16): qwen3-8b's ``train_4k`` on the
  tensor-parallel layout, its FLOPs times the 256 ranks within 25% of
  ``benchmarks/roofline.py`` ``analytic_flops`` and its held parameter
  and optimizer bytes ``run_cell``'s, as are mamba2-130m's and those of
  deepseek-v3 cut to 4 layers (3 dense, 1 MoE) on their
  tensor-parallel layouts (one 256-token row a data rank); starcoder2-7b's
  ``decode_32k``'s FLOPs equal to the closed form
  of its layout (the projections of the 36 query and 4 KV heads whole on
  every rank, which the 16-way model axis does not divide; its 2048 of
  the cache's columns; a 16th of the MLP and the vocabulary);
  ``run_cell`` and ``main --roofline`` carry the same terms beside the
  state bytes they gave before, and JAX's ``roofline_cell`` keys but
  ``scan_trips``;
* (e) no process group is left in this process, and only
  ``launch/mesh.py`` imports the private ``fake_pg`` module.

The two full-width cells and the smoke cells are counted in one child
process.
"""

import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs, tree
from repro_torch.kernels import cost
from repro_torch.launch import cost_analysis, dryrun, mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.weights import init_params
from repro_torch.sharding import rules
from repro_torch.train.step import fsdp_layout
from test_torch_cuda import kernel_calls

ROOT = Path(__file__).resolve().parents[1]
ARCH = "starcoder2-7b"
SMOKE = configs.get_config(ARCH, smoke=True)
MESH = Mesh(("data", "model"), (2, 2))
#: the small cells of (a): name -> (shape, global batch, sequence or
#: max_len, the serving layout's decode flags: None for the default)
SMALL = {"train_4k": ("train_4k", 4, 64, None),
         "prefill_32k": ("prefill_32k", 4, 64, None),
         "decode_32k": ("decode_32k", 4, 64, None),
         "decode_32k hp": ("decode_32k", 4, 64, ("head_parallel_decode",))}
#: the full-width cells on (16, 16): (arch, shape)
FULL = (("qwen3-8b", "train_4k"), (ARCH, "decode_32k"))
#: full-width train cells on (16, 16) whose held bytes are checked:
#: name -> (arch, the config's changes), each at one row a data rank
#: of 256 tokens (the bytes held do not depend on the batch)
HELD = {"mamba2-130m": ("mamba2-130m", {}),
        "deepseek-v3 4 layers": ("deepseek-v3-671b", dict(n_layers=4))}


def _held_cfg(name):
    arch, kw = HELD[name]
    return dataclasses.replace(configs.get_config(arch), **kw)


@pytest.fixture(scope="module")
def meta():
    """Every cell of this file counted on meta, in one child process."""
    cells = [((ARCH, s), dict(cfg=SMOKE, mesh=MESH, batch=b, seq=n,
                              flags=f)) for s, b, n, f in SMALL.values()]
    cells += [(cell, {}) for cell in FULL]
    cells += [((arch, "train_4k"), dict(cfg=_held_cfg(name), batch=16,
                                        seq=256))
              for name, (arch, _) in HELD.items()]
    out = dryrun.roofline_cells(cells)
    for r in out:
        assert "error" not in r, r
    return dict(zip(list(SMALL) + [f"full {s}" for _, s in FULL]
                    + [f"held {name}" for name in HELD], out))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Rank 0's counts of the small cells on 4 gloo CPU ranks."""
    cells = [(ARCH, s, dict(cfg=SMOKE, mesh_shape=MESH.shape, batch=b,
                            seq=n, flags=f)) for s, b, n, f in SMALL.values()]
    tmp = tmp_path_factory.mktemp("roofline")
    out = spawn(4, mesh_ranks.roofline_cells, backend="gloo",
                devices=["cpu"] * 4, init_file=str(tmp / "init"),
                args=(cells,), timeout=150)
    return dict(zip(SMALL, out[0]))


@pytest.mark.parametrize("shape", list(SMALL))
def test_meta_count_equals_four_gloo_ranks(meta, gloo, shape):
    got, want = meta[shape], gloo[shape]
    assert got["per_device"]["flops"] == want["flops"]
    assert got["per_device"]["collective_bytes"] == want["collective_bytes"]
    assert got["kernels"] == want["kernels"]
    assert got["layout"] == want["layout"]
    rel = abs(got["per_device"]["bytes_accessed"] - want["bytes_accessed"]) \
        / want["bytes_accessed"]
    assert rel <= 0.01
    assert got["per_device"]["collective_bytes"]["total"] > 0


def _smoke_train_flops() -> int:
    """FLOPs of rank 0's smoke train step (remat none): every forward
    product three times (its forward, and its two backward products),
    and #7, #8 and #9's closed forms a layer, on the rank's model-axis
    blocks: a half of the heads, the KV heads, the MLP columns and the
    vocabulary, all of which divide the 2 ranks."""
    c = SMOKE
    _, b, s, _ = SMALL["train_4k"]
    m = MESH.shape[1]
    assert c.n_heads % m == c.kv_heads % m == c.d_ff % m == 0
    t = b // MESH.shape[0] * s                 # rank 0's tokens
    hd, q, kv = c.head_dim, c.n_heads * c.head_dim, c.kv_heads * c.head_dim
    layer = 2 * t * c.d_model * (2 * q + 2 * kv) // m + 2 * 2 * t \
        * c.d_model * c.d_ff // m
    forward = c.n_layers * layer + 2 * t * c.d_model * c.vocab_size // m
    ent = b // MESH.shape[0] * c.n_heads // m * s * (s + 1) // 2
    attn = (2 * 2 * hd + (4 * hd + 2 * hd) + 4 * 2 * hd) * ent
    return 3 * forward + c.n_layers * attn


def test_smoke_train_flops_equal_their_closed_form(meta):
    r = meta["train_4k"]
    assert SMOKE.remat == "none" and SMOKE.mlp == "gelu"
    assert r["kernels"] == {k: SMOKE.n_layers for k in (
        "fused_attention_fwd", "fused_attention_bwd_dq",
        "fused_attention_bwd_dkv")}
    assert r["per_device"]["flops"] == _smoke_train_flops()


def test_smoke_train_collective_bytes_equal_their_closed_form(meta):
    """On the tensor-parallel layout: each use of a leaf (a stacked
    leaf's period, once a layer) gathers its model-axis block over the
    data axis where its spec has the data axis, and its backward
    all-reduces the fp32 gradient of that block over the data axis; a
    leaf whole on the model axis (the norms) all-reduces its gradient's
    shares over "model" too.  The activations (``seq_stream``: the
    residual stream is each rank's half of the sequence): the
    embedding's rows and each layer's attention and MLP outputs
    reduce-scattered over "model" (forward; each sum's fp32 block) and
    their cotangents all-gathered (backward), each layer's two normed
    inputs and the final norm's output all-gathered (forward) and their
    cotangents reduce-scattered (backward); the cross entropy's row max
    (forward), exponential sums and target logits (forward and
    backward) summed over "model"; then three fp32 scalars (the loss's
    mean, forward and backward, and the z-loss's mean) and the gradient
    norm's partial sum of each leaf over each axis it is split on."""
    fsdp = fsdp_layout(SMOKE, MESH)
    params = init_params(SMOKE, None, "meta")
    _, b, s, _ = SMALL["train_4k"]
    gather = reduce = split = 0
    for key in params:
        for spec, x in zip(tree.leaves(fsdp.param_specs[key],
                                       is_leaf=lambda t: isinstance(t, tuple)),
                           tree.leaves(params[key])):
            named = {a for e in spec for a in rules.spec_axes(e)}
            block = x.numel() // (2 if "model" in named else 1)
            gather += block * x.element_size() if "data" in named else 0
            reduce += block * 4 * (1 if "model" in named else 2)
            split += len(named)
    rows = b // MESH.shape[0] * s
    m = MESH.shape[1]
    assert s % m == 0 and SMOKE.compute_dtype == "float32"
    # each direction: the embedding's, each layer's two sublayers' and
    # the final norm's, over the data rank's whole rows, fp32
    stream = 4 * rows * SMOKE.d_model * (2 + 4 * SMOKE.n_layers)
    want = {"all-gather": gather + stream,
            "all-reduce": reduce + 4 * rows * 5 + 4 * 3 + 4 * split,
            "reduce-scatter": stream // m, "all-to-all": 0,
            "collective-permute": 0}
    want["total"] = sum(want.values())
    assert meta["train_4k"]["per_device"]["collective_bytes"] == want


#: PERF.md's kernel table, main shapes: kernel -> (cost arguments,
#: keywords, its bound ms to four digits, bound by)
_PAGED = [301, 460, 612, 705]
_PAGES = sum(-(-n // 16) for n in _PAGED)
BOUND_COLUMN = {
    "fused_attention_masked": ((1, 36, 4, 256, 1024, 128, 128),
                               dict(lengths=[256]), 0.0016, "bytes"),
    "fused_qproj_attention_masked": ((1, 188, 4608, 36, 4, 1024, 128, 128),
                                     dict(lengths=[700]), 0.0141, "bytes"),
    "fused_decode_block": ((4, 4608, 36, 4, 1024, 128, 128),
                           dict(lengths=_PAGED), 0.0267, "bytes"),
    "fused_attention_paged": ((4, 32, 8, 1, 1024, 128, 128),
                              dict(lengths=_PAGED, table=_PAGES), 0.0026,
                              "bytes"),
    "fused_qproj_attention_paged": ((4, 1, 4608, 36, 4, 1024, 128, 128),
                                    dict(lengths=_PAGED, table=_PAGES),
                                    0.0140, "bytes"),
    "fused_decode_block_paged": ((4, 4608, 36, 4, 1024, 128, 128),
                                 dict(lengths=_PAGED, table=_PAGES), 0.0267,
                                 "bytes"),
    "fused_attention_fwd": ((2, 36, 4, 2048, 2048, 128, 128), {}, 0.0782,
                            "operations"),
    "fused_attention_bwd_dq": ((2, 36, 4, 2048, 2048, 128, 128), {}, 0.1173,
                               "operations"),
    "fused_attention_bwd_dkv": ((2, 36, 4, 2048, 2048, 128, 128), {},
                                0.1564, "operations"),
    "fused_qproj_attention_fwd": ((2, 2048, 4608, 36, 4, 2048, 128, 128),
                                  {}, 0.2541, "operations"),
    "ssd_scan": ((4, 2048, 24, 64, 1, 128, 128), {}, 0.0173, "bytes"),
}


@pytest.mark.parametrize("kernel", list(BOUND_COLUMN))
def test_closed_forms_give_the_bound_column(kernel):
    args, kw, ms, by = BOUND_COLUMN[kernel]
    got, got_by = cost.bound_ms(*cost.cost(kernel, *args, **kw))
    assert round(got, 4) == ms and got_by == by
    assert cost.bound_ms(*cost.cost(kernel, *args, **kw, el=4))[0] >= got


def test_causal_entries_closed_form_counts_each_row():
    """The clamped sums against a row by row count, anchored at the
    cache's end (lengths off and on the row count) and cache-free with
    an offset (a negative one too)."""
    for n, sq in [(0, 3), (2, 5), (5, 5), (700, 188), (9, 1)]:
        rows = sum(max(0, min(n, n - sq + r + 1)) for r in range(sq))
        assert cost.cached_work(sq, [n], True) == (rows, n)
    for sq, skv, off in [(7, 7, None), (4, 9, None), (9, 4, -2), (5, 6, 3)]:
        o = skv - sq if off is None else off
        rows = sum(min(skv, max(0, o + r + 1)) for r in range(sq))
        assert cost.train_entries(1, 1, sq, skv, True, off) == rows


@pytest.mark.parametrize("which", ["wrapper", "plain"])
@pytest.mark.parametrize("i", range(11))
def test_meta_calls_report_exactly_their_closed_form(i, which):
    name, mod, wrapper, plain, args, kw, shapes, skw = kernel_calls(
        torch.device("meta"))[i]
    fn = getattr(mod, wrapper if which == "wrapper" else plain)
    with torch.no_grad(), cost_analysis.count() as c:
        out = fn(*args, **kw)
    flops, nbytes = cost.cost(name, *shapes, **skw)
    got = c.result()
    assert (got["flops"], got["bytes_accessed"]) == (flops, nbytes)
    assert got["kernels"] == {name: 1}
    assert all(t.device.type == "meta" for t in tree.leaves(out))


def _analytic_flops(arch, shape):
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.analytic_flops(arch, shape)


def test_full_width_train_flops_within_a_quarter_of_analytic(meta):
    """qwen3-8b on the tensor-parallel layout: its heads, MLP and
    vocabulary divide the 16 ranks of "model", its 8 KV heads stay
    whole, and each rank projects only its query group's KV head, so
    the mesh's FLOPs are rank 0's times every rank."""
    c = configs.get_config("qwen3-8b")
    assert c.n_heads % 16 == c.d_ff % 16 == c.vocab_size % 16 == 0
    assert c.kv_heads % 16
    r = meta["full train_4k"]
    assert r["data_ranks"] == 16 and r["devices"] == 256
    assert "over the 16 ranks of its model axis: heads, mlp, vocab " \
        "(whole: kv_heads)" in r["layout"]
    ratio = r["per_device"]["flops"] * r["devices"] / _analytic_flops(
        "qwen3-8b", "train_4k")
    assert 0.75 <= ratio <= 1.25, ratio


def test_full_width_train_holds_what_run_cell_counts(meta):
    """Rank 0's program holds the parameter and optimizer bytes of the
    cell's memory column, to the byte."""
    cell = dryrun.run_cell("qwen3-8b", "train_4k", costs=False)
    held = meta["full train_4k"]["held"]
    assert held == {k: cell["per_device_bytes"][k]
                    for k in ("params", "optimizer")}


@pytest.mark.parametrize("name", list(HELD))
def test_mla_and_mamba_train_hold_what_run_cell_counts(meta, name):
    """mamba2-130m (``in_proj``'s 3352 columns and the 24 SSM heads
    whole on the 16 ranks of "model", its conv channels and ``inner``
    split) and deepseek-v3 cut to 3 dense layers and 1 MoE layer: rank
    0's program holds the parameter and optimizer bytes of the cell's
    memory column, to the byte, on the tensor-parallel layout."""
    r = meta[f"held {name}"]
    cell = dryrun.run_cell(HELD[name][0], "train_4k", cfg=_held_cfg(name),
                           costs=False)
    assert r["held"] == {k: cell["per_device_bytes"][k]
                         for k in ("params", "optimizer")}
    assert r["devices"] == 256 and "over the 16 ranks of its model axis: " \
        in r["layout"]
    if name == "mamba2-130m":
        assert "inner (whole in in_proj), vocab (whole: ssm_heads)" \
            in r["layout"]
    else:
        assert "experts, heads, mlp, vocab" in r["layout"]


def test_full_width_decode_flops_equal_the_layouts_closed_form(meta):
    c = configs.get_config(ARCH)
    r = meta["full decode_32k"]
    sh = configs.SHAPES["decode_32k"]
    rows, cols = sh.global_batch // 16, sh.seq_len // 16
    assert c.n_heads % 16 and c.kv_heads % 16      # the heads stay whole
    d, hd = c.d_model, c.head_dim
    proj = 2 * rows * d * hd * (2 * c.n_heads + 2 * c.kv_heads)
    attn = 4 * rows * c.n_heads * cols * hd
    mlp = 2 * 2 * rows * d * c.d_ff // 16
    head = 2 * rows * d * c.vocab_size // 16
    assert r["per_device"]["flops"] == c.n_layers * (proj + attn + mlp) \
        + head
    assert r["bottleneck"] == max(r["roofline_seconds"],
                                  key=r["roofline_seconds"].get)


def _jax_roofline_keys() -> tuple:
    """The keys of JAX's ``roofline_cell`` result and of its
    ``per_device``, read from its source (importing it would force 512
    host devices on this process)."""
    tree_ = ast.parse((ROOT / "src" / "repro" / "launch" /
                       "dryrun.py").read_text())
    fn = next(n for n in tree_.body if isinstance(n, ast.FunctionDef)
              and n.name == "roofline_cell")
    top, per = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets):
            for k, v in zip(node.value.keys, node.value.values):
                top.add(k.value)
                if k.value == "per_device":
                    per = {kk.value for kk in v.keys}
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript):
            top.add(node.targets[0].slice.value)
    return top, per


def test_run_cell_and_main_carry_the_roofline_terms(meta, tmp_path):
    top, per = _jax_roofline_keys()
    assert "scan_trips" in top and "bottleneck" in top
    r = meta["full decode_32k"]
    assert set(r) >= top - {"scan_trips"}
    assert set(r["per_device"]) >= per
    assert set(r["per_device"]["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    before = dryrun.run_cell(ARCH, "decode_32k", costs=False)
    assert before["not_proven"] == ["activation peak", "collective bytes",
                                    "FLOPs"]
    out = tmp_path / "roofline.json"
    assert dryrun.main(["--arch", ARCH, "--shape", "decode_32k",
                        "--roofline", "--out", str(out)]) == 0
    row, = json.loads(out.read_text())
    assert row["per_device_bytes"] == before["per_device_bytes"]
    assert row["not_proven"] == ["activation peak"]
    for key in ("per_device", "roofline_seconds", "bottleneck", "layout",
                "data_ranks", "kernels"):
        assert row[key] == r[key], key
    small = dryrun.run_cell(ARCH, "decode_32k", cfg=SMOKE, mesh=MESH,
                            batch=4, max_len=64)
    assert small["not_proven"] == ["activation peak"]
    assert small["per_device"] == meta["decode_32k"]["per_device"]
    assert small["per_device_bytes"] == dryrun.run_cell(
        ARCH, "decode_32k", cfg=SMOKE, mesh=MESH, batch=4, max_len=64,
        costs=False)["per_device_bytes"]
    rt = small["roofline_seconds"]
    pd = small["per_device"]
    assert rt["compute"] == pd["flops"] / 989e12
    assert rt["memory"] == pd["bytes_accessed"] / 3.35e12
    assert rt["collective"] == pd["collective_bytes"]["total"] / 50e9


def test_no_process_group_is_left_here(meta, gloo):
    """The fake groups lived in the child process, the gloo group in the
    spawned ranks; the port imports the private ``fake_pg`` module in one
    place, ``launch/mesh.py``."""
    assert not dist.is_initialized()
    assert cost._COUNTER is None
    assert math.isfinite(meta["full train_4k"]["count_seconds"])
    port = ROOT / "src" / "repro_torch"
    users = sorted(str(p.relative_to(port)) for p in port.rglob("*.py")
                   if "fake_pg" in p.read_text())
    assert users == ["launch/mesh.py"]

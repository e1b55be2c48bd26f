"""JAX's ``seq_stream`` in the port's tensor-parallel training: the
residual stream between the blocks held as sequence blocks of the model
axis (``rules.stream_splits``; each sublayer's normed input all-gathered
along the sequence, its output reduce-scattered or sliced back,
``collectives.to_stream``), on a (2, 2) (data, model) mesh of 4 gloo
ranks (``launch.mesh.spawn``, one spawn for the file), held against the
JAX package on the global batch from JAX's weights
(``params_from_numpy``):

* one step's loss, MoE losses and every gradient leaf within 1e-5 of
  each leaf's largest (jamba's 5e-5, the tolerance its single-rank and
  whole-stream tests hold it to) against ``jax.value_and_grad`` of a
  mesh-less
  ``loss_fn`` (GSPMD's semantics; a remat policy changes no value, so
  remat ``full`` is held to the same reference), for the smoke configs
  of starcoder2-7b (GQA; remat ``none`` and ``full``), deepseek-v3 (MLA,
  a dense prefix, MoE with a shared expert), jamba-1.5 (Mamba-2,
  attention and MoE) and internvl2-2b (8 patch rows through
  ``frontend_proj`` before 24 tokens looked up in vocabulary blocks: the
  frontend's rows enter the reduce-scatter as model rank 0's), and for
  starcoder2 at S = 33, which does not divide the model axis;
* each layer's output a rank holds has S/2 rows, the rows of the same
  run under ``dict(DEFAULT_RULES, seq_stream=None)`` (whole streams);
  at S = 33 every layer's output stays whole;
* internvl2-2b's loss and gradients also within 1e-5 of its own run
  with the stream whole (the patches concatenated after the sum);
* under remat ``full`` the bytes autograd saves of the layers' inputs
  on a rank (``saved_tensors_hooks``) are half the whole stream's;
* every stream spec a run resolves is JAX's ``logical_to_mesh_axes``
  of the same axes, rules and shape on a mesh-like object of the same
  axis sizes (and so for a table of shapes and meshes, no process);
* ``seq_gather`` and ``seq_scatter`` are each other's transpose (fp32
  and bf16), and count their bytes under ``all-gather`` and
  ``reduce-scatter``;
* JAX's own sharded step (``set_rules_for_mesh`` on 4 forced host
  devices, a subprocess run beside the ranks) gives starcoder2's loss
  and gradients within 1e-5 of the port's.

The JAX references are computed in the parent while the ranks run.
"""

import concurrent.futures
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.sharding import rules as jax_rules
from repro.train import step as jax_step

from repro_torch import configs, tree
from repro_torch.launch import mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.sharding import rules
from test_torch_mesh import SPAWN_TIMEOUT

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (2, 2)
#: name -> (arch, remat, tolerance)
CASES = {"starcoder2": ("starcoder2-7b", "none", TOL),
         "starcoder2-full": ("starcoder2-7b", "full", TOL),
         "deepseek-v3": ("deepseek-v3-671b", "none", TOL),
         "jamba": ("jamba-1.5-large-398b", "none", 5e-5),
         "internvl2": ("internvl2-2b", "none", TOL)}
#: the cases whose batch has a stub frontend's embeddings
FRONTEND = {"internvl2"}
#: the cases also run with the stream whole (internvl2's alone: a
#: frontend's rows before the tokens)
WHOLE = ["starcoder2", "starcoder2-full", "internvl2"]
B, S, SHORT = 4, 32, 33
#: internvl2's patch rows of its S
PATCHES = 8
OFF = dict(rules.DEFAULT_RULES, seq_stream=None)
#: the runs held to JAX's step: (case, rules name, sequence)
JAX_RUNS = [(case, "default", S) for case in CASES] \
    + [("starcoder2", "default", SHORT)]
#: every run of the spawn
RUNS = JAX_RUNS + [(case, "off", S) for case in WHOLE]
RULES = {"default": None, "off": OFF}

JAX_SHARDED = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as tf
from repro.sharding.rules import param_shardings, set_rules_for_mesh
from repro.train import step

arch, tokens, out = json.load(open(sys.argv[1]))
cfg = configs.get_config(arch, smoke=True)
params, axes = tf.init_params_and_axes(jax.random.PRNGKey(0), cfg)
mesh = make_host_mesh(data=2, model=2)
grad = jax.jit(jax.value_and_grad(lambda p, b: step.loss_fn(p, cfg, b),
                                  has_aux=True))
with set_rules_for_mesh(mesh):
    placed = jax.tree.map(jax.device_put, params,
                          param_shardings(axes, mesh, like=params))
    (total, metrics), grads = grad(placed, {"tokens": jnp.asarray(tokens)})
np.savez(out, total=np.asarray(total), loss=np.asarray(metrics["loss"]),
         *[np.asarray(g) for g in jax.tree.leaves(grads)])
print("OK")
"""


@functools.lru_cache(maxsize=None)
def _cfg(case):
    arch, remat, _ = CASES[case]
    return dataclasses.replace(configs.get_config(arch, smoke=True),
                               remat=remat)


@functools.lru_cache(maxsize=None)
def _jax(case):
    """(JAX cfg, JAX params, numpy params) of the case's arch."""
    jcfg = jax_configs.get_config(CASES[case][0], smoke=True)
    jparams, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _tokens(case, seq) -> np.ndarray:
    rng = np.random.default_rng(1)
    return rng.integers(0, _cfg(case).vocab_size,
                        (B, seq + 1)).astype(np.int32)


def _batch(case, seq) -> dict:
    """The case's global batch: tokens, or internvl2's patch embeddings
    before S - 8 tokens."""
    if case not in FRONTEND:
        return {"tokens": torch.from_numpy(_tokens(case, seq))}
    rng = np.random.default_rng(2)
    cfg = _cfg(case)
    return {"embeds": torch.from_numpy(rng.standard_normal(
                (B, PATCHES, cfg.frontend_dim)).astype(np.float32)),
            "tokens": torch.from_numpy(_tokens(case, seq - PATCHES))}


@functools.lru_cache(maxsize=None)
def _jax_step(arch_case, seq):
    jcfg, jparams, _ = _jax(arch_case)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in _batch(arch_case, seq).items()}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_step.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)


def _reference(case, seq):
    """JAX's step of the case: remat changes no value, so ``full``
    takes the arch's remat-``none`` reference."""
    return _jax_step("starcoder2" if case == "starcoder2-full" else case,
                     seq)


def _start_sharded(tmp):
    """JAX's sharded step of starcoder2 on 4 forced host devices, in a
    subprocess: (the process, the .npz it writes)."""
    out = tmp / "jax_sharded.npz"
    arg = tmp / "jax_sharded.json"
    arg.write_text(json.dumps([CASES["starcoder2"][0],
                               _tokens("starcoder2", S).tolist(), str(out)]))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SHARDED, str(arg)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results by run, and by ``"collectives"``; JAX's
    sharded step)."""
    tmp = tmp_path_factory.mktemp("seq_stream")
    calls = [(mesh_ranks.seq_stream_step,
              (_cfg(case), _jax(case)[2], _batch(case, seq), SHAPE,
               RULES[name]))
             for case, name, seq in RUNS]
    calls.append((mesh_ranks.seq_collectives, (SHAPE,)))
    proc, out = _start_sharded(tmp)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, 4, mesh_ranks.in_turn,
                                backend="gloo", devices=["cpu"] * 4,
                                init_file=str(tmp / "init"), args=(calls,),
                                timeout=SPAWN_TIMEOUT)
            for case, name, seq in JAX_RUNS:     # the references meanwhile
                _reference(case, seq)
            got = ranks.result()
        _, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    sharded = np.load(out)
    per_rank = [dict(zip(RUNS + ["collectives"], r)) for r in got]
    return per_rank, sharded


def _grads_close(got, want, tol=TOL):
    """Every gradient leaf within ``tol`` of its largest magnitude."""
    gl = tree.leaves(got)
    assert len(gl) == len(want)
    for w, g in zip(want, gl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (w.shape, err)


@pytest.mark.parametrize("run", JAX_RUNS, ids=lambda r: f"{r[0]}-S{r[2]}")
def test_one_step_matches_jax_on_the_global_batch(runs, run):
    case, _, seq = run
    tol = CASES[case][2]
    (jtot, jm), jgrads = _reference(case, seq)
    for rank in range(4):
        got = runs[0][rank][run]
        assert got["total"] == pytest.approx(float(jtot), rel=tol, abs=tol)
        for key in ("loss", "moe_lb_loss", "moe_z_loss"):
            assert got["metrics"][key] == pytest.approx(
                float(jm[key]), rel=tol, abs=tol), (rank, key)
    _grads_close(runs[0][0][run]["grads"], jax.tree.leaves(jgrads), tol)


@pytest.mark.parametrize("case", list(CASES))
def test_each_layer_holds_its_sequence_block(runs, case):
    """Every layer's output on every rank: the rank's B/2 rows of the
    batch and its S/2 rows of the sequence, one per layer."""
    cfg = _cfg(case)
    for rank in range(4):
        streams = runs[0][rank][(case, "default", S)]["streams"]
        assert len(streams) == cfg.n_layers
        for x in streams:
            assert tuple(x.shape) == (B // 2, S // 2, cfg.d_model)


@pytest.mark.parametrize("case", WHOLE)
def test_blocks_are_the_whole_streams_rows(runs, case):
    """Each rank's blocks are its rows of the whole streams the same run
    holds under ``seq_stream=None``, bit for bit (two ranks' fp32
    partials sum alike either way)."""
    for rank in range(4):
        got = runs[0][rank][(case, "default", S)]
        whole = runs[0][rank][(case, "off", S)]["streams"]
        r = got["model_index"]
        for x, w in zip(got["streams"], whole, strict=True):
            assert tuple(w.shape) == (B // 2, S, _cfg(case).d_model)
            assert torch.equal(x, w[:, r * S // 2:(r + 1) * S // 2])


def test_a_frontends_rows_enter_the_scatter_as_rank_0s(runs):
    """internvl2's patch rows (whole on every rank) and its tokens'
    vocabulary-block partials reduce-scattered together: beside the JAX
    reference above, the loss and every gradient leaf
    (``frontend_proj``'s and ``embed``'s among them) within 1e-5 of the
    whole stream's run, where the rows are summed first and the patches
    concatenated."""
    got = runs[0][0][("internvl2", "default", S)]
    whole = runs[0][0][("internvl2", "off", S)]
    assert got["total"] == pytest.approx(whole["total"], rel=TOL)
    _grads_close(got["grads"], [x.numpy() for x in tree.leaves(
        whole["grads"])])


def test_a_sequence_that_does_not_divide_stays_whole(runs):
    for rank in range(4):
        got = runs[0][rank][("starcoder2", "default", SHORT)]
        assert [tuple(x.shape) for x in got["streams"]] == \
            [(B // 2, SHORT, 128)] * 2
        assert got["specs"] == [((B, SHORT, 128), ("data", None, None))]


def test_remat_full_saves_half_the_layer_inputs(runs):
    """A checkpointed layer saves its input alone: the block, half of
    the whole stream's bytes."""
    cfg = _cfg("starcoder2-full")
    for rank in range(4):
        got = runs[0][rank][("starcoder2-full", "default", S)]
        whole = runs[0][rank][("starcoder2-full", "off", S)]
        one = B // 2 * S * cfg.d_model * 4
        assert whole["saved_inputs"] == cfg.n_layers * one
        assert got["saved_inputs"] == cfg.n_layers * one // 2


class _MeshLike:
    """What JAX's rules read of a mesh: its axis names and a devices
    array of its shape."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1]}-S{r[2]}")
def test_each_stream_spec_is_jaxs(runs, run):
    """The specs the forward resolved (one a step), against JAX's
    ``logical_to_mesh_axes`` of ``("batch", "seq_stream",
    "embed_act")`` on the same global shape."""
    mesh = _MeshLike(("data", "model"), SHAPE)
    want_rules = dict(jax_rules.DEFAULT_RULES,
                      **({"seq_stream": None} if run[1] == "off" else {}))
    for rank in range(4):
        specs = runs[0][rank][run]["specs"]
        assert [shape for shape, _ in specs] == [
            (B, run[2], _cfg(run[0]).d_model)]
        for shape, spec in specs:
            want = jax_rules.logical_to_mesh_axes(
                ("batch", "seq_stream", "embed_act"), want_rules, mesh,
                shape=shape)
            assert spec == tuple(want)


#: (mesh axes, mesh shape, the stream's global shape) resolved without
#: a process: decode's S = 1, a prefill chunk of 301, a model axis of
#: one rank, the production meshes' train and prefill cells
TABLE = [(("data", "model"), (2, 2), (4, 32, 128)),
         (("data", "model"), (2, 2), (1, 1, 128)),
         (("data", "model"), (1, 2), (1, 301, 128)),
         (("data", "model"), (2, 1), (4, 32, 128)),
         (("data", "model"), (16, 16), (256, 4096, 4096)),
         (("pod", "data", "model"), (2, 16, 16), (32, 32768, 4096))]


@pytest.mark.parametrize("rule_set", ["default", "off", "seq_parallel"])
@pytest.mark.parametrize("axes,mesh_shape,shape", TABLE)
def test_stream_spec_table_is_jaxs(rule_set, axes, mesh_shape, shape):
    port_rules = {"default": rules.DEFAULT_RULES, "off": OFF,
                  "seq_parallel": rules.RULES_SEQ_PARALLEL}[rule_set]
    want_rules = {"default": jax_rules.DEFAULT_RULES,
                  "off": dict(jax_rules.DEFAULT_RULES, seq_stream=None),
                  "seq_parallel": jax_rules.RULES_SEQ_PARALLEL}[rule_set]
    port_mesh = Mesh(axes, mesh_shape)
    got = rules.stream_spec(shape, port_rules, port_mesh)
    want = jax_rules.logical_to_mesh_axes(
        ("batch", "seq_stream", "embed_act"), want_rules,
        _MeshLike(axes, mesh_shape), shape=shape)
    assert got == tuple(want)
    with rules.set_rules_for_mesh(port_mesh, port_rules):
        split = rules.stream_splits(shape)
    assert split == (rule_set != "off" and mesh_shape[-1] > 1
                     and shape[1] % mesh_shape[-1] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_seq_gather_and_scatter_are_each_others_transpose(runs, dtype):
    """Inputs ``rank + arange`` (2, rows, 3), cotangents ``(1 + rank)``
    times the output's index: the gather concatenates the model ranks'
    blocks and sums the ranks' cotangents into each block; the scatter
    sums the ranks' inputs into each block and gathers the blocks'
    cotangents."""
    def inp(rank, rows):
        return (torch.arange(2 * rows * 3, dtype=torch.float32)
                .reshape(2, rows, 3) + rank).to(dtype)

    def ct(rank, shape):
        return (torch.arange(int(np.prod(shape)), dtype=torch.float32)
                .reshape(shape) * (1 + rank)).to(dtype)

    key = str(dtype)
    size = dtype.itemsize
    for rank in range(4):
        group = [rank - rank % 2, rank - rank % 2 + 1]   # its model ranks
        m = rank % 2
        got = runs[0][rank]["collectives"]
        gather = got["gather", key]
        assert torch.equal(gather["y"], torch.cat([inp(r, 4) for r in group],
                                                  dim=1))
        total = sum(ct(r, (2, 8, 3)).float() for r in group)
        assert torch.equal(gather["grad"],
                           total[:, 4 * m:4 * m + 4].to(dtype))
        assert gather["bytes"]["all-gather"] == 2 * 8 * 3 * size
        assert gather["bytes"]["reduce-scatter"] == 2 * 4 * 3 * 4
        scatter = got["scatter", key]
        summed = sum(inp(r, 8).float() for r in group)
        assert torch.equal(scatter["y"], summed[:, 4 * m:4 * m + 4].to(dtype))
        assert torch.equal(scatter["grad"],
                           torch.cat([ct(r, (2, 4, 3)) for r in group], dim=1))
        assert scatter["bytes"]["reduce-scatter"] == 2 * 4 * 3 * 4
        assert scatter["bytes"]["all-gather"] == 2 * 8 * 3 * size


def test_jaxs_own_sharded_step_matches(runs):
    """starcoder2's step under JAX's ``set_rules_for_mesh`` on a (2, 2)
    mesh of forced host devices (its params placed by
    ``param_shardings``): the port's loss and gradients within 1e-5."""
    sharded = runs[1]
    got = runs[0][0][("starcoder2", "default", S)]
    assert got["total"] == pytest.approx(float(sharded["total"]), rel=TOL)
    assert got["metrics"]["loss"] == pytest.approx(float(sharded["loss"]),
                                                   rel=TOL)
    _grads_close(got["grads"], [sharded[f"arr_{i}"] for i in range(
        len(sharded.files) - 2)])

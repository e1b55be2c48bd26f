"""Mamba-2's conv tail and SSM state, and jamba's attention/Mamba-2
hybrid, on the sharded serving state (``serve/layout.py``: each rank
holds its columns of ``in_proj``, its conv channels of ``conv_w``,
``conv_b`` and the conv tail, its SSM heads of ``a_log``, ``d_skip``,
``dt_bias`` and the SSM state, its ``inner`` rows of ``norm`` and
``out_proj``; jamba's attention layers their heads and K/V blocks as
GQA stacks do, its FFNs and experts their blocks) on 2 gloo ranks beside
the JAX package on 2 forced host devices, from JAX's weights, through
the plumbing of tests/test_torch_serve_state_mla.py (one spawn and one
JAX process for the file):

* (a) mamba2-130m's and jamba-1.5's smoke configs, for
  ``head_parallel_decode`` and ``distributed_decode`` on
  ``mesh_for_cores(2)``: prompts of 5 and 19 tokens prefilled in chunks
  of 8, then 6 engine steps, emit JAX's token streams;
* (b) every parameter and decode-state leaf a rank holds has the shape
  of JAX's shard for it, and its held bytes equal
  ``dryrun.run_cell(..., batch=, max_len=)``'s per-device figure;
* (c) a mamba2 variant with 5 heads (d_inner 320, head_dim 64, 1
  group): ``in_proj`` (709 wide) and the per-head leaves stay whole,
  the conv channels (384) and ``inner`` split, and the tokens are still
  JAX's;
* (d) ``mamba_forward`` on blocks alone, a decode step and a prefill
  chunk over a random conv tail and SSM state, against the whole layer
  within 1e-5 in fp32 (output, conv tail and SSM state), on mamba2's
  smoke config (the rank's heads inside its one group), jamba's (whole
  groups), the 5-head variant (heads whole) and a 6-head, 3-group
  variant (rank 1's heads part a group); and the norm over the whole
  ``inner`` width from the ranks' blocks against ``rms_norm``.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh_ranks
from repro_torch.models import mamba as mb
from repro_torch.models.common import ModelConfig
from test_torch_serve_state_mla import (FLAGS, MAX_LEN, check_shards,
                                        check_tokens, cfg_kw, jax_and_port,
                                        params_np, run_id)

torch.set_num_threads(2)

TOL = 1e-5
MAMBA, JAMBA = "mamba2-130m", "jamba-1.5-large-398b"
#: variants of mamba2's smoke config: (arch, overrides)
VARIANTS = {"mamba2-odd": (MAMBA, dict(ssm_heads=5, d_inner=320,
                                       ssm_head_dim=64, ssm_groups=1)),
            "mamba2-parted": (MAMBA, dict(ssm_heads=6, d_inner=192,
                                          ssm_head_dim=32, ssm_groups=3))}
#: (config, flag, max_len) of (a) and (c)
RUNS = [(a, f, MAX_LEN) for a in (MAMBA, JAMBA, "mamba2-odd")
        for f in FLAGS]
#: the configs of (d)
ALONE = (MAMBA, JAMBA, "mamba2-odd", "mamba2-parted")


def _cfg(name) -> ModelConfig:
    return ModelConfig(**cfg_kw(name, VARIANTS))


def _alone_inputs(name):
    """(x (2, 8, d), the conv tail (2, W-1, conv dim), the SSM state (2,
    H, P, S)) of (d), drawn from a seed."""
    cfg = _cfg(name)
    d_in, h, p, g, s = mb.dims(cfg)
    rng = np.random.default_rng(5)
    f32 = np.float32
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(f32))
                 for shape in ((2, 8, cfg.d_model),
                               (2, cfg.conv_width - 1, d_in + 2 * g * s),
                               (2, h, p, s)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_state_ssm")
    alone = [(mesh_ranks.mamba_blocks_alone,
              (_cfg(name), params_np(name, VARIANTS), *_alone_inputs(name)))
             for name in ALONE]
    return jax_and_port(tmp, RUNS, alone, VARIANTS)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[run_id(r) for r in RUNS])
def test_tokens_match_jax(runs, i):
    """(a), (c): JAX's token streams on every rank; the decode flag's
    attention ran at jamba's attention layer."""
    ref, port = runs
    check_tokens(ref, port, RUNS, i)
    if RUNS[i][0] == JAMBA:
        assert all(port[r][i]["calls"] >= 5 for r in range(2))


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[run_id(r) for r in RUNS])
def test_blocks_are_jax_shards_and_dryrun_bytes(runs, i):
    """(b), (c): JAX's shard shapes and the dry-run's bytes; each Mamba
    leaf split or whole by its own width."""
    ref, port = runs
    name = RUNS[i][0]
    arch = VARIANTS[name][0] if name in VARIANTS else name
    shapes = check_shards(ref, port, RUNS, i, arch, VARIANTS)
    cfg = _cfg(name)
    d_in, h, p, g, s = mb.dims(cfg)
    widths = {"in_proj": 2 * d_in + 2 * g * s + h,
              "conv_b": d_in + 2 * g * s, "a_log": h, "norm": d_in}
    mamba = {k.rsplit("/", 1)[1]: v for k, v in shapes["params"].items()
             if "/mamba/" in k}
    for leaf, width in widths.items():
        want = width // 2 if width % 2 == 0 else width
        assert mamba[leaf][-1 if leaf != "in_proj" else 2] == want, leaf
    if name == "mamba2-odd":
        assert mamba["in_proj"][2] == 709 and mamba["a_log"][-1] == 5
    state = {k.rsplit("/", 1)[1]: v for k, v in shapes["state"].items()
             if k.endswith("/conv") or k.endswith("/ssm")}
    assert state["conv"][-1] == (d_in + 2 * g * s) // 2
    assert state["ssm"][-3] == (h // 2 if h % 2 == 0 else h)


@pytest.mark.parametrize("j", range(len(ALONE)), ids=list(ALONE))
def test_mamba_forward_on_blocks_alone(runs, j):
    """(d): the decode step and the prefill chunk on the rank's blocks
    against the whole layer (output, conv tail and SSM state after,
    gathered), and the block norm against ``rms_norm``, within 1e-5."""
    _, port = runs
    for rank in range(2):
        got = port[rank][len(RUNS) + j]
        for name in ("decode", "chunk"):
            for part in ("out", "conv", "ssm"):
                a, b = got[name][part]
                assert a.shape == b.shape
                assert (a - b).abs().max().item() <= TOL, (rank, name, part)
        a, b = got["norm"]
        assert (a - b).abs().max().item() <= TOL, rank
        assert got["blocks"]["norm"][-1] == _cfg(ALONE[j]).inner_dim // 2

"""The MoE layer on the sharded serving state against the whole layer,
bit for bit, on 2 gloo ranks of a (1, 2) mesh (``launch.mesh.spawn``,
one spawn for the file), in fp32 compute, on deepseek-v3's smoke MoE
(8 routed experts, top-2) with no shared expert and with one, and the
same in bf16 compute, where the card measured the difference:

* routed experts alone: the layer on blocks (each rank its 4 experts and
  their router columns, the router's logits gathered before the
  softmax) equals the whole layer bit for bit, as phi3.5-moe's does;
* with a shared expert: the layer on blocks equals the whole layer's
  routed part plus the ranks' partials of the shared MLP on their column
  blocks, summed as the ``psum`` sums them, bit for bit.  So the only
  difference from the whole layer is that ``psum`` (``mlp_forward``): a
  sum of two partials over the hidden width in place of one product
  over all of it, which rounds once more (and, in bf16, each partial is
  rounded to bf16 before the fp32 sum and the sum rounded back), by
  design.
"""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh_ranks
from repro_torch.launch.mesh import spawn
from repro_torch.models.weights import init_params

ARCH = "deepseek-v3-671b"
#: (n_shared_experts, compute dtype) of each case
CASES = [(0, "float32"), (1, "float32"), (0, "bfloat16"), (1, "bfloat16")]


def _cfg(n_shared: int, dtype: str):
    return dataclasses.replace(configs.get_config(ARCH, smoke=True),
                               n_shared_experts=n_shared,
                               compute_dtype=dtype, param_dtype=dtype)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results for every case of CASES, from one spawn."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 24, 128, generator=gen)
    calls = []
    for n, dtype in CASES:
        cfg = _cfg(n, dtype)
        params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        calls.append((mesh_ranks.moe_blocks_alone,
                      (cfg, params, x.to(cfg.torch_dtype()))))
    tmp = tmp_path_factory.mktemp("moe_blocks")
    return spawn(2, mesh_ranks.in_turn, backend="gloo",
                 devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                 args=(calls,), timeout=120)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [0, 1])
def test_routed_experts_on_blocks_are_bit_equal(ranks, rank, dtype):
    got = ranks[rank][CASES.index((0, dtype))]
    assert torch.equal(got["blocks"], got["whole"])
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert torch.equal(got["blocks_aux"][key], got["whole_aux"][key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [0, 1])
def test_shared_expert_differs_only_by_its_column_partial_psum(ranks, rank,
                                                               dtype):
    got = ranks[rank][CASES.index((1, dtype))]
    p = got["partials"]
    assert p.shape[0] == 2
    # the psum sums 16-bit partials in fp32 and rounds the sum back
    summed = (p[0].float() + p[1].float()).to(p.dtype)
    assert torch.equal(got["blocks"], got["routed"] + summed)
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert torch.equal(got["blocks_aux"][key], got["whole_aux"][key])
    # the psum's extra rounding: within fp32's, or bf16's (2^-8) of the
    # output's scale
    scale = got["whole"].float().abs().max()
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    assert (got["blocks"].float()
            - got["whole"].float()).abs().max() <= tol * scale

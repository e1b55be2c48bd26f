"""``last_token`` of the sharded serving state over the data axes, as
JAX's ``decode_state_shardings`` splits it: on 2 gloo ranks of a (2, 1)
data x model mesh (one spawn for the file) starcoder2's smoke config is
served under ``distributed_decode`` at batch 2, prompts prefilled in
chunks, with both rows preempted and resumed in each other's slot after
3 steps (their tokens travel through the snapshot from the rank that
holds them):

* each rank holds its row of ``last_token`` (1 of 2) beside the whole
  ``cache_len``;
* every step's tokens are the single rank's;
* the bytes a rank holds of the decode state are the dry-run's
  per-device figure for the serve's geometry on that mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, lower, tree
from repro_torch.launch import dryrun, mesh_ranks
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.weights import init_params
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      make_serving_plan)

ARCH = "starcoder2-7b"
MAX_LEN, STEPS, CHUNK, SWAP = 32, 6, 8, 3
PROMPTS = [(np.arange(5) % 60).tolist(), ((np.arange(19) * 7) % 60).tolist()]
FLAG = "distributed_decode"
SHAPE = (2, 1)


def _cfg():
    return dataclasses.replace(configs.get_config(ARCH, smoke=True),
                               **{FLAG: True})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the single rank's tokens, each rank's serve of the same weights
    on the mesh)."""
    cfg = _cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lower.clear_plan_cache()
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=2, max_len=MAX_LEN,
        plan=make_serving_plan(cfg, MAX_LEN, device="cpu"),
        prefill_chunk=CHUNK, device="cpu")
    for slot, p in enumerate(PROMPTS):
        eng.begin_prefill(slot, p)
    want = []
    for i in range(STEPS):
        if i == SWAP:
            pre = [eng.preempt(slot) for slot in (0, 1)]
            eng.resume(pre[0], 1)
            eng.resume(pre[1], 0)
        t, _ = eng.step()
        want.append(None if t is None else np.asarray(t).tolist())
    tmp = tmp_path_factory.mktemp("serve_rows")
    ranks = spawn(2, mesh_ranks.serve_state, backend="gloo",
                  devices=["cpu", "cpu"], init_file=str(tmp / "init"),
                  args=(cfg, tree.map(lambda t: t.numpy(), params), PROMPTS,
                        MAX_LEN, STEPS, FLAG, SHAPE, SWAP, CHUNK),
                  timeout=120)
    return want, ranks


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_holds_its_row_of_last_token(served, rank):
    shapes = served[1][rank]["shapes"]["state"]
    assert shapes["/last_token"] == (1,)
    assert shapes["/cache_len"] == (2,)


@pytest.mark.parametrize("rank", [0, 1])
def test_tokens_are_the_single_ranks(served, rank):
    want, ranks = served
    assert ranks[rank]["tokens"] == want
    assert ranks[rank]["calls"] >= STEPS - 1, "the mesh path never ran"


@pytest.mark.parametrize("rank", [0, 1])
def test_held_state_bytes_are_the_dry_runs(served, rank):
    cell = dryrun.run_cell(ARCH, "decode_32k", cfg=_cfg(),
                           mesh=Mesh(("data", "model"), SHAPE), batch=2,
                           max_len=MAX_LEN, costs=False)["per_device_bytes"]
    assert served[1][rank]["held"] == {"params": cell["params"],
                                       "caches": cell["caches"]}

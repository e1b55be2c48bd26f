"""The port's continuous-batching engine and batcher against the JAX
package's, on the same weights: identical token streams for a mixed
stream of requests whose prompts (40-90 tokens, chunked by 48) and
decode contexts cross both crossovers of the smoke head width 32
(prefill M > N; chunks and decode past C = 2N = 64), and a port plan
that took every fused path."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as jax_tf
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestBatcher as JaxBatcher
from repro.serve import make_serving_plan as jax_serving_plan

from repro_torch import configs, lower
from repro_torch.kernels import ops
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.batcher import Request, RequestBatcher
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      make_serving_plan)

torch.set_num_threads(2)

PROMPT_LENS = [44, 90, 71, 58]
MAX_LEN, CHUNK, BATCH, MAX_NEW = 160, 48, 3, 6


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _serve_jax(arch, prompts):
    cfg = jax_configs.get_config(arch, smoke=True)
    params, _ = jax_tf.init_params_and_axes(jax.random.PRNGKey(0), cfg)
    eng = JaxEngine(params, cfg, batch_size=BATCH, max_len=MAX_LEN,
                    plan=jax_serving_plan(cfg, MAX_LEN),
                    prefill_chunk=CHUNK)
    b = JaxBatcher(BATCH, max_len=MAX_LEN)
    for uid, p in enumerate(prompts):
        b.submit(JaxRequest(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    done = b.serve(eng, max_steps=200)
    return params, {r.uid: r.generated for r in done}


@pytest.mark.parametrize("arch", configs.list_archs("dense"))
def test_token_streams_match_jax_engine(arch):
    cfg = configs.get_config(arch, smoke=True)
    prompts = _prompts(cfg.vocab_size)
    jparams, want = _serve_jax(arch, prompts)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    plan = make_serving_plan(cfg, MAX_LEN, device="cpu")
    eng = ContinuousBatchingEngine(params, cfg, batch_size=BATCH,
                                   max_len=MAX_LEN, plan=plan,
                                   prefill_chunk=CHUNK, device="cpu")
    b = RequestBatcher(BATCH, max_len=MAX_LEN)
    for uid, p in enumerate(prompts):
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    ops.reset_counts()
    got = {r.uid: r.generated for r in b.serve(eng, max_steps=200)}
    assert got == want
    assert len(got) == len(prompts)
    assert all(len(t) == MAX_NEW for t in got.values())

    paths = {r[3] for r in plan.resolutions}
    if cfg.qk_norm:
        assert lower.FUSED_ATTENTION in paths
        assert ops.CALLS[("attention", "torch")] > 0
    else:
        assert {lower.FUSED_ATTENTION, lower.QPROJ_ATTENTION,
                lower.DECODE_MEGAKERNEL} <= paths
        for entry in ("attention", "qproj_attention", "decode_block"):
            assert ops.CALLS[(entry, "torch")] > 0, entry
    assert ops.CALLS[("decode_block", "reference")] == 0


def test_engine_insert_and_evict_keep_neighbours():
    """A request inserted mid-stream lands in its slot and leaves the
    decoding row's tokens as they were; an evicted slot is reusable."""
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    from repro_torch.models.weights import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    pa, pb = rng.integers(0, 256, 9), rng.integers(0, 256, 13)

    def run(insert_b):
        eng = ContinuousBatchingEngine(params, cfg, batch_size=2,
                                       max_len=48, device="cpu")
        eng.begin_prefill(0, pa)
        toks = []
        for step in range(6):
            if insert_b and step == 2:
                eng.begin_prefill(1, pb)
            tokens, inserted = eng.step()
            for slot, first in inserted:
                if slot == 0:
                    toks.append(first)
                else:
                    assert eng.live[1]
            toks.append(int(tokens[0]))
        return eng, toks

    _, alone = run(False)
    eng, with_b = run(True)
    assert alone == with_b
    eng.evict(1)
    assert eng.free_slots() == [1] and eng.row_ctx[1] == 0
    eng.begin_prefill(1, pb)
    eng.step()
    assert eng.live[1]

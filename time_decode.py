"""Times qwen3-8b's decode on one H100, for one or more source trees of
the port, each in a process of its own:

    python3 time_decode.py                 # this checkout's src/
    python3 time_decode.py OLD/src src     # OLD, new, new, OLD

For each tree: qwen3-8b at full width, depth cut to 4 layers, random
bf16 weights from seed 0, B=2, prompts of 300 and 333 tokens, as
chip_smoke.py's qwen phase runs it; 8 decode steps on the dense engine
(fused_attention_masked past C = 256) and 8 on the paged engine (page
16, fused_attention_paged), each step on the host clock between
synchronizes: the median and the spread.  Then the two attention
kernels alone at chip_smoke.py's shape for #4 (qwen3-8b's widths, B=4,
lengths 301/460/612/705, page 16), three timings of 50 calls each by
chip_smoke.py's time_ms: #4 on the pool and #1 on the gathered cache.
With several trees the first runs first and last.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 8


def time_tree(label: str) -> None:
    # repro_torch first, from PYTHONPATH (the tree under test): importing
    # chip_smoke then puts this checkout's src/ on sys.path, but the
    # package is already bound, and its submodules come from its own
    # directory
    import repro_torch  # noqa: F401
    import torch

    import chip_smoke as cs
    from repro_torch import lower
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.fused_attention import (fused_attention_masked,
                                                     fused_attention_paged)
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    build.build_all(["fused_attention_masked"])
    dev = torch.device("cuda", 0)
    args = serve.parser().parse_args([
        "--arch", "qwen3-8b", "--layers", "4", "--batch", "2",
        "--max-len", "512", "--prefill-chunk", "256", "--device", "cuda"])
    cfg, params = serve.model_for(args)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               for n in (300, 333)]

    def decode(eng):
        for slot, prompt in enumerate(prompts):
            eng.begin_prefill(slot, prompt)
        while eng._pending:
            eng._advance_prefills()
        return cs.timed_decode(eng, STEPS)[1]

    dense = decode(ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len,
        plan=lower.serving_plan(cfg, args.max_len, device=dev),
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=dev))
    paged = decode(cs.paged_engine(
        params, cfg, args, lower.serving_plan(cfg, args.max_len, device=dev,
                                              paged=True, page_size=cs.PAGE),
        args.batch * args.max_len // cs.PAGE + 1, dev))
    del params
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    b, hq, hkv, d = len(cs.PAGED_LENS), *(cs.QWEN[k] for k in
                                          ("HQ", "HKV", "D"))
    q, k, v = rnd(b, hq, 1, d), rnd(b, hkv, 1024, d), rnd(b, hkv, 1024, d)
    kp, vp, tbl = cs.paged_from_dense(k, v, cs.PAGED_LENS, cs.PAGE, g)
    kg, vg = ref.gather_pages(kp, tbl), ref.gather_pages(vp, tbl)
    lengths = torch.tensor(cs.PAGED_LENS, dtype=torch.int32, device=dev)
    k4 = [cs.time_ms(lambda: fused_attention_paged(q, kp, vp, lengths, tbl),
                     50) for _ in range(3)]
    k1 = [cs.time_ms(lambda: fused_attention_masked(q, kg, vg, lengths), 50)
          for _ in range(3)]
    print(f"{label}: qwen3-8b 4 layers B=2 decode, {STEPS} steps: dense "
          f"{dense}; paged {paged}; fused_attention_paged ms "
          f"{' '.join(f'{t:.4f}' for t in k4)}; fused_attention_masked on "
          f"the gathered cache ms {' '.join(f'{t:.4f}' for t in k1)}",
          flush=True)


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--one":
        time_tree(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_decode: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    print(f"card: {chip_smoke.card_line()}", flush=True)
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]] or \
        [str(ROOT / "src")]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    for tree in order:
        env = {**os.environ, "PYTHONPATH": tree}
        done = subprocess.run([sys.executable, __file__, "--one", tree],
                              env=env)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

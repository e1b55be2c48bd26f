"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card

Phases, in order:
  1. card   -- the card's name and power limit, torch and CUDA versions;
  2. build  -- every CUDA kernel built from csrc/, one nvcc per source,
               all started together;
  3. kernels-- each kernel against its plain PyTorch version on the card
               in bf16, at the serve path's full-width shapes and at edge
               cases (a length of 0, lengths off the tile grid, Sq > 1
               under the causal anchor), with its time, the plain
               version's, the card's bound and a library yardstick;
  4. serve  -- the port's launch/serve path: starcoder2-7b at full width
               and depth, random weights from a seed, 6 requests through
               the continuous-batching engine; every kernel must launch,
               and one request rerun with impl forced to the plain
               versions must give the same logits within tolerance;
               then the mix again and a steady decode window under
               torch.profiler: device time by kernel and idle share;
  5. qwen   -- qwen3-8b at full width, depth cut to 4 layers, one short
               stream; its decode past C = 2N runs fused_attention_masked.
The last three lines of stdout are the kernels' JSON record, the card's
name and power limit, and {"ok": true, "device": {...}}.  Any failure exits non-zero and prints
no ok line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

STARCODER = dict(E=4608, HQ=36, HKV=4, D=128)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return smi


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_ / PEAK_BYTES, flops / PEAK_BF16
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def rel_err(out, want) -> tuple[float, float]:
    """(max |out - want|, that over max |want|)."""
    err = (out.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, err / (scale if scale > 0 else 1.0)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

#: bf16 tolerance of a kernel against its plain version, relative to the
#: output's scale: both round their outputs (and p, and the in-kernel Q)
#: to bf16, whose unit roundoff is 2^-8 = 3.9e-3, and they sum in other
#: orders; a few roundings of an O(1) value stay well inside 2e-2.
KERNEL_TOL = 2e-2


def _valid_cols(lengths, sq, causal):
    """Score entries and KV rows the masked kernels need for these
    lengths: (entries per (b, q-head), kv rows per b)."""
    ent, rows = [], []
    for n in lengths:
        n = int(n)
        if causal:
            e = sum(max(0, min(n, n - sq + r + 1)) for r in range(sq))
        else:
            e = sq * n
        ent.append(e)
        rows.append(n)
    return ent, rows


def kernel_phase(dev, g):
    from repro_torch.kernels.fused_attention import (
        fused_attention_masked, fused_attention_masked_plain)
    from repro_torch.kernels.fused_decode_block import (
        fused_decode_block, fused_decode_block_plain)
    from repro_torch.kernels.fused_qproj_attention import (
        fused_qproj_attention_masked, fused_qproj_attention_masked_plain)

    bf = torch.bfloat16
    E, HQ, HKV, D = (STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    theta = 1e5
    skv = 1024

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(bf)

    results = {}

    def check(name, got, want, tag):
        err, rel = rel_err(got, want)
        ok = bool(torch.isfinite(got.float()).all()) and rel <= KERNEL_TOL
        log(f"  {name} [{tag}] max_abs_err={err:.3e} rel={rel:.3e} "
            f"tol={KERNEL_TOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"({tag})")
        return err

    # -- 1. fused_attention_masked: the first prefill chunk --------------
    sq = 256
    q, k, v = rnd(1, HQ, sq, D), rnd(1, HKV, skv, D), rnd(1, HKV, skv, D)
    lens = torch.tensor([sq], dtype=torch.int32, device=dev)
    f1 = lambda: fused_attention_masked(q, k, v, lens, causal=True)
    p1 = lambda: fused_attention_masked_plain(q, k, v, lens, causal=True)
    err = check("fused_attention_masked", f1(), p1(), "B=1 Sq=256 chunk")
    for (b_, sq_, ls, causal) in [(3, 5, [0, 77, 130], True),
                                  (3, 1, [0, 63, 65], False),
                                  (2, 40, [40, 1000], True)]:
        qq, kk, vv = rnd(b_, HQ, sq_, D), rnd(b_, HKV, skv, D), \
            rnd(b_, HKV, skv, D)
        ll = torch.tensor(ls, dtype=torch.int32, device=dev)
        check("fused_attention_masked",
              fused_attention_masked(qq, kk, vv, ll, causal=causal),
              fused_attention_masked_plain(qq, kk, vv, ll, causal=causal),
              f"Sq={sq_} lengths={ls} causal={causal}")
    ent, rows = _valid_cols([sq], sq, True)
    byts = 2 * (q.numel() * 2 + sum(rows) * HKV * D * 2) + 4
    flops = 4 * HQ * D * sum(ent)
    bms, by = bound(byts, flops)
    # the yardstick: SDPA with a boolean mask, GQA heads expanded
    cols = torch.arange(skv, device=dev)
    mask = (cols[None, :] < lens[:, None])[:, None, None, :] & (
        cols[None, None, :] <= (lens[:, None] - sq + torch.arange(
            sq, device=dev)[None, :])[:, :, None])[:, None]
    ke = k.repeat_interleave(HQ // HKV, 1)
    ve = v.repeat_interleave(HQ // HKV, 1)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask)
    results["fused_attention_masked"] = dict(
        source="src/repro_torch/kernels/csrc/fused_attention.cu",
        replaces="src/repro/kernels/fused_attention.py:310",
        max_abs_err=err, ms=time_ms(f1, 20), plain_ms=time_ms(p1, 3),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lib, 20))

    # -- 2. fused_qproj_attention_masked: a ragged later chunk -----------
    sq, total = 188, 700          # a 700-token prompt's third chunk
    x, wq = rnd(1, sq, E), rnd(E, HQ, D, scale=E ** -0.5)
    lens = torch.tensor([total], dtype=torch.int32, device=dev)
    f2 = lambda: fused_qproj_attention_masked(
        x, wq, k, v, lens, causal=True, rope_theta=theta)
    p2 = lambda: fused_qproj_attention_masked_plain(
        x, wq, k, v, lens, causal=True, rope_theta=theta)
    err = check("fused_qproj_attention_masked", f2(), p2(),
                f"B=1 Sq={sq} lengths=[{total}]")
    for (b_, sq_, ls, th) in [(3, 7, [0, 70, 129], theta),
                              (2, 33, [33, 517], None)]:
        xx = rnd(b_, sq_, E)
        kk, vv = rnd(b_, HKV, skv, D), rnd(b_, HKV, skv, D)
        ll = torch.tensor(ls, dtype=torch.int32, device=dev)
        check("fused_qproj_attention_masked",
              fused_qproj_attention_masked(xx, wq, kk, vv, ll,
                                           rope_theta=th),
              fused_qproj_attention_masked_plain(xx, wq, kk, vv, ll,
                                                 rope_theta=th),
              f"Sq={sq_} lengths={ls} rope={th is not None}")
    ent, rows = _valid_cols([total], sq, True)
    byts = 2 * (x.numel() + wq.numel() + sum(rows) * HKV * 2 * D
                + sq * HQ * D) + 4
    flops = 2 * sq * E * HQ * D + 4 * HQ * D * sum(ent)
    bms, by = bound(byts, flops)
    results["fused_qproj_attention_masked"] = dict(
        source="src/repro_torch/kernels/csrc/fused_qproj_attention.cu",
        replaces="src/repro/kernels/fused_qproj_attention.py:243",
        max_abs_err=err, ms=time_ms(f2, 10), plain_ms=time_ms(p2, 3),
        bound_ms=bms, bound_by=by, library_ms=None)

    # -- 3. fused_decode_block: a B=4 decode step ------------------------
    # The residual is N(0, 1) while the term the kernel computes, y =
    # o @ Wo, is an order of magnitude smaller, so against a residual
    # the comparison sees little beyond the residual's rounding.  Each
    # case therefore also runs with a zero residual: the output is then
    # y itself and the tolerance is relative to y's own scale.
    b = 4
    x, res = rnd(b, 1, E), rnd(b, 1, E)
    wo = rnd(HQ, D, E, scale=(HQ * D) ** -0.5)
    k, v = rnd(b, HKV, skv, D), rnd(b, HKV, skv, D)
    lens = torch.tensor([301, 460, 612, 705], dtype=torch.int32,
                        device=dev)

    def check_decode(xx, kk, vv, rr, ll, tag):
        """Kernel against plain with the residual ``rr`` and with a zero
        one; returns (kernel output with rr, the larger error)."""
        outs, errs = [], []
        for r_, what in ((rr, "residual"), (torch.zeros_like(rr),
                                            "zero residual")):
            outs.append(fused_decode_block(xx, wq, kk, vv, wo, r_, ll,
                                           rope_theta=theta))
            errs.append(check(
                "fused_decode_block", outs[-1],
                fused_decode_block_plain(xx, wq, kk, vv, wo, r_, ll,
                                         rope_theta=theta),
                f"{tag} {what}"))
        return outs[0], max(errs)

    f3 = lambda: fused_decode_block(x, wq, k, v, wo, res, lens,
                                    rope_theta=theta)
    p3 = lambda: fused_decode_block_plain(x, wq, k, v, wo, res, lens,
                                          rope_theta=theta)
    out, err = check_decode(x, k, v, res, lens, "B=4 lengths=[301..705]")
    if not torch.equal(out, f3()):
        raise SystemExit("fused_decode_block is not deterministic")
    for ls in ([0, 1, 257], [64, 0, 1023]):
        ll = torch.tensor(ls, dtype=torch.int32, device=dev)
        bb = len(ls)
        xx, rr = rnd(bb, 1, E), rnd(bb, 1, E)
        kk, vv = rnd(bb, HKV, skv, D), rnd(bb, HKV, skv, D)
        got, _ = check_decode(xx, kk, vv, rr, ll, f"lengths={ls}")
        zero = [i for i, n in enumerate(ls) if n == 0]
        if zero and not torch.equal(got[zero], rr[zero]):
            raise SystemExit("fused_decode_block: a length-0 row must "
                             "return its residual")
    kv_rows = int(lens.sum())
    byts = 2 * (3 * b * E + wq.numel() + wo.numel()
                + kv_rows * HKV * 2 * D) + 4 * b
    flops = 2 * b * E * HQ * D + 4 * HQ * D * kv_rows + 2 * b * HQ * D * E
    bms, by = bound(byts, flops)
    results["fused_decode_block"] = dict(
        source="src/repro_torch/kernels/csrc/fused_decode_block.cu",
        replaces="src/repro/kernels/fused_decode_block.py:258",
        max_abs_err=err, ms=time_ms(f3, 20), plain_ms=time_ms(p3, 3),
        bound_ms=bms, bound_by=by, library_ms=None)
    for name, r in results.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={lib}")
    return results


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

#: bf16 tolerance of the served logits, kernels against plain versions,
#: relative to the largest |logit|: each layer's attention output
#: differs by bf16 roundings (2^-8 relative) between the two, and 32
#: layers of random weights carry those differences to the logits.
LOGIT_TOL = 5e-2
DECODE_COMPARED = 4
#: the serve phase's prompt lengths, drawn from [300, 701)
PROMPT_LENS = (300, 701)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _one_request_logits(eng, prompt, forced_tokens=None):
    """Prefill ``prompt`` into slot 0 of an idle engine, then decode
    DECODE_COMPARED steps; with ``forced_tokens`` the row is fed those
    tokens instead of its own samples (so two runs stay comparable).
    Returns ([prefill logits, step logits...], tokens fed)."""
    eng.begin_prefill(0, prompt)
    while not eng.live[0]:
        eng._advance_prefills()
    logits, fed = [eng.prefill_logits[0].float()], []
    for i in range(DECODE_COMPARED):
        if forced_tokens is not None:
            eng.state.last_token[0] = forced_tokens[i]
        fed.append(int(eng.state.last_token[0]))
        eng.decode_once()
        logits.append(eng.last_logits[0].float())
    return logits, fed


#: whole-batch decode steps in each steady decode window
DECODE_WINDOW = 8


def device_report(prof, wall_s: float, title: str, top: int = 8) -> float:
    """Device time by kernel from a ``torch.profiler`` trace (device-side
    events only, so the host ops that launched them are not counted
    twice), with the share of ``wall_s`` the device was idle.  Returns
    the device busy time in ms."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[1] for r in rows)
    if not busy_us:
        raise SystemExit(f"{title}: the profiler recorded no device time")
    log(f"  {title}: wall {wall_s * 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share under the profiler "
        f"{1 - busy_us / 1e3 / (wall_s * 1e3):.4f}")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {us / 1e3:10.3f} ms {100 * us / busy_us:6.2f}% x{n:<5d} "
            f"{key[:80]}")
    return busy_us / 1e3


def profile_windows(args, cfg, params):
    """Where the serve path's time goes: the request mix served again
    under ``torch.profiler``, then a steady window of whole-batch decode
    steps with every row live, timed on the host clock without the
    profiler and then again under it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import lower
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve.run(args, cfg, params, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_report(prof, wall, "profiled serve run (prefill and decode)")

    plan = lower.serving_plan(cfg, args.max_len, device=args.device)
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len, plan=plan,
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=args.device)
    for slot, req in enumerate(requests[:args.batch]):
        eng.begin_prefill(slot, req.prompt)
    while not all(eng.live):
        eng.step()
    eng.decode_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_WINDOW):
        eng.decode_once()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / DECODE_WINDOW * 1e3
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_WINDOW):
            eng.decode_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"  decode window: B={args.batch} live, contexts {eng.row_ctx}, "
        f"{DECODE_WINDOW} steps unprofiled {host_ms:.3f} ms/step, then "
        f"{DECODE_WINDOW} profiled {wall / DECODE_WINDOW * 1e3:.3f} ms/step")
    busy = device_report(prof, wall, "profiled decode window")
    log(f"  decode window: device busy {busy / DECODE_WINDOW:.3f} ms/step; "
        f"against the unprofiled window's step, idle share "
        f"{1 - busy / DECODE_WINDOW / host_ms:.4f} (an estimate: the two "
        f"windows are consecutive, not the same steps)")
    del eng


def serve_phase(dev):
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    args = serve.parser().parse_args([
        "--arch", "starcoder2-7b", "--batch", "4", "--requests", "6",
        "--max-len", "1024", "--max-new", "16", "--prefill-chunk", "256",
        "--device", "cuda"])
    t0 = time.time()
    cfg, params = serve.model_for(args)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"bf16 random weights (seed 0) in {time.time() - t0:.1f}s")
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    log(f"  prompts: {[len(r.prompt) for r in requests]} tokens, "
        f"chunk {args.prefill_chunk}, max_len {args.max_len}")

    ops.reset_counts()
    out = serve.run(args, cfg, params, requests)
    launches = dict(build.LAUNCHES)
    calls = dict(ops.CALLS)
    finished, secs = out["finished"], out["seconds"]
    gen = sum(len(r.generated) for r in finished)
    steps = out["decode_step_s"]
    step_ms = sorted(steps)[len(steps) // 2] * 1e3
    unfused = sum(1 for r in out["plan"].resolutions
                  if r[3] == lower.UNFUSED)
    log(f"  finished {len(finished)}/{len(requests)} requests, {gen} "
        f"tokens in {secs:.3f}s = {gen / secs:.2f} tok/s; decode steps "
        f"{len(steps)}, median step {step_ms:.3f} ms")
    log(f"  launches: {launches}")
    log(f"  calls by impl: "
        f"{ {f'{e}/{i}': n for (e, i), n in sorted(calls.items())} }")
    log(f"  plan resolutions: {len(out['plan'].resolutions)}, unfused "
        f"(reference) chosen {unfused}, reference calls "
        f"{sum(n for (e, i), n in calls.items() if i == 'reference')}")
    log(f"  decode_block launches per decode step: "
        f"{launches.get('fused_decode_block', 0) / max(len(steps), 1):.2f}")
    wbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params) if t is not params["embed"])
    log(f"  weights read per decode step {wbytes / 1e9:.3f} GB: step bound "
        f"{wbytes / PEAK_BYTES * 1e3:.3f} ms at {PEAK_BYTES / 1e12} TB/s "
        f"(the embedding is gathered, not read)")
    if len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit("serve: not every request finished its budget")
    missing = [n for n in build.KERNELS if launches.get(n, 0) == 0]
    if missing:
        raise SystemExit(f"serve: kernels never launched: {missing}")

    # one request again, impl forced to the plain versions (a plan whose
    # device maps fused paths to "torch"), fed the kernel run's tokens
    prompt = requests[1].prompt
    runs = []
    for plan_dev in (dev, torch.device("cpu")):
        plan = lower.ServingPlan(cfg=cfg, max_len=args.max_len,
                                 device=plan_dev, n_blocks=cfg.n_layers)
        eng = ContinuousBatchingEngine(
            params, cfg, batch_size=1, max_len=args.max_len, plan=plan,
            dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
            device=dev)
        forced = runs[0][1] if runs else None
        runs.append(_one_request_logits(eng, prompt, forced))
        del eng
    (k_logits, toks), (p_logits, _) = runs
    worst = 0.0
    for i, (a, b) in enumerate(zip(k_logits, p_logits)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"serve: non-finite logits at step {i}")
        err, rel = rel_err(a, b)
        worst = max(worst, rel)
        top2 = torch.topk(b, 2).values
        margin = float(top2[0] - top2[1]) / float(b.abs().max())
        flipped = int(a.argmax()) != int(b.argmax())
        log(f"  parity step {i}: max_abs_err={err:.4e} rel={rel:.4e} "
            f"tol={LOGIT_TOL} argmax {'FLIPPED' if flipped else 'same'} "
            f"(top-2 margin {margin:.3e})")
        if rel > LOGIT_TOL or (flipped and margin > LOGIT_TOL):
            raise SystemExit(f"serve: kernel and plain logits disagree at "
                             f"step {i}")
    log(f"serve: ok (prompt {len(prompt)} tokens, prefill + "
        f"{DECODE_COMPARED} decode steps, worst rel {worst:.4e})")
    profile_windows(args, cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches


def qwen_phase(dev):
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    args = serve.parser().parse_args([
        "--arch", "qwen3-8b", "--layers", "4", "--batch", "2",
        "--max-len", "512", "--prefill-chunk", "256", "--device", "cuda"])
    cfg, params = serve.model_for(args)
    plan = lower.serving_plan(cfg, args.max_len, device=dev)
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len, plan=plan,
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=dev)
    rng = torch.Generator().manual_seed(1)
    for slot, n in enumerate((300, 333)):
        eng.begin_prefill(slot, torch.randint(0, cfg.vocab_size, (n,),
                                              generator=rng))
    while eng._pending:
        eng._advance_prefills()
    ops.reset_counts()
    steps = 8
    for _ in range(steps):
        toks = eng.decode_once()
    launches = dict(build.LAUNCHES)
    paths = {r[3] for r in plan.resolutions if r[0] == "decode"}
    log(f"qwen: {cfg.name} d_model={cfg.d_model} cut to {cfg.n_layers} "
        f"layers, prompts 300/333, {steps} decode steps: decode paths "
        f"{sorted(paths)}, launches {launches}, tokens {toks.tolist()}")
    if launches.get("fused_attention_masked", 0) == 0:
        raise SystemExit("qwen: decode never launched "
                         "fused_attention_masked")
    if not torch.isfinite(eng.last_logits).all():
        raise SystemExit("qwen: non-finite logits")
    del params, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.time()
    reports = build.build_all()
    log(f"build: {len(reports)} kernels built in {time.time() - t0:.1f}s "
        f"into {build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    log("kernels:")
    results = kernel_phase(dev, g)
    log("kernels: " + ", ".join(f"{n} ok" for n in results))
    launches = serve_phase(dev)
    qwen_phase(dev)

    record = [dict(name=n, route="cuda", launches=launches.get(n, 0), **r)
              for n, r in results.items()]
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

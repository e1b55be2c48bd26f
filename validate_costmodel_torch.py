"""Measured-vs-predicted validation of the DSE cost model on one H100:
does the schedule the cost model ranks first run fastest, and hold the
least extra memory, on the card?  The H100 counterpart of
``tools/validate_costmodel.py``.

    python3 validate_costmodel_torch.py            # latency cells, then memory
    python3 validate_costmodel_torch.py --memory   # the memory cells alone

Latency cells: starcoder2-7b at full width (E 4608, 36 query heads over
4 KV heads of 128), one block, bf16, B = 1.  Prefill M in PREFILL_M
(crossing M = N = 128); decode contexts C in DECODE_C (crossing
C = 2N = 256) at M = 1 and M = 4.  In each cell the candidates are the
forced kernel paths, lowered through ``lower.lower(..., fuse_q=,
fuse_scores=, fuse_block=)``: ``unfused``, ``fused_attention``,
``qproj_attention`` and, at M = 1, ``decode_megakernel``; the column
``dse`` marks the one the decision rule picks.  Each is

* predicted: ``ExecutionPlan.predict()`` on the DSE's default platform
  (cycles and peak active words of the whole lowered block), as the
  JAX tool predicts;
* measured: its attention sub-block x -> Q -> scores -> out -> .Wo +
  residual (the megakernel's whole launch; the same function for every
  candidate, held to the unfused one within 2e-2) in the serving regime
  (a ``lengths`` mask over the cache, the masked kernels), timed on CUDA
  events on a held stream (``chip_smoke.time_ms``), and its peak device
  memory above its inputs (``torch.cuda.max_memory_allocated``) beside
  the predicted peak words x 2 bytes.

Per cell: does the predicted-faster path run faster, and the
predicted-smaller path hold less memory (pairs whose predictions lie
within 1% of each other carry no ranking and are skipped, as in the JAX
tool)?  Per path: do predicted and measured grow together across the
cells of one phase?

Memory cells (``--memory``): the paged serve mix of ``chip_smoke.py``
(starcoder2-7b at full width, depth cut, six prompts of 300-700 tokens,
pages of 16, a pool that forces a preempt); after every engine step the
plan's ``predicted_kv_pages`` over the live rows' contexts (plus the
reservations of prompts mid-prefill) against the ``PageAllocator``'s
occupancy, as the JAX tool's ``--memory``.

Runs on the card only: without CUDA it exits non-zero.  Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

ARCH = "starcoder2-7b"
PREFILL_M = (64, 128, 256, 1024, 2048)
DECODE_C = (128, 256, 512, 1024, 4096)
DECODE_M = (1, 4)
#: label -> (fuse_q, fuse_scores, fuse_block) of a forced candidate
CANDIDATES = {
    "unfused": (False, False, None),
    "fused_attention": (False, True, None),
    "qproj_attention": (True, True, False),
    "decode_megakernel": (True, True, True),
}
#: every candidate computes the same function: held to the unfused one
SAME_TOL = 2e-2
#: pairs whose predictions lie within this fraction carry no ranking
TIE = 0.01


def cells(prefill=PREFILL_M, decode=DECODE_C, tokens=DECODE_M) -> list:
    """(phase, M, C) of every latency cell."""
    return ([("prefill", m, m) for m in prefill]
            + [("decode", m, c) for m in tokens for c in decode])


def _labels(phase: str, m: int) -> list:
    return [k for k in CANDIDATES
            if k != "decode_megakernel" or (phase == "decode" and m == 1)]


def _inputs(cfg, m: int, c: int, dev, g):
    e, hq, hkv, d = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dt = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    return dict(x=rnd(1, m, e), wq=rnd(e, hq, d, scale=e ** -0.5),
                k=rnd(1, hkv, c, d), v=rnd(1, hkv, c, d),
                wo=rnd(hq, d, e, scale=(hq * d) ** -0.5), res=rnd(1, m, e),
                lens=torch.full((1,), c, dtype=torch.int32, device=dev))


def _pipeline(disp, inp, m: int, c: int):
    """The attention sub-block on ``disp``'s legalised path."""
    from repro_torch import lower
    from repro_torch.kernels import ops
    x, wq, k, v = inp["x"], inp["wq"], inp["k"], inp["v"]
    wo, res, lens = inp["wo"], inp["res"], inp["lens"]
    if disp.path == lower.DECODE_MEGAKERNEL:
        return lambda: ops.decode_block(x, wq, k, v, wo, res, lens,
                                        plan=disp)

    b, _, e = x.shape
    hq, d = wq.shape[1], wq.shape[2]
    wq2, wo2 = wq.reshape(e, hq * d), wo.reshape(hq * d, e)   # views

    def run():
        if disp.path == lower.QPROJ_ATTENTION:
            o = ops.qproj_attention(x, wq, k, v, causal=True,
                                    q_offset=c - m, lengths=lens, plan=disp)
        else:
            q = (x @ wq2).view(b, m, hq, d).transpose(1, 2)
            o = ops.attention(q, k, v, causal=True, q_offset=c - m,
                              lengths=lens, plan=disp)
        return res + o.transpose(1, 2).reshape(b, m, hq * d) @ wo2
    return run


def _entry(path: str) -> str:
    from repro_torch import lower
    return {lower.QPROJ_ATTENTION: "qproj_attention",
            lower.DECODE_MEGAKERNEL: "decode_block"}.get(path, "attention")


def _peak_bytes(fn) -> int:
    """Peak device memory one call of ``fn`` allocates above what is
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def measure_cell(cfg, phase: str, m: int, c: int, dev, g,
                 iters: int = 10) -> list:
    """One latency cell: a row per candidate."""
    import chip_smoke
    from repro_torch import lower
    inp = _inputs(cfg, m, c, dev, g)
    n = m if phase == "prefill" else c
    dse = lower.lower(cfg, phase, n, decode_tokens=m, bucket=n)
    rows, outs = [], {}
    for label in _labels(phase, m):
        fq, fs, fb = CANDIDATES[label]
        plan = lower.lower(cfg, phase, n, decode_tokens=m, bucket=n,
                           fuse_q=fq, fuse_scores=fs, fuse_block=fb)
        disp = lower.dispatch(plan, device=dev,
                              entry=_entry(plan.kernel_path),
                              lengths_masked=True)
        fn = _pipeline(disp, inp, m, c)
        with torch.no_grad():
            outs[label] = fn()
            ms = chip_smoke.time_ms(fn, iters)
            peak = _peak_bytes(fn)
        pred = plan.predict()
        rows.append(dict(
            phase=phase, M=m, C=c, label=label, path=disp.path,
            impl=disp.impl, dse=plan.kernel_path == dse.kernel_path,
            policy=plan.block(0).policy,
            pred_cycles=pred.latency_cycles,
            pred_peak_words=pred.peak_active_words, ms=ms,
            peak_bytes=peak,
            downgrades=[f"{d.from_path}->{d.to_path}: {d.reason}"
                        for d in plan.downgrades]))
    want = outs["unfused"]
    for r in rows:
        _, rel = chip_smoke.rel_err(outs[r["label"]], want)
        r["rel_to_unfused"] = rel
        if not torch.isfinite(outs[r["label"]].float()).all() \
                or rel > SAME_TOL:
            raise SystemExit(f"validate: {r['label']} at {phase} M={m} "
                             f"C={c} computes another function "
                             f"(rel {rel:.3e} > {SAME_TOL})")
    return rows


def concordance(pairs) -> tuple:
    """(agreeing pairs, ranked pairs) of (predicted, measured) pairs:
    does the predicted-smaller one measure smaller?  Predicted near-ties
    (within TIE) are skipped."""
    agree = total = 0
    for i in range(len(pairs)):
        for j in range(i + 1, len(pairs)):
            (p1, m1), (p2, m2) = pairs[i], pairs[j]
            if abs(p1 - p2) <= TIE * max(p1, p2):
                continue
            total += 1
            agree += (p1 < p2) == (m1 < m2)
    return agree, total


def _frac(a: int, t: int) -> str:
    return f"{a}/{t}" if t else "no ranked pair"


def cell_agreement(rows) -> dict:
    """Latency and memory agreement of one cell's rows."""
    lat = concordance([(r["pred_cycles"], r["ms"]) for r in rows])
    mem = concordance([(r["pred_peak_words"], r["peak_bytes"])
                       for r in rows])
    fastest = min(rows, key=lambda r: r["ms"])["label"]
    cycles = [r["pred_cycles"] for r in rows]
    pred_fastest = min(rows, key=lambda r: r["pred_cycles"])["label"] \
        if max(cycles) - min(cycles) > TIE * max(cycles) else "a tie"
    return dict(latency=lat, memory=mem, fastest=fastest,
                predicted_fastest=pred_fastest,
                dse=next(r["label"] for r in rows if r["dse"]))


def print_rows(rows, log=print) -> None:
    log(f"{'cell':22} {'candidate':18} {'dse':3} {'path/impl':26} "
        f"{'pred Mcyc':>10} {'meas ms':>9} {'pred peak B':>12} "
        f"{'meas peak B':>12} {'rel':>9}")
    for r in rows:
        cell = f"{r['phase']} M={r['M']} C={r['C']}"
        log(f"{cell:22} {r['label']:18} {'*' if r['dse'] else '':3} "
            f"{r['path'] + '/' + r['impl']:26} "
            f"{r['pred_cycles'] / 1e6:10.4f} {r['ms']:9.4f} "
            f"{2 * r['pred_peak_words']:12d} {r['peak_bytes']:12d} "
            f"{r['rel_to_unfused']:9.2e}")
        for d in r["downgrades"]:
            log(f"{'':22} ! {d}")


def print_agreement(rows, log=print) -> dict:
    """Per-cell rankings, then per-path scaling; returns the totals."""
    by_cell: dict = {}
    for r in rows:
        by_cell.setdefault((r["phase"], r["M"], r["C"]), []).append(r)
    tot = {"latency": [0, 0], "memory": [0, 0]}
    log("per cell (predicted-faster runs faster; predicted-smaller holds "
        "less):")
    for (phase, m, c), rs in by_cell.items():
        a = cell_agreement(rs)
        for k in tot:
            tot[k][0] += a[k][0]
            tot[k][1] += a[k][1]
        log(f"  {phase} M={m} C={c}: latency {_frac(*a['latency'])}, "
            f"memory {_frac(*a['memory'])}; fastest measured "
            f"{a['fastest']}, predicted {a['predicted_fastest']}, dse "
            f"{a['dse']}")
    log("per path across shapes (predicted and measured grow together):")
    by_path: dict = {}
    for r in rows:
        by_path.setdefault((r["phase"], r["M"] if r["phase"] == "decode"
                            else "*", r["label"]), []).append(r)
    for (phase, m, label), rs in by_path.items():
        if len(rs) < 2:
            continue
        lat = concordance([(r["pred_cycles"], r["ms"]) for r in rs])
        mem = concordance([(r["pred_peak_words"], r["peak_bytes"])
                           for r in rs])
        log(f"  {phase} M={m} {label}: latency {_frac(*lat)}, memory "
            f"{_frac(*mem)}")
    log(f"all cells: latency {_frac(*tot['latency'])}, memory "
        f"{_frac(*tot['memory'])}")
    return tot


def validate(dev, cell_list=None, iters: int = 10, log=print) -> list:
    from repro_torch import configs
    cfg = configs.get_config(ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for phase, m, c in cell_list or cells():
        rows += measure_cell(cfg, phase, m, c, dev, g, iters)
    return rows


def validate_memory(dev, layers: int = 4, log=print) -> dict:
    """The memory cells on the paged serve mix; returns the summary."""
    import chip_smoke
    from repro_torch import lower
    from repro_torch.launch import serve
    from repro_torch.serve import RequestBatcher
    from repro_torch.serve.engine import make_serving_plan

    args = serve.parser().parse_args([
        "--arch", ARCH, "--batch", "4", "--requests", "6", "--max-len",
        "1024", "--max-new", "16", "--prefill-chunk", "256", "--layers",
        str(layers), "--device", str(dev)])
    cfg, params = serve.model_for(args)
    page = chip_smoke.PAGE
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=chip_smoke.PROMPT_LENS)
    num_pages = 2 + sum(-(-(len(r.prompt) + 1) // page)
                        for r in requests[:args.batch])
    lower.clear_plan_cache()
    plan = make_serving_plan(cfg, args.max_len, device=dev, paged=True,
                             page_size=page)
    eng = chip_smoke.paged_engine(params, cfg, args, plan, num_pages, dev)
    exe = lower.resolve_plan(cfg, "decode", args.max_len,
                             n_blocks=cfg.n_layers)
    s = dict(steps=0, agree=0, pred_peak=0, meas_peak=0, preempts=0,
             worst=0)
    orig_step, orig_pre = eng.step, eng.preempt

    def preempt(slot):
        s["preempts"] += 1
        return orig_pre(slot)

    def step():
        out = orig_step()
        lens = [eng.row_ctx[i] for i in range(args.batch) if eng.live[i]]
        pred = exe.predicted_kv_pages(lens, page) + sum(
            eng.allocator.pages_for(p["tokens"].shape[1] + 1)
            for p in eng._pending.values())
        meas = eng.allocator.used_pages
        s["steps"] += 1
        s["agree"] += pred == meas
        s["worst"] = max(s["worst"], abs(pred - meas))
        s["pred_peak"] = max(s["pred_peak"], pred)
        s["meas_peak"] = max(s["meas_peak"], meas)
        return out

    eng.step, eng.preempt = step, preempt
    bat = RequestBatcher(args.batch, max_len=args.max_len)
    for r in requests:
        bat.submit(r)
    done = bat.serve(eng, max_steps=2000)
    w = (cfg.kv_heads, cfg.head_dim, cfg.n_layers)
    word = 2 * w[0] * w[1] * w[2]
    s.update(completed=len(done), requests=len(requests),
             pool_pages=num_pages - 1, allocator_peak=eng.allocator.peak_used,
             pred_peak_kv_words=exe.predicted_kv_page_words(
                 [s["pred_peak"] * page], page, *w),
             meas_peak_kv_words=s["meas_peak"] * page * word,
             dense_kv_words=args.batch * args.max_len * word)
    log(f"memory: {cfg.name} cut to {cfg.n_layers} layers, {s['requests']} "
        f"requests ({s['completed']} completed), pages of {page}, pool "
        f"{s['pool_pages']} pages, {s['preempts']} preempts")
    log(f"  per step: predicted pages equal the allocator's occupancy at "
        f"{s['agree']}/{s['steps']} steps (worst difference {s['worst']} "
        f"pages); peak predicted {s['pred_peak']}, measured "
        f"{s['meas_peak']}, allocator peak_used {s['allocator_peak']}")
    log(f"  peak KV words: predicted {s['pred_peak_kv_words']}, measured "
        f"{s['meas_peak_kv_words']}, dense {args.batch} x {args.max_len} "
        f"rows {s['dense_kv_words']}")
    del eng, params
    torch.cuda.empty_cache()
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--memory", action="store_true",
                    help="the memory cells alone")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--layers", type=int, default=4,
                    help="depth of the memory cells' model")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("validate_costmodel_torch: torch.cuda.is_available() is "
              "False; this validation needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    from repro_torch.kernels import build
    build.build_all()
    if not a.memory:
        rows = validate(dev, iters=a.iters)
        print_rows(rows)
        print_agreement(rows)
    validate_memory(dev, a.layers)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

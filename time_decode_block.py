"""Times the decode megakernel #3 (fused_decode_block) on one H100 over a
batch sweep, for one or more source trees of the port, each in a
process of its own:

    python3 time_decode_block.py                 # this checkout's src/
    python3 time_decode_block.py OLD/src src     # OLD, new, new, OLD
    python3 time_decode_block.py --variants      # src/ and VARIANTS

For each tree: starcoder2-7b's widths (E=4608, Hq=36 over Hkv=4,
D=Dv=128), bf16, random inputs from seed 0, a 1024-key cache, RoPE;
#3 at B = 1, 4, 8, 16 and 32 with the rows' lengths cycling through
chip_smoke.py's table lengths (301, 460, 612, 705), then, as the
ablation that leaves the weight stream alone, B = 4 and 16 with every
length 1 (no attention work beyond one key).  Each time is three
timings of 20 calls by chip_smoke.py's time_ms (CUDA events, the stream
held while the calls are enqueued), the calls cycling through three
distinct (Wq, Wo) pairs, 255 MB in all against the 50 MB L2: each call
reads its weights from device memory, as a decode step that runs 32
layers does.  Also #3's bound at each B (chip_smoke.py's bound: bytes
over 3.35 TB/s).  Where the tree's kernel takes a phase trace
(fused_decode_block.PHASE_TRACE), three traced calls at B = 4 and 16:
each phase's end over the blocks.  With several trees the first runs
first and last.
``--variants`` times this checkout's src/ against copies under build/
with one change each to csrc/fused_decode_block.cu (VARIANTS: another
ring depth; the launch cut after phase (a), so that only Wq's stream
and the launch are left, its output not used), in the order a, b, ...,
b, a.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "fused_decode_block.cu"
#: variant -> (the committed line of SOURCE, the variant's)
VARIANTS = {
    "stages 3": ("constexpr int kStages = 6;", "constexpr int kStages = 3;"),
    "stages 10": ("constexpr int kStages = 6;",
                  "constexpr int kStages = 10;"),
    "Wq only": ("  gemv_phase<false>(ga, pa, a, ring, a.qpart, D, false);\n",
                "  gemv_phase<false>(ga, pa, a, ring, a.qpart, D, false);\n"
                "  return;\n"),
}
BATCHES = (1, 4, 8, 16, 32)
ABLATION = (4, 16)
COPIES = 3
LENS = (301, 460, 612, 705)


def time_tree(label: str) -> None:
    # repro_torch first, from PYTHONPATH (the tree under test): importing
    # chip_smoke then puts this checkout's src/ on sys.path, but the
    # package is already bound
    import repro_torch  # noqa: F401
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_decode_block as fdb
    from repro_torch.kernels.fused_decode_block import fused_decode_block

    build.build_all(["fused_decode_block"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                                 * scale).to(torch.bfloat16)
    E, HQ, HKV, D = (cs.STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    skv, theta = 1024, 1e5
    weights = [(rnd(E, HQ, D, scale=E ** -0.5),
                rnd(HQ, D, E, scale=(HQ * D) ** -0.5))
               for _ in range(COPIES)]

    def case(b, lens):
        x, res = rnd(b, 1, E), rnd(b, 1, E)
        k, v = rnd(b, HKV, skv, D), rnd(b, HKV, skv, D)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        turn = [0]

        def call():
            wq, wo = weights[turn[0] % COPIES]
            turn[0] += 1
            return fused_decode_block(x, wq, k, v, wo, res, lengths,
                                      rope_theta=theta)

        times = [cs.time_ms(call, 20) for _ in range(3)]
        byts = 2 * (3 * b * E + 2 * E * HQ * D + sum(lens) * HKV * 2 * D) \
            + 4 * b
        bms, _ = cs.bound(byts, 2 * b * E * HQ * D * 2
                          + 4 * HQ * D * sum(lens))
        return " ".join(f"{t:.4f}" for t in times) + f" (bound {bms:.4f})"

    parts = [f"B={b} ms {case(b, [LENS[i % 4] for i in range(b)])}"
             for b in BATCHES]
    parts += [f"B={b} lengths 1 ms {case(b, [1] * b)}" for b in ABLATION]
    print(f"{label}: " + "; ".join(parts), flush=True)
    if hasattr(fdb, "PHASE_TRACE"):
        for b in ABLATION:
            phases(b, [LENS[i % 4] for i in range(b)])


def phases(b, lens):
    """One traced call of #3 (fused_decode_block.PHASE_TRACE) after two
    untraced ones, three times: per stamp, the min / median / max over
    the blocks of its time since the earliest block's start (us)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import fused_decode_block as fdb
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                                 * scale).to(torch.bfloat16)
    E, HQ, HKV, D = (cs.STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    pairs = [(rnd(E, HQ, D, scale=E ** -0.5),
              rnd(HQ, D, E, scale=(HQ * D) ** -0.5)) for _ in range(COPIES)]
    x, res = rnd(b, 1, E), rnd(b, 1, E)
    k, v = rnd(b, HKV, 1024, D), rnd(b, HKV, 1024, D)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("end (a)", "past barrier (a)", "first item's q",
             "its tiles", "its ticket", "end (b)", "past barrier (b)",
             "end")
    for rep in range(3):
        for i, (wq, wo) in enumerate(pairs):
            if i == COPIES - 1:
                fdb.PHASE_TRACE = torch.zeros((fdb.STAMPS, n_sms),
                                              dtype=torch.int64, device=dev)
            fdb.fused_decode_block(x, wq, k, v, wo, res, lengths,
                                   rope_theta=1e5)
        torch.cuda.synchronize()
        t = fdb.PHASE_TRACE.cpu().double()
        fdb.PHASE_TRACE = None
        t0 = t[0].min()
        cols = []
        for i, n in enumerate(names):
            row = t[i + 1][t[i + 1] > 0]   # blocks that did not get here: 0
            row = (row - t0) / 1e3
            cols.append(f"{n} {row.min():.2f}/{row.median():.2f}/"
                        f"{row.max():.2f}" if row.numel() else f"{n} -")
        t = (t - t0) / 1e3
        print(f"  B={b} traced call {rep}: us since the first start "
              f"(min/median/max over {n_sms} blocks): start "
              f"{t[0].max():.2f} late at most; " + "; ".join(cols),
              flush=True)


def variant_src(label: str) -> Path:
    """A copy of the port under build/ with one change to SOURCE."""
    old, new = VARIANTS[label]
    dst = ROOT / "build" / ("decode_block_" + label.replace(" ", "_"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    path = dst / "src" / "repro_torch" / "kernels" / "csrc" / SOURCE
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{SOURCE}: not one {old!r}")
    path.write_text(text.replace(old, new))
    return dst / "src"


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--one":
        time_tree(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_decode_block: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    print(f"card: {chip_smoke.card_line()}", flush=True)
    if sys.argv[1:] == ["--variants"]:
        trees = [str(ROOT / "src")] + [str(variant_src(v)) for v in VARIANTS]
    else:
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

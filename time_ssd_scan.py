"""Times the Mamba-2 SSD scan #11 (ssd_scan) on one H100 over a batch and
length sweep, for one or more source trees of the port, each in a
process of its own:

    python3 time_ssd_scan.py                 # this checkout's src/
    python3 time_ssd_scan.py OLD/src src     # OLD, new, new, OLD
    python3 time_ssd_scan.py --variants      # src/ and VARIANTS

For each tree: mamba2-130m's SSD widths (H=24 heads of P=64, G=1 group,
state S=128, chunk 128), bf16, random inputs from seed 0 with chip_smoke.py's
scales (a dt about -1 a position); #11 at B = 1, 4, 8 and L = 188, 512,
2048, with a non-zero initial state h0 and, as the ablation, without
one (the first chunk's C.h product skipped); each time three timings of
20 calls by chip_smoke.py's time_ms (CUDA events, the stream held while
the calls are enqueued), and the bound (chip_smoke.py's ssd_work and
bound: bytes over 3.35 TB/s or operations over 989 TFLOP/s).  With
several trees the first runs first and last.
``--variants`` times this checkout's src/ against copies under build/
with one change each to csrc/ssd_scan.cu (VARIANTS: the chain's wait
cut, so that each chunk reads whatever state its slot holds: the time
of the state-free work and the launch alone, its output not used), in
the order a, b, ..., b, a.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "ssd_scan.cu"
#: variant -> (the committed line of SOURCE, the variant's)
VARIANTS = {
    "no chain wait": (
        "      while (ld_acquire(f) != a.epoch) __nanosleep(20);\n",
        "      (void)f;\n"),
}
BATCHES = (1, 4, 8)
LENGTHS = (188, 512, 2048)
#: (B, L) of the traced calls
TRACED = ((1, 188), (4, 2048), (8, 188))


def time_tree(label: str) -> None:
    # repro_torch first, from PYTHONPATH (the tree under test): importing
    # chip_smoke then puts this checkout's src/ on sys.path, but the
    # package is already bound
    import repro_torch  # noqa: F401
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan

    build.build_all(["ssd_scan"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    H, P, G, S, C = (cs.MAMBA[k] for k in ("H", "P", "G", "S", "CHUNK"))

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    parts = []
    for b in BATCHES:
        for length in LENGTHS:
            bf = torch.bfloat16
            args = (r(b, length, H, P).to(bf),
                    torch.nn.functional.softplus(r(b, length, H)).to(bf),
                    -torch.exp(r(H)), (r(b, length, G, S) * 0.3).to(bf),
                    (r(b, length, G, S) * 0.3).to(bf), r(H))
            h0 = r(b, H, P, S) * 0.5
            row = []
            for tag, init in (("h0", h0), ("no h0", None)):
                times = [cs.time_ms(lambda: ssd_scan(
                    *args, chunk=C, h0=init, return_final_state=True), 20)
                    for _ in range(3)]
                byts, flops = cs.ssd_work(b, length, H, P, G, S, C, 2,
                                          init is not None)
                bms, _ = cs.bound(byts, flops)
                row.append(f"{tag} " + " ".join(f"{t:.4f}" for t in times)
                           + f" (bound {bms:.4f})")
            parts.append(f"B={b} L={length} ms " + ", ".join(row))
    print(f"{label}:\n  " + "\n  ".join(parts), flush=True)
    from repro_torch.kernels import ssd_scan as sk
    if hasattr(sk, "PHASE_TRACE"):
        for b, length in TRACED:
            phases(b, length)


def phases(b: int, length: int) -> None:
    """One traced call of #11 (ssd_scan.PHASE_TRACE) after two untraced
    ones, with h0: over the items, the median of each chunk's start and
    end (us since the first item's start), and over (item, head) the
    median and max of each phase: the item's own state, the wait for
    the incoming one, the publishing, y."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as sk
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    H, P, G, S, C = (cs.MAMBA[k] for k in ("H", "P", "G", "S", "CHUNK"))

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    bf = torch.bfloat16
    args = (r(b, length, H, P).to(bf),
            torch.nn.functional.softplus(r(b, length, H)).to(bf),
            -torch.exp(r(H)), (r(b, length, G, S) * 0.3).to(bf),
            (r(b, length, G, S) * 0.3).to(bf), r(H))
    h0 = r(b, H, P, S) * 0.5
    plan = sk.ssd_plan(b, length, H, P, G, S, C,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    for i in range(3):
        if i == 2:
            sk.PHASE_TRACE = torch.zeros(
                (plan.n_items, 1 + sk.STAMPS_PER_HEAD * plan.ht),
                dtype=torch.int64, device=dev)
        sk.ssd_scan(*args, chunk=C, h0=h0)
    torch.cuda.synchronize()
    t = sk.PHASE_TRACE.cpu().double()
    sk.PHASE_TRACE = None
    t0 = t[:, 0].min()
    t = (t - t0) / 1e3
    items = list(sk.ssd_items(plan, b, H, G))
    heads = t[:, 1:].reshape(plan.n_items, plan.ht, sk.STAMPS_PER_HEAD)
    nh = torch.tensor([it[4] for it in items])
    live = torch.arange(plan.ht)[None] < nh[:, None]        # (items, ht)
    end = torch.stack([heads[i, n - 1, 4] for i, n in enumerate(nh)])
    chunk_of = torch.tensor([it[0] for it in items])
    rows = []
    for j in range(plan.nj):
        m = chunk_of == j
        rows.append(f"{j}: {t[m, 0].median():.1f}-{end[m].median():.1f}")
    names = ("own state", "wait", "publish", "y", "head")
    spans = [heads[..., 1] - heads[..., 0], heads[..., 2] - heads[..., 1],
             heads[..., 3] - heads[..., 2], heads[..., 4] - heads[..., 3],
             heads[..., 4] - heads[..., 0]]
    cols = [f"{n} {s[live].median():.2f}/{s[live].max():.2f}"
            for n, s in zip(names, spans)]
    print(f"  traced B={b} L={length} ({plan.n_items} items of {plan.ht} "
          f"heads x {plan.pw} columns): span {end.max():.1f} us; chunk "
          f"j start-end medians (us): " + ", ".join(rows), flush=True)
    print("    per (item, head) median/max us: " + "; ".join(cols),
          flush=True)


def variant_src(label: str) -> Path:
    """A copy of the port under build/ with one change to SOURCE."""
    old, new = VARIANTS[label]
    dst = ROOT / "build" / ("ssd_scan_" + label.replace(" ", "_"))
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
        print("time_ssd_scan: needs an NVIDIA GPU", file=sys.stderr)
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

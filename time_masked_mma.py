"""Times the bf16 tensor-core bodies of the masked and Q-projection
kernels on one H100 at their table shapes (PERF.md section 6):

    python3 time_masked_mma.py

  #1  fused_attention_masked, B=1, Hq=36 over Hkv=4, a 256-row chunk at
      length 256 (the one-pass body);
  #2  fused_qproj_attention_masked, B=1, a 188-row chunk at length 700,
      E=4608, and the same with E=64 (the projection all but removed:
      what the attention part of the kernel costs);
  #5' fused_qproj_attention_masked at #5's rung-down decode shape (B=4,
      M=1, lengths 301..705), the dense twin of #5;
  #10 fused_qproj_attention_fwd, B=2, Sq = Skv = 2048, causal.

Each variant of the sources runs in a process of its own, in the order
a, b, c, c, b, a: "committed" is the tree as it stands (the masked
body's K/V tiles double-buffered, the Q projection's four steps in
flight), "K/V 3" a copy under build/ with a K/V ring of three, "proj 2"
one with two projection steps in flight.  Each process builds its kernels
and prints its build time and three timings of each shape: CUDA events
over 20 calls (5 for #10), enqueued while a sleep kernel holds the
stream, so a call shorter than its host-side launch is timed by the
card, not by the host.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: variant -> (source, its stage count as committed, the variant's)
VARIANTS = {"K/V 3": ("masked_mma.cuh", "constexpr int kStages = 2;",
                      "constexpr int kStages = 3;"),
            "proj 2": ("fused_qproj_attention.cu",
                       "constexpr int kStages = 4;",
                       "constexpr int kStages = 2;")}


def variant_src(label: str) -> Path:
    """A copy of the port under build/ with one stage count changed."""
    name, old, new = VARIANTS[label]
    dst = ROOT / "build" / ("masked_mma_" + label.replace(" ", "").replace(
        "/", ""))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    path = dst / "src" / "repro_torch" / "kernels" / "csrc" / name
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: not one '{old}'")
    path.write_text(text.replace(old, new))
    return dst / "src"


def time_one(label: str) -> None:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.fused_attention import fused_attention_masked
    from repro_torch.kernels.fused_qproj_attention import (
        fused_qproj_attention_fwd, fused_qproj_attention_masked)

    t0 = time.time()
    build.build_all(["fused_attention_masked",
                     "fused_qproj_attention_masked"])
    built = time.time() - t0
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                                 * scale).to(torch.bfloat16)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    E, HQ, HKV, D = 4608, 36, 4, 128
    k, v = rnd(1, HKV, 1024, D), rnd(1, HKV, 1024, D)
    q = rnd(1, HQ, 256, D)
    x, wq = rnd(1, 188, E), rnd(E, HQ, D, scale=E ** -0.5)
    x64, wq64 = rnd(1, 188, 64), rnd(64, HQ, D, scale=64 ** -0.5)
    k4, v4 = rnd(4, HKV, 1024, D), rnd(4, HKV, 1024, D)
    x4 = rnd(4, 1, E)
    xt, kt, vt = rnd(2, 2048, E), rnd(2, HKV, 2048, D), rnd(2, HKV, 2048, D)
    theta = 1e5

    # sleep-kernel cycles per ms, calibrated on CUDA events
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(10_000_000)
    t1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / t0.elapsed_time(t1)

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(2 * host_ms * iters, 1000.0)
                              * cycles_per_ms))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    l256, l700 = i32([256]), i32([700])
    l4 = i32([301, 460, 612, 705])
    cases = {
        "#1": lambda: fused_attention_masked(q, k, v, l256),
        "#2": lambda: fused_qproj_attention_masked(
            x, wq, k, v, l700, rope_theta=theta),
        "#2 E=64": lambda: fused_qproj_attention_masked(
            x64, wq64, k, v, l700, rope_theta=theta),
        "#5'": lambda: fused_qproj_attention_masked(
            x4, wq, k4, v4, l4, rope_theta=theta),
        "#10": lambda: fused_qproj_attention_fwd(xt, wq, kt, vt,
                                                 rope_theta=theta),
    }
    parts = []
    for name, fn in cases.items():
        n = 5 if name == "#10" else 20
        parts.append(f"{name} ms " + " ".join(f"{ms(fn, n):.4f}"
                                             for _ in range(3)))
    print(f"{label}: build {built:.1f}s  " + "  ".join(parts), flush=True)


def main() -> int:
    if len(sys.argv) == 2:
        time_one(sys.argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_masked_mma: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    srcs = {"committed": ROOT / "src",
            **{label: variant_src(label) for label in VARIANTS}}
    for label in ("committed", "K/V 3", "proj 2", "proj 2", "K/V 3",
                  "committed"):
        env = {**os.environ, "PYTHONPATH": str(srcs[label])}
        done = subprocess.run([sys.executable, __file__, label], env=env)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

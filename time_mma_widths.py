"""Times the bf16 tensor-core bodies of #7 (fused_attention_fwd), #8
(fused_attention_bwd_dq) and #9 (fused_attention_bwd_dkv) on one H100
at starcoder2-7b's training shape
(B=2, Hq=36, Hkv=4, Sq = Skv = 2048, D = 128, causal), once on the
D = Dv = 128 instantiation the training path runs and once on the
instantiation for any even width, which a copy of the kernel sources
under build/ launches in its place:

    python3 time_mma_widths.py

Each variant runs in a process of its own, in the order d128, any, any,
d128; each process builds its kernels and prints its build time and
three timings (CUDA events, 20 calls each) of each kernel.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DISPATCH = "vec && D == 128 && Dv == 128 ?"


def variant_src() -> Path:
    """A copy of the port under build/ whose launchers never pick the
    D = Dv = 128 instantiation."""
    dst = ROOT / "build" / "mma_widths"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch")
    for name, bodies in (("fused_attention.cu", 1),
                         ("fused_attention_bwd.cu", 2)):
        path = dst / "src" / "repro_torch" / "kernels" / "csrc" / name
        text = path.read_text()
        if text.count(DISPATCH) != bodies:
            raise SystemExit(f"{name}: not one width dispatch per body")
        path.write_text(text.replace(DISPATCH, "false ?"))
    return dst / "src"


def time_one(label: str) -> None:
    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.fused_attention import (
        fused_attention_bwd_dkv, fused_attention_bwd_dq, fused_attention_fwd)

    t0 = time.time()
    build.build_all(["fused_attention_fwd", "fused_attention_bwd_dkv"])
    built = time.time() - t0
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v, do = rnd(2, 36, 2048, 128), rnd(2, 4, 2048, 128), \
        rnd(2, 4, 2048, 128), rnd(2, 36, 2048, 128)
    o, lse = fused_attention_fwd(q, k, v)
    delta = ref.attention_delta(o, do)

    def ms(fn, iters=20):
        for _ in range(3):
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

    fwd = [ms(lambda: fused_attention_fwd(q, k, v)) for _ in range(3)]
    dq = [ms(lambda: fused_attention_bwd_dq(q, k, v, do, lse, delta))
          for _ in range(3)]
    dkv = [ms(lambda: fused_attention_bwd_dkv(q, k, v, do, lse, delta))
           for _ in range(3)]
    print(f"{label}: build {built:.1f}s  fused_attention_fwd ms "
          f"{' '.join(f'{t:.4f}' for t in fwd)}  fused_attention_bwd_dq ms "
          f"{' '.join(f'{t:.4f}' for t in dq)}  fused_attention_bwd_dkv ms "
          f"{' '.join(f'{t:.4f}' for t in dkv)}", flush=True)


def main() -> int:
    if len(sys.argv) == 2:
        time_one(sys.argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_mma_widths: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    srcs = {"d128": ROOT / "src", "any": variant_src()}
    for label in ("d128", "any", "any", "d128"):
        env = {**os.environ, "PYTHONPATH": str(srcs[label])}
        done = subprocess.run([sys.executable, __file__, label], env=env)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

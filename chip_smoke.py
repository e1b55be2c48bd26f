"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card

Phases, in order:
  1. card   -- the card's name and power limit, torch and CUDA versions;
  2. build  -- every CUDA kernel built from csrc/, one nvcc per source,
               all started together; ptxas's registers and spills, and
               one line counting the HMMA (tensor-core) instructions in
               the SASS of every instantiation of the bf16 tensor-core
               bodies (#1-#11);
  3. kernels-- each kernel against its plain PyTorch version on the card
               in bf16, at the serve paths' full-width shapes and at edge
               cases (a length of 0, lengths off the tile and page grids,
               Sq > 1 under the causal anchor, pages of 8 and 128, a dead
               row whose table row is zeros), with its time, the plain
               version's, the card's bound and a library yardstick; each
               paged kernel also bit for bit against its dense kernel on
               the gathered cache;
  4. plan   -- the DSE's ranking on the card: three cells of
               validate_costmodel_torch.py (starcoder2-7b at full width,
               one block, prefill M = 64 and 256, decode M = 1 at
               C = 1024), each candidate kernel path's attention
               sub-block timed and its peak memory read beside the
               plan's predicted cycles and peak words;
  5. serve  -- the port's launch/serve path: starcoder2-7b at full width
               and depth, random weights from a seed, 6 requests through
               the continuous-batching engine; every dense kernel must
               launch, and one request rerun with impl forced to the
               plain versions must give the same logits within
               tolerance; then the mix again and a steady decode window
               under torch.profiler: device time by kernel and idle
               share.  Every serve reads its plans from the DSE
               (lowering.lower on a plan-cache miss) on a cleared plan
               cache after a garbage collection, prints each cold
               lowering's host ms, the run's collections and its tok/s
               (host ms per step in the chaos phase) with and without
               that plan resolution, and checks each served plan has a
               source schedule and one alike BlockPlan a layer.  With
               the same weights: the mix through the paged
               engine with a pool that forces a preempt and a resume
               (the dense serve's tokens, fused_decode_block_paged, KV
               memory and concurrency), a demotions=1 paged run
               whose decode takes fused_qproj_attention_paged, and
               the chaos phase: the paged mix under ServingSupervisor
               with the audit on every step, fault-free (the batcher's
               tokens, the host time per step of both), with every
               fault kind (a cuda kernel fault, times=2, that takes
               decode from #6 down to #5 and #4 and cooloff back to
               #6; a NaN, an OOM, a preemption storm), a seeded
               schedule twice (the same ledger and fired log), and a
               crash restored from a snapshot (the uncrashed tokens;
               snapshot size, write and restore times); last the
               roofline: the dry-run's roofline terms (launch/dryrun.py
               roofline_cell) of starcoder2-7b decode_32k and train_4k
               on the (16, 16) mesh, counted on the meta device under a
               fake process group in a child process started after the
               build (it runs on the host beside the card's phases),
               printed beside the card's name and power limit; then one
               bf16 decode step of the served model at B=4 counted on
               the card (the kernels launched) and the same step's
               shapes counted on the meta device: FLOPs and collective
               bytes must be equal;
  6. new dense -- qwen3-14b (GQA group 5) and starcoder2-15b (group
               12) at full width, cut to 4 layers: the serve mix's
               prompts through launch/serve (#1-#3; qwen3-14b's qk-norm
               takes #1 only), one request against the plain versions;
  7. qwen   -- qwen3-8b at full width, depth cut to 4 layers, two
               prompts; its decode past C = 2N runs fused_attention_masked
               on the dense engine and fused_attention_paged on the paged
               one;
  8. mamba forward -- mamba2-130m at full width and depth (24 layers),
               the cache-free models.transformer.forward at B=4, L=2048,
               bf16, no grad: the TPU's #11 path, 24 ssd_scan launches;
               each layer's ssd_scan against the plain version on the
               same inputs, and the logits against the plain versions'
               in fp32 compute (bf16 logits reported beside the plain
               versions' own spread at another chunk size);
  9. mamba serve -- launch/serve.run on mamba2-130m at full depth with
               the dense serve's mix (no serving plan): tokens, tok/s,
               median decode step, ssd_scan launches against 24 x the
               prompts' multi-token prefill chunks; one request again on
               the plain versions with each prefill chunk's ssd_scan
               beside them on the same inputs, and its logits on the
               kernel against the plain versions' in fp32 compute; then
               the mix and a steady decode window under torch.profiler;
  10. qproj train -- the cache-free ops.qproj_attention entry point,
               forward and backward at starcoder2-7b's training shapes
               (fused_qproj_attention_fwd, then the two backward
               kernels), its four gradients against the plain versions;
  11. train parity -- starcoder2-7b at full width cut to 2 layers: the
               loss and every gradient of one batch, then two AdamW
               steps, on the kernels and on the plain versions;
  12. train -- launch/train.train_loop at full width and depth: 32
               layers, remat full, bf16 moments, B=2, seq 2048, 3 steps:
               loss, grad_norm, step time, tokens/s, peak memory and the
               training kernels' launches per step; every per-layer
               gradient finite and non-zero; then one step under
               torch.profiler, by part;
  13. frontends -- hubert-xlarge (48 layers, 16 heads of 80, non-causal)
               and internvl2-2b (24 layers) at full width and depth:
               hubert's encoder forward on audio frames (B=2, S=4096:
               48 launches of #7, logits against the plain versions),
               then three training steps on {"embeds", "targets"}
               batches under each remat policy (none, full, dots: step
               ms, tokens/s, peak memory, launches, garbage collection's
               host time, a profiled step's device time and idle share,
               the first loss equal across them); internvl2-2b served with 256 patch rows
               before 300 text tokens (B=4, prefill on the plan's path,
               16 decode steps, logits against the plain versions, the
               plan's path per call), then one training step on its VLM
               batch (remat full: step ms, peak memory);
  14. moe   -- phi3.5-moe-42b-a6.6b at full width (16 experts of 6400,
               top-2; 32 query heads over 8 KV heads), every earlier
               phase's weights freed first.  Served at 28 of its 32
               layers (73.3 GB of bf16 weights) with the serve phase's
               mix: launch/serve.run on the dense engine (#1-#3; median
               step against the weights' bytes floor, tok/s with and
               without plan resolution, peak memory), the dense engine
               again and the paged engine (page 16, the paged serve's
               pool: a preempt and its resume, #6); a steady B=4 decode
               window, then profiled (device time by kernel and by MoE
               op, the expert products' TFLOP/s, idle share); the paged
               engine at its own rung and one and two rungs down (#6,
               #5, #4).  Gates: (a) each attention call of one
               request's plain run (its first chunk, later chunks, 4
               decode steps) and of the three paged runs, the kernel
               beside the plain version on the same input and cache,
               KERNEL_TOL; (b) 4 layers in fp32 compute, prefill + 8
               decode steps on #1-#3, logits within MOE_FP32_TOL of the
               plain versions'; (c) the paged tokens equal the dense
               engine's.  Then launch/train.train_loop at 4
               layers (remat full, bf16 moments, B=2, seq 2048, 3
               steps: loss, moe_lb_loss, moe_z_loss, step ms, tokens/s,
               peak memory, #7-#9 launches), the first step's gradients
               taken twice from the same state and equal bit for bit;
               then one step under torch.profiler, by part and by MoE
               op;
  15. mla   -- deepseek-v3-671b at full width cut to 4 layers (3
               dense-prefix layers, 1 MoE layer of 256 experts: 30.2 GB
               of bf16 weights), every earlier phase's weights freed
               first.  #1's wide body (D 576, Dv 512, 128 query heads
               over one latent head, V its first 512 columns) against
               its plain version at the decode (B=4, C 1153-2048) and
               prefill (Sq 1024, C 2048) shapes in bf16 and fp32, per
               row, bitwise repeatable, a dropped tile rejected, timed
               beside SDPA; then MLA_PROMPTS through launch/serve.run
               (chunks of 1024, max_len 2048, 24 new tokens), the
               regimes counted from ops.CALLS and build.LAUNCHES:
               chunks of more than 512 rows on #1, of at most 512 on the
               reference, decode at C <= 1152 on the reference and past
               it on #1, a request crossing C = 1152 mid-decode.  Gates:
               (a) the mix again with every attention call beside #1's
               plain version on its input, per row; (b) the 4 layers in
               fp32 compute (the weights upcast) on the kernels against
               the plain versions, 1e-4.  A profiled B=4 decode window
               gives the device's busy time and idle share;
  16. mla train -- deepseek-v3-671b's dense layers at full width: 3
               MLA layers (128 heads, D 192, Dv 128) with a d_ff 18432
               SwiGLU, no MoE, no prefix (3.60 G parameters), every
               earlier phase's weights freed first.  The loss and every
               gradient of one B=2, seq 2048 batch on the kernels
               against the plain versions (PARITY_REL, KERNEL_TOL);
               then launch/train.train_loop (remat full, bf16 moments,
               B=2, seq 2048, 3 steps: loss, step ms, tokens/s, peak
               memory against the 28.8 GB state, #7/#8/#9 6/3/3 a
               step), the first step's gradients taken twice and equal
               bit for bit, every gradient leaf finite and non-zero;
               then one profiled step by part;
  17. mamba train -- mamba2-130m at full width, cut to 6 of its 24
               layers (MAMBA_TRAIN_LAYERS):
               launch/train.train_loop, remat full, bf16 moments, B=8,
               seq 2048, 3 steps, through short_train (step ms, tokens/s,
               peak memory, the first step's gradients bit for bit, a
               profiled step by part); no ssd_scan launch in a step (the
               kernel has no backward: under autograd ops.ssd takes the
               plain scan, counted as ("ssd", "torch"));
  18. jamba serve -- jamba-1.5-large-398b at full width cut to one
               period of 8 layers (attention at offset 3: 64 query heads
               over 8 of 128; seven Mamba-2 layers of 256 heads of 64 in
               8 groups, state 128) with dense FFNs (moe=False: 9.008 G
               parameters, 18.02 GB in bf16; the MoE period is 90.49 GB),
               every earlier phase's weights freed first.  The serve mix
               through launch/serve.run with no serving plan: ssd_scan on
               each Mamba layer's multi-token chunks, the attention layer
               on the shape-only plan at the cache's max_len (#1 for
               decode and the chunks it fuses); the median decode step
               against the bytes floor, tok/s, peak memory.  Gates: (a)
               one request on the plain versions, each Mamba layer's #11
               and the attention layer's #1 beside them on the same
               inputs, KERNEL_TOL; (b) that request in fp32 compute on the
               kernels against the plain versions, JAMBA_FP32_TOL; then a
               profiled B=4 decode window (device time, idle share);
  19. mesh  -- the multi-device slice: two gloo ranks spawned once on
               cuda:0 (launch.mesh.spawn), their collectives staged
               through host memory.  (a) starcoder2-7b at full width,
               2 layers (MESH_LAYERS), the serve mix through RequestBatcher with
               head_parallel_decode under lower_to_mesh (the DSE's
               round-robin head allocation on multi_core_array(2)): #1
               and #2 launched on each rank's prefill chunks, each
               launch per row against its plain version; (b) the same
               with distributed_decode (sequence-sharded); both on the
               sharded serving state (each rank its blocks, drawn from
               seed 0: its heads, MLP columns, vocabulary rows and
               cache slice), each rank's held bytes of parameters and
               caches equal to launch/dryrun.py's per-device figure for
               (1, 2) at B=4, max_len 1024, its peak beside the
               replicated serve's on a mesh of one rank; each
               against a mesh of one rank and the mesh-less engine on
               #1-#3 (bf16: tie_check, logits within LOGIT_TOL) and, in
               fp32 compute, against one rank (tokens equal, logits
               within MESH_TOL); (c) phi3.5-moe's MoE layer at full
               width, global, moe_shard_map_ep and moe_local_dispatch:
               outputs and the expert weights' gradients of sum(y**2)
               per row within ROW_TOL of the global path's; (d)
               launch/train.train_loop through FSDP (each rank holds
               its blocks of the training state), 1 layer, B=2 a
               rank, seq 1024, 3 steps: #7-#9 on each rank, losses
               within MESH_TRAIN_REL of rank 0's single-rank B=4 run,
               the bytes each rank holds against launch/dryrun.py's
               per-device figure for the mesh and its peak; (e)
               remesh_state of those blocks to each rank alone, every
               leaf bit-equal to the blocks gathered; (f) phi3.5-moe
               at full width, 1 layer, through FSDP, B=1 a rank, 2
               steps, as (d) against rank 0's single-rank B=2 run, and
               step 0's load-balance loss within MESH_LB_REL of the
               single rank's; (g) phi3.5-moe at full width, 2 layers,
               served as (a) with moe_shard_map_ep on the sharded
               serving state (8 of 16 experts a rank), its bytes, #1/#2
               rows and peak as (a)'s; in fp32 compute tokens equal to
               one rank's and the mesh-less engine's, logits within
               MESH_TOL; in bf16 each MoE layer alone against the whole
               layer with no mesh on the same inputs (a chunk of 256, a
               decode batch of 4): top-k ids equal where the whole
               layer's k-th and (k+1)-th probabilities are more than
               MOE_ROUTE_MARGIN apart, output rows within ROW_TOL; the
               bf16 streams beside both, where the 2-rank ones part
               their first rerouted token's top-k margin within
               MOE_ROUTE_MARGIN (a router near-tie); (h) deepseek-v3 at
               full width, 4 layers, under distributed_decode (MLA's
               latent by time columns, prefill chunk 640 so that #1
               launches at 64 query heads over the latent head), (i)
               mamba2-130m at full width and depth head-parallel (conv
               channels, SSM heads: #11 at 12 heads), (j) jamba's
               full-width period with dense FFNs under
               distributed_decode (#1 at 32 over 4 KV heads, #11 at 128
               heads in 4 groups), each on the sharded serving state at
               B=4, max_len 1024: bytes a rank equal to the dry-run's,
               peak beside the 1-rank serve's, every #1/#11 launch per
               row against its plain version with a key tile or h0
               dropped rejected, (i)'s fp32 tokens equal to one rank's
               (logits within MESH_TOL), (h)/(j)'s bf16 streams as
               (g)'s; (k) starcoder2-7b, (l) deepseek-v3's MLA training
               config (1 layer) and (m) mamba2-130m (4 layers) trained
               tensor-parallel on (1, 2) at full width, B=4, seq 1024
               (each rank its heads, MLP columns, vocabulary rows, and
               (m)'s SSM heads, conv channels and inner): bytes a rank
               the dry-run's, #7-#9 on each rank per row against their
               plain versions ((k) at 18 over 2 heads, (l) at 64 heads
               of D 192 / Dv 128), losses within MESH_TRAIN_REL of one
               rank's, one fp32 step's gradients within MESH_TOL of
               each leaf's largest; each layer's output a rank holds
               (the residual stream, JAX's seq_stream) its 512 of the
               1024 rows; (k) also runs one bf16 step under each of
               the default rules and dict(DEFAULT_RULES,
               seq_stream=None) (seconds, peak GB and collective bytes
               by kind a step) and the fp32 step under the latter,
               its gradients within MESH_TOL of the default's.  Each
               sub-phase's seconds and peak memory a rank.
The kernel phase also holds the four training kernels (#7-#10) to their
plain versions at starcoder2-7b's training shapes (B=2, Sq = Skv = 2048,
causal), #7-#9 at hubert-xlarge's (B=2, 16 heads of 80, S = 4096,
non-causal: the _any instantiations; per row, a dropped tile rejected,
bitwise repeatable, timed against non-causal SDPA and its backward) and
at phi3.5-moe's (B=2, 32 query heads over 8 of 128, S = 2048, causal)
and at MLA's training shape (B=2, 128 over 128 heads, S = 2048, causal,
D 192, Dv 128: the *_mma_kernel_d192 instantiations, beside SDPA, whose
backend is named; and in fp32 per row within TRAIN_FP32_TOL), #1 and
#3 at internvl2-2b's prefill and decode shapes (each kernel's record
carries these as "hubert", "phi35moe", "mla" and "internvl"), #11 and #1
at jamba's shapes (jamba_kernel_phase: "jamba", "jamba_prefill",
"jamba_decode") and the Mamba-2 SSD scan (#11) to its plain version in
bf16 and fp32 at the serve path's prefill chunk (B=1, L=188, with an
initial state) and the cache-free forward's shape (B=4, L=2048), and times
them beside the unfused yardstick (ssd_unfused: every chunk batched
through einsum, the states passed by one product; for reference only);
in bf16 the same two shapes again with long-memory inputs (dt scaled by
SSD_LONG_DT).  #1-#4, #6, #7-#10 and #11 are also held per row (o,
lse, dq, dk, dv; #3 and #6 their output on a zero residual; #11's y
per (row, position, head) and state per (row, head, P row)), and that
gate is shown to reject plain results with one tile (#4: one KV chunk
of its split-KV body; #3 and #6: each row's last key chunk, and
separately the last head's contribution; #11, at the long-memory
inputs, one chunk's incoming state) dropped; #1-#4, #6, #8-#10 and #11
must be bitwise repeatable.  Each library yardstick is the median of LIB_REPEATS
timings, its spread logged; #2, #3, #5, #6 and #10, which no one
PyTorch call computes, log the unfused path's time (torch.matmul for
x.Wq, RoPE, SDPA; for #3 and #6 then torch.matmul for o.Wo and the
residual add) beside them and carry it as unfused_ms.  #3 and #6 (and
their unfused path) are timed over WEIGHT_COPIES distinct (Wq, Wo)
pairs in turn, so each call reads its 85 MB of weights from device
memory rather than the 50 MB L2.
The qwen phase logs the median decode step of each engine.
Every kernel must have launched on some path.  In the kernels' JSON
record each kernel timed on a tensor-core body also carries its
main-width instantiation's (D = 128; #11's 64-column P slice) registers
and spill bytes (ptxas); the times of #1, #2,
#5 and #7-#10 on the FMA bodies that preceded those bodies are logged
on lines of their own, as PERF.md records them.  The last three lines of stdout are the kernels'
JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}.  Any failure exits non-zero and
prints no ok line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes and bf16
# tensor-core operations a second, the kernels' bounds' (kernels/cost.py)
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.cost import PEAK_BF16, PEAK_BYTES  # noqa: E402

#: the H100's float32 rate outside the tensor cores
PEAK_FP32 = 67e12

STARCODER = dict(E=4608, HQ=36, HKV=4, D=128)
#: the kernels the dense serve path runs
DENSE_KERNELS = ("fused_attention_masked", "fused_qproj_attention_masked",
                 "fused_decode_block")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return smi


_sleep_cycles_per_ms = []


def hold_stream(ms: float) -> None:
    """Keep the current stream busy for about ``ms`` (a sleep kernel,
    calibrated once on CUDA events)."""
    if not _sleep_cycles_per_ms:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        torch.cuda._sleep(10_000_000)
        t1.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms.append(10_000_000 / t0.elapsed_time(t1))
    torch.cuda._sleep(int(ms * _sleep_cycles_per_ms[0]))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn`` on CUDA events over ``iters``
    calls.  The stream is held by a sleep kernel while the host enqueues
    them (twice the host time of one call, each), so a call whose
    wrapper enqueues slower than the card runs it (a decode kernel of a
    few microseconds) is timed by the card, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    hold_stream(min(2 * host_ms * iters, 1000.0))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(kernel: str, *args, **kw) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card takes for
    one call of ``kernel`` at these shapes and lengths, from its closed
    form (``kernels/cost.py``)."""
    return cost.bound_ms(*cost.cost(kernel, *args, **kw))


#: repeats of each library yardstick: its time moves between repeats
#: far more than the kernels' (SDPA's backward read 0.55-1.92 ms across
#: calls), so library_ms is the median and the spread is logged
LIB_REPEATS = 5


def lib_ms(label, measure) -> float:
    """The median of LIB_REPEATS results of ``measure()`` (ms), with
    their spread logged."""
    ts = [measure() for _ in range(LIB_REPEATS)]
    med = statistics.median(ts)
    log(f"  library {label}: median {med:.4f} ms of {LIB_REPEATS} repeats "
        f"(spread {min(ts):.4f}-{max(ts):.4f})")
    return med


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


def check_kernel(name, got, want, tag):
    """A kernel's output against its plain version's: finite and within
    KERNEL_TOL of the largest |want|.  Returns the max abs error."""
    err, rel = rel_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and rel <= KERNEL_TOL
    log(f"  {name} [{tag}] max_abs_err={err:.3e} rel={rel:.3e} "
        f"tol={KERNEL_TOL} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version ({tag})")
    return err


def mask_of(lens, sq, skv, dev):
    """The masked kernels' boolean mask (B, 1, Sq, Skv): row r of batch
    row b sees column c < lengths[b] with c <= lengths[b] - Sq + r."""
    cols = torch.arange(skv, device=dev)
    rows = lens[:, None] - sq + torch.arange(sq, device=dev)[None, :]
    return ((cols[None, :] < lens[:, None])[:, None, None, :]
            & (cols[None, None, :] <= rows[:, :, None])[:, None])


def unfused_ms(name, x, wq, k, v, pos, theta, mask=None, iters=10,
               out_proj=None):
    """The unfused path that a fused Q-projection kernel (#2, #5, #10)
    replaces, timed at the kernel's shape for reference: x.Wq as one
    torch.matmul, the RoPE oracle (ref.rope) at ``pos``, then one SDPA
    over k, v (with ``mask``, heads already expanded; without, causal
    with GQA).  With ``out_proj`` = (weight pairs, residual), the decode
    sub-block that #3 and #6 replace: the calls cycle through the (Wq,
    Wo) pairs (distinct copies, so each call reads its weights from
    device memory, as the kernels' timing does; ``wq`` is then unused),
    and o.Wo as one torch.matmul plus the residual follow SDPA.  Several
    calls, not one, so not the kernel's library_ms."""
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, sq, e = x.shape
    hq, d = wq.shape[1:]
    pairs, res = out_proj if out_proj else ([(wq, None)], None)
    turn = [0]

    def run():
        w_q, w_o = pairs[turn[0] % len(pairs)]
        turn[0] += 1
        q = torch.matmul(x, w_q.view(e, hq * d)).view(b, sq, hq, d)
        q = ref.rope(q.transpose(1, 2), pos, theta)
        if mask is None:
            o = sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            o = sdpa(q, k, v, attn_mask=mask)
        if w_o is None:
            return o
        o = o.transpose(1, 2).reshape(b, sq, -1)
        return torch.matmul(o, w_o.view(-1, e)) + res

    ms = time_ms(run, iters)
    what = "torch.matmul, RoPE, SDPA" + (", torch.matmul, add" if out_proj
                                         else "")
    log(f"  {name}: the unfused path ({what}) takes {ms:.4f} ms at the "
        f"same shape")
    return ms


def masked_gates(name, tag, out, want, run, length, dropped):
    """#1's and #2's gates beyond check_kernel at their table shapes
    (causal, one batch row of ``length`` keys, the kernel's 64-row tiles
    r0 = 0, 64, ...): bitwise repeatable, within ROW_TOL per row, and
    that row gate shown to reject the plain result whose deepest row tile
    lost its last 64-key tile (``dropped(rows, end)``: the plain
    version's rows [rows, Sq) over keys [0, end) alone)."""
    if not torch.equal(run(), out):
        raise SystemExit(f"{name} is not deterministic")
    log(f"  {name} [{tag}] bitwise repeatable")
    row_gate(name, tag, {"o": (out, want)})
    rows = (out.shape[2] - 1) // 64 * 64        # the deepest row tile
    cut = want.clone()
    cut[:, :, rows:] = dropped(rows, (length - 1) // 64 * 64)
    row_gate(name, f"{tag}, plain with a key tile dropped",
             {"o": (cut, want)}, expect=False)


def decode_terms(x, wq, k, v, wo, lens, key_lens, theta):
    """Each head's o @ Wo[h], (B, Hq, E) in fp32, computed as
    fused_decode_block_plain computes the sub-block: q projected and
    rotated at lens - 1, attention over the keys [0, key_lens) of each
    row, o rounded to Wo's dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked import chunked_attention
    q = torch.einsum("bse,ehd->bhsd", x, wq)
    q = ref.rope(q, ref.rope_positions(1, k.shape[2], lengths=lens), theta)
    o = chunked_attention(q, k, v, causal=False, lengths=key_lens)
    return torch.einsum("bhse,hed->bhd", o.to(wo.dtype).float(), wo.float())


def decode_gates(name, tag, out, want, run, x, wq, k, v, wo, lens, theta):
    """#3's and #6's gates beyond check_kernel at their table shapes, on
    a zero residual (``out`` and ``want`` are o @ Wo summed over the
    heads; ``run()`` the kernel again): bitwise repeatable, within
    ROW_TOL per row, and that row gate shown to reject the plain result
    without the last head's contribution and the plain result without
    each row's last key chunk of the kernel's plan (keys from the
    chunk's first on left out, q still rotated at lens - 1)."""
    from repro_torch.kernels.fused_attention import chunk_bounds
    from repro_torch.kernels.fused_decode_block import decode_plan
    if not torch.equal(run(), out):
        raise SystemExit(f"{name} is not deterministic")
    log(f"  {name} [{tag}] bitwise repeatable")
    row_gate(name, tag, {"y": (out, want)})
    terms = decode_terms(x, wq, k, v, wo, lens, lens, theta)
    row_gate(name, f"{tag}, plain without its last head",
             {"y": (terms[:, :-1].sum(1).to(out.dtype)[:, None], want)},
             expect=False)
    b, _, e = x.shape
    hq, d = wq.shape[1:]
    plan = decode_plan(b, hq, k.shape[1], e, d, v.shape[3],
                       torch.cuda.get_device_properties(
                           x.device).multi_processor_count)
    short = torch.tensor([chunk_bounds(int(n), plan.n_chunks)[-1][0]
                          for n in lens], dtype=torch.int32,
                         device=x.device)
    log(f"  {name}: {plan.n_chunks} key chunks per (row, KV head); each "
        f"row without its last: lengths {short.tolist()}")
    cut = decode_terms(x, wq, k, v, wo, lens, short, theta).sum(1)
    row_gate(name, f"{tag}, plain without each row's last key chunk",
             {"y": (cut.to(out.dtype)[:, None], want)}, expect=False)


#: distinct (Wq, Wo) pairs the decode megakernels' timings cycle through
#: (3 x 85 MB against the 50 MB L2), so each timed call reads its
#: weights from device memory, as a 32-layer decode step does
WEIGHT_COPIES = 3


def kernel_phase(dev, g):
    from repro_torch.kernels import ref
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
    check = check_kernel

    # -- 1. fused_attention_masked: the first prefill chunk --------------
    sq = 256
    q, k, v = rnd(1, HQ, sq, D), rnd(1, HKV, skv, D), rnd(1, HKV, skv, D)
    lens = torch.tensor([sq], dtype=torch.int32, device=dev)
    tag = "B=1 Sq=256 chunk"
    results["fused_attention_masked"] = dict(
        source="src/repro_torch/kernels/csrc/fused_attention.cu",
        replaces="src/repro/kernels/fused_attention.py:310",
        **masked_attention_record(
            q, k, v, lens, tag,
            lambda out, want, run: masked_gates(
                "fused_attention_masked", tag, out, want, run, sq,
                lambda rows, end: fused_attention_masked_plain(
                    q[:, :, rows:].contiguous(), k, v,
                    torch.tensor([end], dtype=torch.int32, device=dev),
                    causal=False))))
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
    ke, ve = (t.repeat_interleave(HQ // HKV, 1) for t in (k, v))

    # -- 2. fused_qproj_attention_masked: a ragged later chunk -----------
    sq, total = 188, 700          # a 700-token prompt's third chunk
    x, wq = rnd(1, sq, E), rnd(E, HQ, D, scale=E ** -0.5)
    lens = torch.tensor([total], dtype=torch.int32, device=dev)
    f2 = lambda: fused_qproj_attention_masked(
        x, wq, k, v, lens, causal=True, rope_theta=theta)
    p2 = lambda: fused_qproj_attention_masked_plain(
        x, wq, k, v, lens, causal=True, rope_theta=theta)
    out2, want2 = f2(), p2()
    tag = f"B=1 Sq={sq} lengths=[{total}]"
    err = check("fused_qproj_attention_masked", out2, want2, tag)

    def qproj_rows(rows, end):
        """The plain version's rows [rows, Sq), over keys [0, end) only."""
        qq = torch.einsum("bse,ehd->bhsd", x[:, rows:], wq)
        qq = ref.rope(qq, ref.rope_positions(sq - rows, skv, lengths=lens),
                      theta)
        return fused_attention_masked_plain(
            qq, k, v, torch.tensor([end], dtype=torch.int32, device=dev),
            causal=False)

    masked_gates("fused_qproj_attention_masked", tag, out2, want2, f2, total,
                 qproj_rows)
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
    bms, by = bound("fused_qproj_attention_masked", 1, sq, E, HQ, HKV, skv,
                    D, D, lengths=[total], causal=True, el=x.element_size())
    pos = ref.rope_positions(sq, skv, lengths=lens)
    results["fused_qproj_attention_masked"] = dict(
        source="src/repro_torch/kernels/csrc/fused_qproj_attention.cu",
        replaces="src/repro/kernels/fused_qproj_attention.py:243",
        max_abs_err=err, ms=time_ms(f2, 10), plain_ms=time_ms(p2, 3),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=unfused_ms("fused_qproj_attention_masked", x, wq, ke, ve,
                              pos, theta, mask_of(lens, sq, skv, dev)))

    def check_decode_with(name, run, args, tag):
        """``run(x, ..., residual, ...) -> (kernel, plain)`` with
        ``args``' residual (its 4th entry) and with a zero one; returns
        (kernel output with the residual, the larger error)."""
        outs, errs = [], []
        rr = args[3]
        for r_, what in ((rr, "residual"), (torch.zeros_like(rr),
                                            "zero residual")):
            got, want = run(*args[:3], r_, *args[4:])
            outs.append(got)
            errs.append(check(name, got, want, f"{tag} {what}"))
        return outs[0], max(errs)

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

    def dense_decode(xx, kk, vv, rr, ll):
        return (fused_decode_block(xx, wq, kk, vv, wo, rr, ll,
                                   rope_theta=theta),
                fused_decode_block_plain(xx, wq, kk, vv, wo, rr, ll,
                                         rope_theta=theta))

    def check_decode(xx, kk, vv, rr, ll, tag):
        return check_decode_with("fused_decode_block", dense_decode,
                                 (xx, kk, vv, rr, ll), tag)

    tag = "B=4 lengths=[301..705]"
    out, err = check_decode(x, k, v, res, lens, tag)
    zero = torch.zeros_like(res)
    decode_gates("fused_decode_block", f"{tag} zero residual",
                 fused_decode_block(x, wq, k, v, wo, zero, lens,
                                    rope_theta=theta),
                 fused_decode_block_plain(x, wq, k, v, wo, zero, lens,
                                          rope_theta=theta),
                 lambda: fused_decode_block(x, wq, k, v, wo, zero, lens,
                                            rope_theta=theta),
                 x, wq, k, v, wo, lens, theta)
    pairs = [(wq, wo)] + [(rnd(E, HQ, D, scale=E ** -0.5),
                           rnd(HQ, D, E, scale=(HQ * D) ** -0.5))
                          for _ in range(WEIGHT_COPIES - 1)]
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
    results["fused_decode_block"] = dict(
        source="src/repro_torch/kernels/csrc/fused_decode_block.cu",
        replaces="src/repro/kernels/fused_decode_block.py:258",
        **decode_block_record(x, res, pairs, k, v, lens, theta, tag, err))
    results.update(paged_kernel_phase(dev, g, check, check_decode_with,
                                      pairs))
    for name, r in results.items():
        log_record(name, r)
    return results


def log_record(name, r, tag=None) -> None:
    """One line of a kernel's record: its time, its plain version's, its
    bound and its library yardstick (or unfused path)."""
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    unfused = f" unfused_ms={r['unfused_ms']:.4f}" if "unfused_ms" in r \
        else ""
    log(f"  {name}{f' [{tag}]' if tag else ''}: kernel_ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}) library_ms={lib}{unfused}")


def masked_attention_record(q, k, v, lens, tag, gates=None) -> dict:
    """#1 (causal) on q (B, Hq, Sq, D) over a dense cache k, v at these
    lengths, against its plain version (then ``gates(out, want, run)``
    where given): its record, with the bound over the score entries and
    KV rows the lengths need, and SDPA with a boolean mask, GQA heads
    expanded, as the yardstick."""
    from repro_torch.kernels.fused_attention import (
        fused_attention_masked, fused_attention_masked_plain)

    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    f1 = lambda: fused_attention_masked(q, k, v, lens, causal=True)
    p1 = lambda: fused_attention_masked_plain(q, k, v, lens, causal=True)
    out, want = f1(), p1()
    err = check_kernel("fused_attention_masked", out, want, tag)
    if gates is not None:
        gates(out, want, f1)
    del out, want
    bms, by = bound("fused_attention_masked", b, hq, hkv, sq, skv, d,
                    v.shape[-1], lengths=lens.tolist(), causal=True,
                    el=q.element_size())
    mask = mask_of(lens, sq, skv, q.device)
    ke, ve = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask)
    return dict(max_abs_err=err, ms=time_ms(f1, 20), plain_ms=time_ms(p1, 3),
                bound_ms=bms, bound_by=by,
                library_ms=lib_ms(f"SDPA for fused_attention_masked [{tag}]",
                                  lambda: time_ms(lib, 20)))


def decode_block_record(x, res, pairs, k, v, lens, theta, tag, err) -> dict:
    """#3's record at x, res (B, 1, E) over a dense cache k, v at these
    lengths (``err``: its checks' largest error): timed over the
    WEIGHT_COPIES ``pairs`` of (Wq, Wo) in turn, so that no call finds
    its weights in L2, with its bound and the unfused path's time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_block import (
        fused_decode_block, fused_decode_block_plain)

    b, _, e = x.shape
    wq, wo = pairs[0]
    hq, d = wq.shape[1], wq.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    turn = [0]

    def f3():
        w_q, w_o = pairs[turn[0] % WEIGHT_COPIES]
        turn[0] += 1
        return fused_decode_block(x, w_q, k, v, w_o, res, lens,
                                  rope_theta=theta)

    p3 = lambda: fused_decode_block_plain(x, wq, k, v, wo, res, lens,
                                          rope_theta=theta)
    bms, by = bound("fused_decode_block", b, e, hq, hkv, skv, d,
                    v.shape[-1], lengths=lens.tolist(), el=x.element_size())
    return dict(
        max_abs_err=err, ms=time_ms(f3, 20), plain_ms=time_ms(p3, 3),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=unfused_ms(
            f"fused_decode_block [{tag}]", x, wq,
            *(t.repeat_interleave(hq // hkv, 1) for t in (k, v)),
            ref.rope_positions(1, skv, lengths=lens), theta,
            mask_of(lens, 1, skv, x.device), iters=20,
            out_proj=(pairs, res)))


QWEN = dict(E=4096, HQ=32, HKV=8, D=128)
#: the paged kernels' main-path batch: B=4 rows at these contexts
PAGED_LENS = [301, 460, 612, 705]


def paged_from_dense(k, v, lens, page, g, extra=37, dead=()):
    """Scatter each row's live pages of the dense (B, Hkv, Skv, D) caches
    into random pools of more pages than the rows need (``extra`` more,
    plus the null page 0), at shuffled page ids, as the paged engine
    lays them out: table row b names its ceil(len/page) pages in order,
    then zeros.  Rows in ``dead`` get an all-zero table row.  Returns
    (k pool, v pool, table)."""
    b, hkv, skv, d = k.shape
    need = [0 if i in dead else -(-int(n) // page) for i, n in
            enumerate(lens)]
    n_pages = sum(need) + extra + 1
    ids = torch.randperm(n_pages - 1, generator=g, device=k.device) + 1
    tbl = torch.zeros((b, skv // page), dtype=torch.int32, device=k.device)
    pools = [torch.randn(n_pages, hkv, page, d, generator=g,
                         device=k.device).to(k.dtype) for _ in (k, v)]
    off = 0
    for i, n in enumerate(need):
        rows = ids[off:off + n]
        off += n
        tbl[i, :n] = rows.to(torch.int32)
        for pool, x in zip(pools, (k, v)):
            pool[rows] = x[i, :, :n * page].reshape(
                hkv, n, page, d).movedim(1, 0)
    return pools[0], pools[1], tbl


def paged_kernel_phase(dev, g, check, check_decode_with, pairs):
    """The three paged kernels at the paged path's full-width shapes in
    bf16, over shuffled tables of pools larger than the batch needs:
    each against its plain version, and bit for bit against its dense
    kernel on the gathered cache (one body, another KV address).  #6 is
    timed over the (Wq, Wo) ``pairs`` that #3's timing cycles through,
    and its own gates run on the first."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_attention import (
        chunk_bounds, fused_attention_masked, fused_attention_masked_plain,
        fused_attention_paged, fused_attention_paged_plain, split_chunks)
    from repro_torch.kernels.fused_decode_block import (
        fused_decode_block, fused_decode_block_paged,
        fused_decode_block_paged_plain)
    from repro_torch.kernels.fused_qproj_attention import (
        fused_qproj_attention_masked, fused_qproj_attention_paged,
        fused_qproj_attention_paged_plain)

    bf = torch.bfloat16
    theta, skv, page, b = 1e5, 1024, 16, len(PAGED_LENS)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(bf)

    def log_twin(name, dense, iters):
        """The dense kernel's time on the gathered cache at the same
        shapes: what paging costs the kernel (the gather is not in it)."""
        r = results[name]
        dense_ms = time_ms(dense, iters)
        log(f"  {name}: {r['ms']:.4f} ms against its dense kernel's "
            f"{dense_ms:.4f} ms on the gathered cache "
            f"({100 * (r['ms'] / dense_ms - 1):+.1f}%)")

    def same_as_dense(name, got, dense, tag):
        if not torch.equal(got, dense):
            err = (got.float() - dense.float()).abs().max().item()
            raise SystemExit(f"{name} [{tag}] differs from its dense kernel "
                             f"on the gathered cache (max_abs {err:.3e})")
        log(f"  {name} [{tag}] bitwise equal to the dense kernel on the "
            f"gathered cache")

    # edge cases: (lengths, page, dead rows)
    edges = [([0, 77, 130], 8, (0,)), ([1, 200, 1023], 128, ()),
             ([16, 0, 513], 16, ())]
    results = {}
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    # the table entries a paged kernel follows: each row's live pages
    pages_read = lambda t: int(t.count_nonzero())

    # -- 4. fused_attention_paged: qwen3-8b decode past C = 256 ----------
    E, HQ, HKV, D = (QWEN[k] for k in ("E", "HQ", "HKV", "D"))
    k, v = rnd(b, HKV, skv, D), rnd(b, HKV, skv, D)
    q = rnd(b, HQ, 1, D)
    kp, vp, tbl = paged_from_dense(k, v, PAGED_LENS, page, g)
    kg, vg = ref.gather_pages(kp, tbl), ref.gather_pages(vp, tbl)
    f4 = lambda: fused_attention_paged(q, kp, vp, lens, tbl)
    p4 = lambda: fused_attention_paged_plain(q, kp, vp, lens, tbl)
    out, want = f4(), p4()
    tag = f"qwen B=4 page {page} lengths={PAGED_LENS}"
    err = check("fused_attention_paged", out, want, tag)
    same_as_dense("fused_attention_paged", out,
                  fused_attention_masked(q, kg, vg, lens), "B=4")
    if not torch.equal(out, f4()):
        raise SystemExit("fused_attention_paged is not deterministic")
    # the split-KV body's plan at this shape, its per-row gate, and that
    # gate against the plain output with each row's last chunk left out
    # (attention over the keys before that chunk)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_chunks = split_chunks(b, HQ, HKV, 1, n_sms)
    if not n_chunks:
        raise SystemExit("fused_attention_paged: the decode shape does not "
                         "take the split-KV body")
    bounds = [chunk_bounds(n, n_chunks) for n in PAGED_LENS]
    live = sum(map(len, bounds)) * HKV
    log(f"  fused_attention_paged: split-KV body, {n_chunks} chunks per "
        f"(row, KV head) on {n_sms} SMs, chunks per row "
        f"{[len(c) for c in bounds]}: {live} live blocks of "
        f"{n_chunks * b * HKV}")
    row_gate("fused_attention_paged", tag, {"o": (out, want)})
    short = torch.tensor([c[-1][0] for c in bounds], dtype=torch.int32,
                         device=dev)
    row_gate("fused_attention_paged", f"{tag}, plain with a KV chunk dropped",
             {"o": (fused_attention_masked_plain(q, kg, vg, short), want)},
             expect=False)
    # the edge cases at M=1, and a causal 5-row chunk
    for ls, pg, dead, sq in [e + (1,) for e in edges] + [
            ([41, 700, 5], 16, (), 5)]:
        qq = rnd(3, HQ, sq, D)
        kk, vv = rnd(3, HKV, skv, D), rnd(3, HKV, skv, D)
        ll = torch.tensor(ls, dtype=torch.int32, device=dev)
        kp_, vp_, t_ = paged_from_dense(kk, vv, ls, pg, g, dead=dead)
        got = fused_attention_paged(qq, kp_, vp_, ll, t_)
        tag = f"Sq={sq} page {pg} lengths={ls} dead={list(dead)}"
        check("fused_attention_paged", got,
              fused_attention_paged_plain(qq, kp_, vp_, ll, t_), tag)
        same_as_dense("fused_attention_paged", got, fused_attention_masked(
            qq, ref.gather_pages(kp_, t_), ref.gather_pages(vp_, t_), ll),
            tag)
        if 0 in ls and got[ls.index(0)].any():
            raise SystemExit("fused_attention_paged: a length-0 row must "
                             "emit zeros")
    bms, by = bound("fused_attention_paged", b, HQ, HKV, 1,
                    tbl.shape[1] * page, D, D, lengths=PAGED_LENS,
                    el=q.element_size(), table=pages_read(tbl))
    cols = torch.arange(skv, device=dev)
    mask = (cols[None, :] < lens[:, None])[:, None, None, :]
    ke, ve = (x.repeat_interleave(HQ // HKV, 1) for x in (kg, vg))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask)
    gather_ms = time_ms(lambda: (ref.gather_pages(kp, tbl),
                                 ref.gather_pages(vp, tbl)), 20)
    log(f"  fused_attention_paged: the yardstick's gather of the pool to "
        f"dense KV takes {gather_ms:.4f} ms, not in library_ms")
    results["fused_attention_paged"] = dict(
        source="src/repro_torch/kernels/csrc/fused_attention.cu",
        replaces="src/repro/kernels/fused_attention.py:408",
        max_abs_err=err, ms=time_ms(f4, 50), plain_ms=time_ms(p4, 3),
        bound_ms=bms, bound_by=by,
        library_ms=lib_ms("SDPA on the gathered KV for fused_attention_paged",
                          lambda: time_ms(lib, 20)))
    log_twin("fused_attention_paged",
             lambda: fused_attention_masked(q, kg, vg, lens), 50)

    # -- 5. fused_qproj_attention_paged: the megakernel one rung down ----
    E, HQ, HKV, D = (STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    wq, wo = pairs[0]
    k, v = rnd(b, HKV, skv, D), rnd(b, HKV, skv, D)
    x, res = rnd(b, 1, E), rnd(b, 1, E)
    kp, vp, tbl = paged_from_dense(k, v, PAGED_LENS, page, g)
    kg, vg = ref.gather_pages(kp, tbl), ref.gather_pages(vp, tbl)
    f5 = lambda: fused_qproj_attention_paged(x, wq, kp, vp, lens, tbl,
                                             rope_theta=theta)
    p5 = lambda: fused_qproj_attention_paged_plain(x, wq, kp, vp, lens, tbl,
                                                   rope_theta=theta)
    out = f5()
    err = check("fused_qproj_attention_paged", out, p5(),
                f"B=4 page {page} lengths={PAGED_LENS}")
    same_as_dense("fused_qproj_attention_paged", out,
                  fused_qproj_attention_masked(x, wq, kg, vg, lens,
                                               rope_theta=theta), "B=4")
    edge_inputs = []
    for ls, pg, dead in edges:
        kk, vv = rnd(3, HKV, skv, D), rnd(3, HKV, skv, D)
        ll = torch.tensor(ls, dtype=torch.int32, device=dev)
        kp_, vp_, t_ = paged_from_dense(kk, vv, ls, pg, g, dead=dead)
        xx, rr = rnd(3, 1, E), rnd(3, 1, E)
        edge_inputs.append((ls, pg, dead, ll, kp_, vp_, t_, xx, rr))
        tag = f"page {pg} lengths={ls} dead={list(dead)}"
        got = fused_qproj_attention_paged(xx, wq, kp_, vp_, ll, t_,
                                          rope_theta=theta)
        check("fused_qproj_attention_paged", got,
              fused_qproj_attention_paged_plain(xx, wq, kp_, vp_, ll, t_,
                                                rope_theta=theta), tag)
        same_as_dense("fused_qproj_attention_paged", got,
                      fused_qproj_attention_masked(
                          xx, wq, ref.gather_pages(kp_, t_),
                          ref.gather_pages(vp_, t_), ll, rope_theta=theta),
                      tag)
    bms, by = bound("fused_qproj_attention_paged", b, 1, E, HQ, HKV,
                    tbl.shape[1] * page, D, D, lengths=PAGED_LENS,
                    el=x.element_size(), table=pages_read(tbl))
    results["fused_qproj_attention_paged"] = dict(
        source="src/repro_torch/kernels/csrc/fused_qproj_attention.cu",
        replaces="src/repro/kernels/fused_qproj_attention.py:322",
        max_abs_err=err, ms=time_ms(f5, 20), plain_ms=time_ms(p5, 3),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=unfused_ms(
            "fused_qproj_attention_paged", x, wq,
            *(t.repeat_interleave(HQ // HKV, 1) for t in (kg, vg)),
            ref.rope_positions(1, skv, lengths=lens), theta,
            mask_of(lens, 1, skv, dev), iters=20))
    log_twin("fused_qproj_attention_paged",
             lambda: fused_qproj_attention_masked(x, wq, kg, vg, lens,
                                                  rope_theta=theta), 20)

    # -- 6. fused_decode_block_paged: starcoder2-7b paged decode ---------
    def paged_decode(xx, kp_, vp_, rr, ll, t_):
        return (fused_decode_block_paged(xx, wq, kp_, vp_, wo, rr, ll, t_,
                                         rope_theta=theta),
                fused_decode_block_paged_plain(xx, wq, kp_, vp_, wo, rr, ll,
                                               t_, rope_theta=theta))

    def dense_decode(xx, kp_, vp_, rr, ll, t_):
        return fused_decode_block(xx, wq, ref.gather_pages(kp_, t_),
                                  ref.gather_pages(vp_, t_), wo, rr, ll,
                                  rope_theta=theta)

    out, err = check_decode_with("fused_decode_block_paged", paged_decode,
                                 (x, kp, vp, res, lens, tbl),
                                 f"B=4 page {page} lengths={PAGED_LENS}")
    same_as_dense("fused_decode_block_paged", out,
                  dense_decode(x, kp, vp, res, lens, tbl), "B=4")
    for ls, pg, dead, ll, kp_, vp_, t_, xx, rr in edge_inputs:
        tag = f"page {pg} lengths={ls} dead={list(dead)}"
        got, _ = check_decode_with("fused_decode_block_paged", paged_decode,
                                   (xx, kp_, vp_, rr, ll, t_), tag)
        same_as_dense("fused_decode_block_paged", got,
                      dense_decode(xx, kp_, vp_, rr, ll, t_), tag)
        zero = [i for i, n in enumerate(ls) if n == 0]
        if zero and not torch.equal(got[zero], rr[zero]):
            raise SystemExit("fused_decode_block_paged: a length-0 row "
                             "must return its residual")
    zero = torch.zeros_like(res)
    run6 = lambda: fused_decode_block_paged(x, wq, kp, vp, wo, zero, lens,
                                            tbl, rope_theta=theta)
    got6 = run6()
    same_as_dense("fused_decode_block_paged", got6,
                  dense_decode(x, kp, vp, zero, lens, tbl), "B=4 zero residual")
    decode_gates("fused_decode_block_paged",
                 f"B=4 page {page} zero residual", got6,
                 fused_decode_block_paged_plain(x, wq, kp, vp, wo, zero,
                                                lens, tbl, rope_theta=theta),
                 run6, x, wq, kg, vg, wo, lens, theta)
    turn = [0]

    def f6():
        w_q, w_o = pairs[turn[0] % len(pairs)]
        turn[0] += 1
        return fused_decode_block_paged(x, w_q, kp, vp, w_o, res, lens, tbl,
                                        rope_theta=theta)

    p6 = lambda: fused_decode_block_paged_plain(x, wq, kp, vp, wo, res, lens,
                                                tbl, rope_theta=theta)
    bms, by = bound("fused_decode_block_paged", b, E, HQ, HKV,
                    tbl.shape[1] * page, D, D, lengths=PAGED_LENS,
                    el=x.element_size(), table=pages_read(tbl))
    results["fused_decode_block_paged"] = dict(
        source="src/repro_torch/kernels/csrc/fused_decode_block.cu",
        replaces="src/repro/kernels/fused_decode_block.py:194",
        max_abs_err=err, ms=time_ms(f6, 20), plain_ms=time_ms(p6, 3),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=unfused_ms(
            "fused_decode_block_paged", x, wq,
            *(t.repeat_interleave(HQ // HKV, 1) for t in (kg, vg)),
            ref.rope_positions(1, skv, lengths=lens), theta,
            mask_of(lens, 1, skv, dev), iters=20, out_proj=(pairs, res)))
    turn = [0]

    def dense6():
        w_q, w_o = pairs[turn[0] % len(pairs)]
        turn[0] += 1
        return fused_decode_block(x, w_q, kg, vg, w_o, res, lens,
                                  rope_theta=theta)

    log_twin("fused_decode_block_paged", dense6, 20)
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


def _one_request_logits(eng, prompt, forced_tokens=None,
                        steps=DECODE_COMPARED):
    """Prefill ``prompt`` into slot 0 of an idle engine, then decode
    ``steps`` steps; with ``forced_tokens`` the row is fed those tokens
    instead of its own samples (so two runs stay comparable).  Returns
    ([prefill logits, step logits...], tokens fed)."""
    eng.begin_prefill(0, prompt)
    while not eng.live[0]:
        eng._advance_prefills()
    logits, fed = [eng.prefill_logits[0].float()], []
    for i in range(steps):
        if forced_tokens is not None:
            eng.state.last_token[0] = forced_tokens[i]
        fed.append(int(eng.state.last_token[0]))
        eng.decode_once()
        logits.append(eng.last_logits[0].float())
    return logits, fed


#: host seconds of every garbage collection since the first plan_clock()
_GC = {"secs": 0.0, "t0": None}


def _gc_timer(phase, info):
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    elif _GC["t0"] is not None:
        _GC["secs"] += time.perf_counter() - _GC["t0"]


def plan_clock() -> tuple:
    """(cold lowerings, their host seconds) so far; the difference of two
    readings is the plan resolution a run paid (``lowering.lower`` on a
    plan-cache miss: host time, no kernel)."""
    from repro_torch.lower import cache
    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)
    return cache.lowering_totals() + (_GC["secs"],)


def plan_since(before: tuple) -> tuple:
    """(cold lowerings, their host seconds, garbage collections' host
    seconds) since ``before``; a collection that ran inside a lowering
    is counted in both."""
    return tuple(a - b for a, b in zip(plan_clock(), before))


def log_lowerings(count: int, indent: str = "  ") -> None:
    """The last ``count`` cold lowerings, each (config, phase, bucket,
    decode tokens M, blocks) with its host ms."""
    from repro_torch.lower import cache
    rows = list(cache.LOWERINGS)[-count:] if count else []
    log(f"{indent}cold lowerings ({count}): " + ", ".join(
        f"{c} {p} bucket {b} M={m} x{nb} {s * 1e3:.1f} ms"
        for c, p, b, m, nb, s in rows))


def check_served_plans(phase: str, plan, cfg) -> None:
    """Every plan a serve resolved came from ``lowering.lower``: a source
    schedule, one BlockPlan a layer, all alike."""
    bad = [p for p in plan.plans() if p.source is None
           or p.n_blocks != cfg.n_layers or len(p.blocks) != cfg.n_layers
           or len({(b.kernel_path, b.tiling) for b in p.blocks}) != 1]
    if bad or not plan.plans():
        raise SystemExit(f"{phase}: served plans without a homogeneous "
                         f"lowering: {bad}")


def log_rates(phase: str, gen: int, secs: float, spent: tuple,
              resolutions: int) -> None:
    """tok/s over the run's wall time, and without its plan resolution
    (``spent`` from :func:`plan_since`: the cold lowerings, host time
    apart from the steps; the run's garbage collections beside)."""
    n_low, plan_s, gc_s = spent
    log(f"  {phase}: {gen} tokens in {secs:.3f}s = {gen / secs:.2f} tok/s "
        f"with plan resolution; {n_low} cold lowerings took "
        f"{plan_s * 1e3:.1f} ms, so {gen / (secs - plan_s):.2f} tok/s "
        f"without; {resolutions} plan resolutions; garbage collection "
        f"{gc_s * 1e3:.1f} ms in the run")


#: whole-batch decode steps in each steady decode window
DECODE_WINDOW = 8


def device_report(prof, wall_s: float, title: str, top: int = 8,
                  also=()) -> float:
    """Device time by kernel from a ``torch.profiler`` trace (device-side
    events only, so the host ops that launched them are not counted
    twice), with the share of ``wall_s`` the device was idle: the ``top``
    kernels, then any other whose name holds one of ``also``.  Returns
    the device busy time in ms."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(r[1] for r in rows)
    if not busy_us:
        raise SystemExit(f"{title}: the profiler recorded no device time")
    log(f"  {title}: wall {wall_s * 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share under the profiler "
        f"{1 - busy_us / 1e3 / (wall_s * 1e3):.4f}")
    ranked = sorted(rows, key=lambda r: -r[1])
    shown = ranked[:top] + [r for r in ranked[top:]
                            if any(a in r[0] for a in also)]
    for key, us, n in shown:
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
    device_report(prof, wall, "profiled serve run (prefill and decode)",
                  also=("masked_mma_kernel", "qproj_mma_kernel",
                        "split_kernel"))

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


def serve_phase(dev, roofline):
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

    lower.clear_plan_cache()       # the serve pays its cold lowerings
    gc.collect()                   # and no garbage of an earlier phase
    before = plan_clock()
    ops.reset_counts()
    out = serve.run(args, cfg, params, requests)
    launches = collections.Counter(build.LAUNCHES)
    calls = dict(ops.CALLS)
    spent = plan_since(before)
    finished, secs = out["finished"], out["seconds"]
    gen = sum(len(r.generated) for r in finished)
    steps = out["decode_step_s"]
    step_ms = sorted(steps)[len(steps) // 2] * 1e3
    unfused = sum(1 for r in out["plan"].resolutions
                  if r[3] == lower.UNFUSED)
    log(f"  finished {len(finished)}/{len(requests)} requests, {gen} "
        f"tokens in {secs:.3f}s = {gen / secs:.2f} tok/s; decode steps "
        f"{len(steps)}, median step {step_ms:.3f} ms")
    log_rates("serve", gen, secs, spent, len(out["plan"].resolutions))
    log_lowerings(spent[0])
    check_served_plans("serve", out["plan"], cfg)
    log(f"  launches: {dict(launches)}")
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
    missing = [n for n in DENSE_KERNELS if launches[n] == 0]
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
    worst = compare_logits("serve", k_logits, p_logits)
    log(f"serve: ok (prompt {len(prompt)} tokens, prefill + "
        f"{DECODE_COMPARED} decode steps, worst rel {worst:.4e})")
    profile_windows(args, cfg, params)
    dense_tokens = {r.uid: r.generated for r in finished}
    launches.update(paged_serve_phase(args, cfg, params, dense_tokens, dev))
    launches.update(rung_down_phase(args, cfg, params, dev))
    launches.update(chaos_phase(args, cfg, params, dev))
    roofline_phase(args, cfg, params, dev, roofline)
    del params
    torch.cuda.empty_cache()
    return launches


#: the dry-run cells whose roofline terms the roofline phase prints
ROOFLINE_CELLS = (("starcoder2-7b", "decode_32k"),
                  ("starcoder2-7b", "train_4k"))


def start_roofline():
    """The dry-run's roofline of ROOFLINE_CELLS on the (16, 16) mesh,
    started now: rank 0's program of each counted on the meta device
    under a fake process group, in a child process
    (``launch.dryrun.roofline_cells``) that runs on the host beside the
    card's phases.  Returns the future of its results."""
    import concurrent.futures

    from repro_torch.launch import dryrun

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(dryrun.roofline_cells,
                         [((a, s), {}) for a, s in ROOFLINE_CELLS])
    pool.shutdown(wait=False)
    return future


def roofline_phase(args, cfg, params, dev, roofline):
    """The roofline cells' terms (``roofline``: :func:`start_roofline`'s
    future, waited for here), each beside the card's name and power
    limit.  Then one bf16
    ``decode_step`` of the serve phase's model at B=4 (lengths
    PAGED_LENS, the plan's decode dispatch) counted on the card, its
    kernels launched, and the same step's shapes counted on the meta
    device: the FLOPs and collective bytes must be equal (the kernels'
    closed forms are counted whether the kernel or its plain version
    runs)."""
    from repro_torch import lower
    from repro_torch.kernels import build
    from repro_torch.launch import cost_analysis
    from repro_torch.models.weights import init_params
    from repro_torch.serve.engine import decode_step, init_decode_state

    t0 = time.time()
    card = card_line()
    cells = roofline.result()
    log(f"roofline: waited {time.time() - t0:.1f}s for the child process "
        "that counted the cells beside the earlier phases")
    for r in cells:
        if "error" in r:
            raise SystemExit(f"roofline: {r['arch']} x {r['shape']}: "
                             f"{r['error']}")
        pd, rt = r["per_device"], r["roofline_seconds"]
        log(f"roofline: {r['arch']} x {r['shape']} x {r['mesh']} per device: "
            f"{pd['flops']:.6e} FLOP, {pd['bytes_accessed']:.6e} B accessed, "
            f"collective {pd['collective_bytes']}; seconds compute "
            f"{rt['compute']:.6f} memory {rt['memory']:.6f} collective "
            f"{rt['collective']:.6f}: {r['bottleneck']}-bound at the NVIDIA "
            f"H100 SXM5 80GB data sheet's rates (700 W); this card: {card}; "
            f"{r['layout']}; counted in {r['count_seconds']:.1f}s")
    lens = PAGED_LENS
    counts = {}
    for where in (dev, torch.device("meta")):
        on_card = where.type == "cuda"
        p = params if on_card else init_params(cfg, None, "meta")
        state = init_decode_state(cfg, len(lens), args.max_len,
                                  cfg.torch_dtype(), device=where)
        if on_card:
            state.cache_len.copy_(torch.tensor(lens, dtype=torch.int32))
        plan = lower.ServingPlan(cfg=cfg, max_len=args.max_len, device=where,
                                 n_blocks=cfg.n_layers)
        dispatch = plan.decode_dispatch(max(lens) + 1)
        before = collections.Counter(build.LAUNCHES)
        with torch.no_grad(), cost_analysis.count() as c:
            decode_step(p, cfg, state, dispatch=dispatch)
        if on_card:
            torch.cuda.synchronize()
        counts[where.type] = dict(
            c.result(), launched=dict(collections.Counter(build.LAUNCHES)
                                      - before), path=dispatch.path)
        del p, state
    card_c, meta_c = counts["cuda"], counts["meta"]
    for where, r in counts.items():
        log(f"roofline: one decode step of {cfg.name} at B={len(lens)} "
            f"lengths {lens} ({r['path']}) counted on {where}: "
            f"{r['flops']} FLOP, {r['bytes_accessed']} B accessed, "
            f"collective {r['collective_bytes']['total']} B; kernels "
            f"counted {r['kernels']}, launched {r['launched']}")
    if not card_c["launched"] or meta_c["launched"]:
        raise SystemExit("roofline: the card's step launched no kernel, or "
                         "the meta step launched one")
    if (card_c["flops"], card_c["collective_bytes"]) \
            != (meta_c["flops"], meta_c["collective_bytes"]):
        raise SystemExit("roofline: the card's decode step counts other "
                         "FLOPs or collective bytes than the meta count of "
                         "its shapes")
    log(f"roofline: the card's FLOPs and collective bytes equal the meta "
        f"count; bytes accessed {card_c['bytes_accessed']} on the card, "
        f"{meta_c['bytes_accessed']} on meta; phase {time.time() - t0:.1f}s")


def compare_logits(phase, got, want, tol=LOGIT_TOL) -> float:
    """Step by step, ``got`` logits against ``want``'s within ``tol`` of
    the largest |logit|; a flipped argmax fails only when the top-2
    margin of ``want`` exceeds that.  Returns the worst relative
    error."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"{phase}: non-finite logits at step {i}")
        err, rel = rel_err(a, b)
        worst = max(worst, rel)
        top2 = torch.topk(b, 2).values
        margin = float(top2[0] - top2[1]) / float(b.abs().max())
        flipped = int(a.argmax()) != int(b.argmax())
        log(f"  parity step {i}: max_abs_err={err:.4e} rel={rel:.4e} "
            f"tol={tol} argmax {'FLIPPED' if flipped else 'same'} "
            f"(top-2 margin {margin:.3e})")
        if rel > tol or (flipped and margin > tol):
            raise SystemExit(f"{phase}: logits disagree at step {i}")
    return worst


PAGE = 16


def paged_engine(params, cfg, args, plan, num_pages, dev, batch=None):
    from repro_torch.serve import PagedContinuousBatchingEngine
    return PagedContinuousBatchingEngine(
        params, cfg, batch_size=batch or args.batch, max_len=args.max_len,
        plan=plan, dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        page_size=PAGE, num_pages=num_pages, device=dev)


def paged_serve_phase(args, cfg, params, dense_tokens, dev):
    """The serve phase's request mix again, through the paged engine and
    the batcher, with a pool one page larger than the first four leases
    reserve: all four rows run, the first page crossing preempts the
    newest lease, and it resumes when a row finishes.  Every request
    must finish its budget with the dense serve's tokens (or, where one
    differs, logits within LOGIT_TOL of the dense engine's on that
    request); the decode steps must launch fused_decode_block_paged; the
    plan must record no paged->dense downgrade.  Returns its launches."""
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve import RequestBatcher
    from repro_torch.serve.engine import ContinuousBatchingEngine

    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    pages_for = lambda n: -(-n // PAGE)
    num_pages = 2 + sum(pages_for(len(r.prompt) + 1)
                        for r in requests[:args.batch])
    lower.clear_plan_cache()
    plan = lower.serving_plan(cfg, args.max_len, device=dev, paged=True,
                              page_size=PAGE)
    eng = paged_engine(params, cfg, args, plan, num_pages, dev)
    counts = {"preempt": 0, "resume": 0, "peak_live": 0}
    step_s = []
    orig = eng.preempt, eng.resume, eng.decode_once

    def preempt(slot):
        counts["preempt"] += 1
        return orig[0](slot)

    def resume(pre, slot):
        counts["resume"] += 1
        return orig[1](pre, slot)

    def decode_once():
        counts["peak_live"] = max(counts["peak_live"], sum(eng.live))
        t = time.perf_counter()
        out = orig[2]()
        if out is not None:
            step_s.append(time.perf_counter() - t)
        return out

    eng.preempt, eng.resume, eng.decode_once = preempt, resume, decode_once
    batcher = RequestBatcher(args.batch, max_len=args.max_len)
    for req in requests:
        batcher.submit(req)
    ops.reset_counts()
    gc.collect()
    before = plan_clock()
    t0 = time.perf_counter()
    finished = batcher.serve(eng, max_steps=2000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    spent = plan_since(before)
    launches = dict(build.LAUNCHES)
    gen = sum(len(r.generated) for r in finished)
    step_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    elem = torch.tensor([], dtype=cfg.torch_dtype()).element_size()
    tok_bytes = 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * elem
    peak = eng.allocator.peak_used
    log(f"paged serve: pool {num_pages} pages of {PAGE} ({num_pages - 1} "
        f"usable), {len(finished)}/{len(requests)} requests, {gen} tokens in "
        f"{secs:.3f}s = {gen / secs:.2f} tok/s; decode steps {len(step_s)}, "
        f"median step {step_ms:.3f} ms")
    log(f"  KV memory: peak {peak} pages x {PAGE * tok_bytes / 2**20:.3f} "
        f"MiB = {peak * PAGE * tok_bytes / 2**20:.3f} MiB against the dense "
        f"engine's {args.batch} x {args.max_len} rows = "
        f"{args.batch * args.max_len * tok_bytes / 2**20:.3f} MiB "
        f"(ratio {peak * PAGE / (args.batch * args.max_len):.4f}); peak "
        f"live rows {counts['peak_live']}, where a dense cache of the "
        f"pool's {num_pages - 1} pages holds "
        f"{(num_pages - 1) * PAGE // args.max_len} rows of max_len; "
        f"preempts {counts['preempt']}, resumes {counts['resume']}")
    log_rates("paged serve", gen, secs, spent, len(plan.resolutions))
    log_lowerings(spent[0])
    check_served_plans("paged serve", plan, cfg)
    log(f"  launches: {launches}")
    paged_downs = [g.reason for g in plan.downgrades() if "paged" in g.reason]
    if len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit("paged serve: not every request finished its "
                         "budget")
    if not counts["preempt"] or counts["resume"] != counts["preempt"]:
        raise SystemExit(f"paged serve: expected a preempt and its resume, "
                         f"got {counts}")
    if launches.get("fused_decode_block_paged", 0) == 0:
        raise SystemExit("paged serve: fused_decode_block_paged never "
                         "launched")
    if paged_downs:
        raise SystemExit(f"paged serve: paged->dense downgrades on the "
                         f"card: {paged_downs}")
    differ = [r for r in finished if r.generated != dense_tokens[r.uid]]
    log(f"  tokens equal to the dense serve's for "
        f"{len(finished) - len(differ)}/{len(finished)} requests")
    del eng
    for req in differ:
        # the dense and the paged engine on this request alone, both fed
        # the dense serve's tokens: their logits must agree
        runs = []
        for make in (lambda: ContinuousBatchingEngine(
                params, cfg, batch_size=1, max_len=args.max_len,
                plan=lower.serving_plan(cfg, args.max_len, device=dev),
                dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
                device=dev),
                lambda: paged_engine(params, cfg, args, plan,
                                     pages_for(args.max_len) + 1, dev,
                                     batch=1)):
            runs.append(_one_request_logits(
                make(), req.prompt, dense_tokens[req.uid][:-1],
                steps=args.max_new - 1)[0])
        worst = compare_logits(f"paged serve, request {req.uid}", runs[1],
                               runs[0])
        log(f"  request {req.uid}: tokens differ, logits within tolerance "
            f"(worst rel {worst:.4e})")
    log("paged serve: ok")
    return launches


def rung_down_phase(args, cfg, params, dev):
    """A paged engine with ``demotions = 1`` serves one request past
    context 256: its decode steps take the megakernel's rung below,
    fused_qproj_attention_paged.  The same steps with the plan on the
    CPU device (fused paths on their plain versions) must give the same
    logits within LOGIT_TOL.  Returns the kernel run's launches."""
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve

    prompt = serve.make_requests(cfg, 2, args.max_new,
                                 prompt_lens=PROMPT_LENS)[1].prompt
    runs = []
    for plan_dev in (dev, torch.device("cpu")):
        plan = lower.ServingPlan(cfg=cfg, max_len=args.max_len,
                                 device=plan_dev, n_blocks=cfg.n_layers,
                                 paged=True, page_size=PAGE)
        eng = paged_engine(params, cfg, args, plan,
                           args.max_len // PAGE + 1, dev, batch=1)
        eng.demotions = 1
        ops.reset_counts()
        runs.append(_one_request_logits(
            eng, prompt, runs[0][1] if runs else None))
        if len(runs) == 1:
            launches = dict(build.LAUNCHES)
            step = f"{eng.last_dispatch.path}/{eng.last_dispatch.impl}"
        del eng
    log(f"rung-down: demotions=1, prompt {len(prompt)} tokens, decode "
        f"steps on {step}, launches {launches}")
    if launches.get("fused_qproj_attention_paged", 0) == 0:
        raise SystemExit("rung-down: fused_qproj_attention_paged never "
                         "launched")
    worst = compare_logits("rung-down", runs[0][0], runs[1][0])
    log(f"rung-down: ok (worst rel {worst:.4e} against the plain versions)")
    return launches


# ---------------------------------------------------------------------------
# chaos phase: fault-tolerant serving on the paged engine
# ---------------------------------------------------------------------------

#: clean steps before one demotion level decays in the chaos phase
CHAOS_COOLOFF = 2
#: snapshot period and crash step of the chaos phase's crash run
CHAOS_SNAPSHOT_EVERY, CHAOS_CRASH_AT = 3, 10
CHAOS_DIR = ROOT / "build" / "chaos_snapshots"


def _recorded(eng, batcher, store):
    """Wrap ``eng``'s two launch phases so ``store[(uid, i)]`` holds the
    logits that sampled request ``uid``'s token ``i`` (a prefill's first
    token, then each decode step's; a quarantined step's are replaced by
    its replay's)."""
    advance, decode = eng._advance_prefills, eng.decode_once
    fresh = set()

    def advance_prefills():
        inserted = advance()
        fresh.clear()
        for slot, _ in inserted:
            fresh.add(slot)
            req = batcher.slots[slot]
            store[(req.uid, len(req.generated))] = \
                eng.prefill_logits[slot].float()
        return inserted

    def decode_once():
        out = decode()
        if out is not None:
            for i, req in enumerate(batcher.slots):
                if req is not None and eng.live[i]:
                    # a row inserted this step is fed its first token
                    # before this one
                    n = len(req.generated) + (i in fresh)
                    store[(req.uid, n)] = eng.last_logits[i].float()
        return out

    eng._advance_prefills, eng.decode_once = advance_prefills, decode_once


def tie_check(phase, got, want, max_new) -> int:
    """``got``'s tokens against ``want``'s, request by request.  Where a
    request's stream differs, the logits that sampled its first
    differing token must agree with ``want``'s within LOGIT_TOL and its
    argmax may flip only where ``want``'s top-2 margin is under it (the
    argmax tie).  Returns the number of requests that differ."""
    differ = 0
    for uid, want_toks in sorted(want["tokens"].items()):
        toks = got["tokens"].get(uid)
        if toks is None or len(toks) != max_new:
            raise SystemExit(f"{phase}: request {uid} did not finish its "
                             f"budget ({toks})")
        if toks == want_toks:
            continue
        differ += 1
        i = next(j for j, (a, b) in enumerate(zip(toks, want_toks))
                 if a != b)
        log(f"  {phase}: request {uid} differs from token {i} "
            f"({toks[i]} against {want_toks[i]}); its logits:")
        compare_logits(f"{phase}, request {uid}", [got["logits"][(uid, i)]],
                       [want["logits"][(uid, i)]])
    return differ


def chaos_phase(args, cfg, params, dev):
    """Fault-tolerant serving on the card: the serve phase's mix through
    the paged engine (page 16, the paged serve's pool, which forces a
    preempt) under ``ServingSupervisor`` with the audit on every step.

    1. Fault-free: the tokens of ``RequestBatcher.serve`` on the same
       engine settings (the tie rule of :func:`tie_check`), and the host
       time per step of the two.
    2. Every fault kind: a ``cuda`` kernel fault (times=2) at the first
       step that only decodes, so #6 fails, its retry one rung down (#5)
       fails too, and the step runs at demotion 2 (#4); cooloff walks
       back 2 -> 1 -> 0; then a NaN at a live slot, an OOM (times=1) on
       that request's resume, and a preemption storm of 2.  Every kind
       must fire, the plan's ledger must show the kernel-failure
       rung-down, #4 must launch at demotion 2, #5 at demotion 1 and #6
       again at demotion 0, and the tokens must be the fault-free ones
       (tie rule).
    3. The seeded schedule (``FaultInjector.from_seed(0, ...,
       impl="cuda")``) twice: the same ledger JSON and fired log, and
       the fault-free tokens (tie rule).
    4. A crash: snapshots every CHAOS_SNAPSHOT_EVERY steps; after step
       CHAOS_CRASH_AT engine, batcher and supervisor are dropped and the
       latest snapshot restored into fresh ones; the finished tokens
       must equal the fault-free run's exactly.
    Returns the launches of step 2's run."""
    import shutil

    from repro_torch import lower
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve import (FaultInjector, FaultSpec, RequestBatcher,
                                   ServingSupervisor)

    card = card_line()
    pages_for = lambda n: -(-n // PAGE)
    num_pages = 2 + sum(
        pages_for(len(r.prompt) + 1) for r in serve.make_requests(
            cfg, args.requests, args.max_new,
            prompt_lens=PROMPT_LENS)[:args.batch])

    def stack():
        """A fresh paged engine (its own plan handle, on a cleared plan
        cache, so its downgrade ledger is this run's) and batcher with
        the mix submitted."""
        lower.clear_plan_cache()
        plan = lower.serving_plan(cfg, args.max_len, device=dev, paged=True,
                                  page_size=PAGE)
        eng = paged_engine(params, cfg, args, plan, num_pages, dev)
        batcher = RequestBatcher(args.batch, max_len=args.max_len)
        for req in serve.make_requests(cfg, args.requests, args.max_new,
                                       prompt_lens=PROMPT_LENS):
            batcher.submit(req)
        return eng, batcher

    def recovery(eng):
        return [g.reason for g in eng.plan.downgrades()
                if "kernel-failure recovery" in g.reason]

    def supervised(inj=None, crash_at=None, **kw):
        """One supervised run; per step: (demotions at its start, its
        ops.CALLS, the rows live at its end)."""
        eng, batcher = stack()
        store, per_step, snap_s = {}, [], []
        _recorded(eng, batcher, store)
        ckpt = None
        if crash_at is not None:
            shutil.rmtree(CHAOS_DIR, ignore_errors=True)
            ckpt = CheckpointManager(str(CHAOS_DIR), keep_last=2)
        sup = ServingSupervisor(
            eng, batcher, injector=inj, cooloff=CHAOS_COOLOFF,
            audit_every=1, ckpt=ckpt,
            checkpoint_every=CHAOS_SNAPSHOT_EVERY if ckpt else None, **kw)
        step, checkpoint = sup.step, sup.checkpoint

        def traced():
            before, level = collections.Counter(ops.CALLS), eng.demotions
            step()
            per_step.append((level, collections.Counter(ops.CALLS) - before,
                             [i for i in range(args.batch) if eng.live[i]]))
            if sup.t == crash_at:
                raise _Crash

        def timed_checkpoint(blocking=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint(blocking)
            snap_s.append(time.perf_counter() - t0)

        sup.step, sup.checkpoint = traced, timed_checkpoint
        ops.reset_counts()
        torch.cuda.synchronize()
        gc.collect()
        before = plan_clock()
        t0 = time.perf_counter()
        try:
            finished = sup.serve(max_steps=2000)
        except _Crash:
            finished = None
        torch.cuda.synchronize()
        out = {"secs": time.perf_counter() - t0, "steps": sup.t,
               "plan": plan_since(before),
               "logits": store, "per_step": per_step, "snap_s": snap_s,
               "launches": dict(build.LAUNCHES), "recovery": recovery(eng),
               "fired": None if inj is None else list(inj.fired),
               "ledger": sup.ledger.to_json(), "sup": sup}
        if finished is not None:
            if sup.failed:
                raise SystemExit(f"chaos: requests failed "
                                 f"{[r.uid for r in sup.failed]}")
            out["tokens"] = {r.uid: list(r.generated) for r in finished}
        return out

    # 1. fault-free: the batcher's run, the supervisor's, the batcher's
    def unsupervised():
        eng, batcher = stack()
        out, steps = {"logits": {}}, [0]
        _recorded(eng, batcher, out["logits"])
        engine_step = eng.step

        def counted_step():
            steps[0] += 1
            return engine_step()

        eng.step = counted_step
        torch.cuda.synchronize()
        gc.collect()
        before = plan_clock()
        t0 = time.perf_counter()
        finished = batcher.serve(eng, max_steps=2000)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) / steps[0] * 1e3
        out["plan"] = plan_since(before)
        out["bare_ms"] = out["ms"] - out["plan"][1] / steps[0] * 1e3
        out["tokens"] = {r.uid: list(r.generated) for r in finished}
        return out

    # the first run warms up; the timed ones go in turns: supervised,
    # plain, plain, supervised
    plain = unsupervised()
    base = supervised()
    plains = [unsupervised() for _ in range(2)]
    plain_ms = [p["ms"] for p in plains]
    again = supervised()
    sup_ms = [r["secs"] / r["steps"] * 1e3 for r in (base, again)]
    sup_bare = [(r["secs"] - r["plan"][1]) / r["steps"] * 1e3
                for r in (base, again)]
    plain_bare = [p["bare_ms"] for p in plains]
    if base["recovery"] or base["fired"]:
        raise SystemExit("chaos: a rung-down in the fault-free run")
    n = tie_check("chaos fault-free", base, plain, args.max_new)
    if again["tokens"] != base["tokens"]:
        raise SystemExit("chaos: two fault-free supervised runs differ")
    log(f"chaos: fault-free supervised run (audit every step): "
        f"{base['steps']} steps, {len(base['tokens'])} requests; tokens "
        f"equal to RequestBatcher.serve's for "
        f"{len(base['tokens']) - n}/{len(base['tokens'])} (the rest "
        f"argmax ties)")
    log(f"  host time per step: supervised {sup_ms[0]:.3f}, {sup_ms[1]:.3f} "
        f"ms, RequestBatcher.serve {plain_ms[0]:.3f}, {plain_ms[1]:.3f} ms "
        f"(in turns; a first, warm-up run of the batcher "
        f"{plain['ms']:.3f} ms): overhead "
        f"{statistics.mean(sup_ms) - statistics.mean(plain_ms):+.3f} ms a "
        f"step ({card})")
    gcs = ", ".join(f"{r['plan'][2] * 1e3:.1f}"
                    for r in (base, again, plains[0], plains[1]))
    log(f"  without plan resolution (each run clears the plan cache and "
        f"pays {base['plan'][0]} cold lowerings: supervised "
        f"{base['plan'][1] * 1e3:.1f}, {again['plan'][1] * 1e3:.1f} ms, "
        f"batcher {plains[0]['plan'][1] * 1e3:.1f}, "
        f"{plains[1]['plan'][1] * 1e3:.1f} ms; garbage collection {gcs} "
        f"ms): supervised {sup_bare[0]:.3f}, {sup_bare[1]:.3f} ms, "
        f"RequestBatcher.serve {plain_bare[0]:.3f}, {plain_bare[1]:.3f} ms "
        f"a step: overhead "
        f"{statistics.mean(sup_bare) - statistics.mean(plain_bare):+.3f} ms")
    del plain, again, plains

    # 2. every fault kind; the kernel fault at the first step that only
    # decodes (prefill chunks run dense: every call is a paged one)
    per_step = base["per_step"]
    k = next(t for t, (_, calls, _) in enumerate(per_step)
             if t >= 3 and calls and all(e.endswith("_paged")
                                         for e, _ in calls))
    if len(per_step) <= k + 9:
        raise SystemExit(f"chaos: the fault-free run ends at step "
                         f"{len(per_step)}, before the schedule")
    nan_slot = next((i for i in per_step[k + 5][2] if i in per_step[k + 6][2]),
                    None)
    if nan_slot is None:
        raise SystemExit(f"chaos: no row live through step {k + 6}")
    schedule = [FaultSpec("kernel", step=k, impl="cuda", times=2),
                FaultSpec("nan", step=k + 6, slot=nan_slot),
                FaultSpec("oom", step=k + 7, times=1),
                FaultSpec("preempt", step=k + 9, count=2)]
    specs = [(f.kind, f.step, f.slot, f.times, f.count) for f in schedule]
    log(f"chaos: schedule (kind, step, slot, times, count) {specs}, "
        f"cooloff {CHAOS_COOLOFF}")
    inj = FaultInjector(schedule)
    run = supervised(inj)
    rows = [(i.step, i.slot, i.fault, i.action)
            for i in run["sup"].ledger.incidents]
    log(f"  fired: {run['fired']}")
    log(f"  ledger: {rows}")
    by_level = collections.defaultdict(collections.Counter)
    for t, (level, calls, _) in enumerate(run["per_step"]):
        # the fault's step ran its last attempt at demotion 2; a step
        # starting at 0 after it runs once the demotion has decayed
        label = 2 if t == k else "after" if t > k and level == 0 else level
        by_level[label].update(calls)
    shown = {lv: dict(c) for lv, c in by_level.items()}
    log(f"  calls by demotion: {shown}")
    log(f"  launches: {run['launches']}")
    kinds = {f[1] for f in run["fired"]}
    if kinds != {"kernel", "nan", "oom", "preempt"}:
        raise SystemExit(f"chaos: fault kinds fired {kinds}")
    if run["fired"][:2] != [(k, "kernel", "decode_block/cuda"),
                            (k, "kernel", "qproj_attention/cuda")]:
        raise SystemExit(f"chaos: the kernel fault did not fail #6 and "
                         f"then #5: {run['fired'][:2]}")
    if not run["recovery"]:
        raise SystemExit("chaos: no kernel-failure rung-down on the plan's "
                         "ledger")
    want = {2: ("attention_paged", "cuda"),
            1: ("qproj_attention_paged", "cuda"),
            "after": ("decode_block_paged", "cuda")}
    missing = [(lv, e) for lv, e in want.items() if not by_level[lv][e]]
    if missing or run["sup"].engine.demotions:
        raise SystemExit(f"chaos: not launched at their demotion: {missing}"
                         f"; demotions left {run['sup'].engine.demotions}")
    n = tie_check("chaos all kinds", run, base, args.max_new)
    log(f"chaos: all kinds ok ({run['steps']} steps; tokens equal to the "
        f"fault-free run's for {len(run['tokens']) - n}/"
        f"{len(run['tokens'])}, the rest argmax ties; #4, #5 and #6 "
        f"launched at demotions 2, 1 and 0; audit clean every step; "
        f"rung-downs on the plan's ledger: {len(run['recovery'])})")
    launches = run["launches"]
    del run

    # 3. the seeded schedule, twice
    seeded = [supervised(FaultInjector.from_seed(
        0, steps=base["steps"], slots=args.batch, rate=0.3, impl="cuda"),
        retry_budget=8) for _ in range(2)]
    a, b = seeded
    log(f"chaos: seeded schedule (seed 0, rate 0.3): fired {a['fired']}")
    if a["fired"] != b["fired"] or a["ledger"] != b["ledger"]:
        raise SystemExit("chaos: the seeded ledger or fired log differs "
                         "between two runs")
    n = [tie_check(f"chaos seeded run {i}", r, base, args.max_new)
         for i, r in enumerate(seeded)]
    log(f"chaos: seeded ok (ledger of {len(a['sup'].ledger)} incidents and "
        f"the fired log identical in two runs; requests whose tokens "
        f"differ from the fault-free run's, argmax ties: {n})")
    del seeded, a, b

    # 4. a crash and a restore from the latest snapshot
    crashed = supervised(crash_at=CHAOS_CRASH_AT)
    latest, snap_s = crashed["sup"].ckpt.latest_step(), crashed["snap_s"]
    mb = sum(f.stat().st_size for f in
             (CHAOS_DIR / f"step_{latest:09d}").iterdir()) / 1e6
    del crashed                   # the crash: engine, batcher, supervisor
    gc.collect()
    eng, batcher = stack()        # restore replaces the queue
    sup = ServingSupervisor(eng, batcher, cooloff=CHAOS_COOLOFF,
                            audit_every=1,
                            ckpt=CheckpointManager(str(CHAOS_DIR)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup.restore()
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    tokens = {r.uid: list(r.generated) for r in sup.serve(max_steps=2000)}
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    log(f"chaos: crash after step {CHAOS_CRASH_AT}, restored the snapshot "
        f"of step {latest} ({mb:.3f} MB) in {restore_ms:.3f} ms; snapshots "
        f"written in {[round(x * 1e3, 3) for x in snap_s]} ms ({card})")
    if sup.failed or tokens != base["tokens"]:
        raise SystemExit("chaos: the restored run's tokens differ from the "
                         "uncrashed run's")
    log("chaos: restore ok (tokens equal to the uncrashed run's)")
    del eng, batcher, sup, base
    gc.collect()
    return launches


class _Crash(Exception):
    """Ends a chaos run at its crash step (the simulated crash)."""


def timed_decode(eng, steps):
    """``steps`` decode steps of ``eng``, each on the host clock between
    synchronizes: (the last step's tokens, "median step ... ms" text)."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.decode_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return toks, (f"median step {statistics.median(times):.3f} ms "
                  f"({min(times):.3f}-{max(times):.3f})")


def qwen_phase(dev):
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    args = serve.parser().parse_args([
        "--arch", "qwen3-8b", "--layers", "4", "--batch", "2",
        "--max-len", "512", "--prefill-chunk", "256", "--device", "cuda"])
    cfg, params = serve.model_for(args)
    before = plan_clock()
    plan = lower.serving_plan(cfg, args.max_len, device=dev)
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len, plan=plan,
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=dev)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
               for n in (300, 333)]
    for slot, prompt in enumerate(prompts):
        eng.begin_prefill(slot, prompt)
    while eng._pending:
        eng._advance_prefills()
    ops.reset_counts()
    steps = 8
    toks, step_ms = timed_decode(eng, steps)
    launches = dict(build.LAUNCHES)
    paths = {r[3] for r in plan.resolutions if r[0] == "decode"}
    log(f"qwen: {cfg.name} d_model={cfg.d_model} cut to {cfg.n_layers} "
        f"layers, prompts 300/333, {steps} decode steps: decode paths "
        f"{sorted(paths)}, launches {launches}, tokens {toks.tolist()}, "
        f"{step_ms}")
    log_lowerings(plan_since(before)[0])
    check_served_plans("qwen", plan, cfg)
    if launches.get("fused_attention_masked", 0) == 0:
        raise SystemExit("qwen: decode never launched "
                         "fused_attention_masked")
    if not torch.isfinite(eng.last_logits).all():
        raise SystemExit("qwen: non-finite logits")
    dense_logits = eng.last_logits.float()
    del eng

    # the same prompts through the paged engine: decode past 256 runs
    # fused_attention_paged
    launches = collections.Counter(launches)
    plan = lower.serving_plan(cfg, args.max_len, device=dev, paged=True,
                              page_size=PAGE)
    eng = paged_engine(params, cfg, args, plan,
                       args.batch * args.max_len // PAGE + 1, dev)
    for slot, prompt in enumerate(prompts):
        eng.begin_prefill(slot, prompt)
    while eng._pending:
        eng._advance_prefills()
    ops.reset_counts()
    toks, step_ms = timed_decode(eng, steps)
    paged = dict(build.LAUNCHES)
    log(f"qwen paged: page {PAGE}, {steps} decode steps: launches {paged}, "
        f"tokens {toks.tolist()}, {step_ms}")
    if paged.get("fused_attention_paged", 0) == 0:
        raise SystemExit("qwen: paged decode never launched "
                         "fused_attention_paged")
    # the last step's logits, row by row, against the dense engine's
    compare_logits("qwen paged", list(eng.last_logits.float()),
                   list(dense_logits))
    launches.update(paged)
    del params, eng
    torch.cuda.empty_cache()
    return launches


#: the two dense configs added with the DSE core: full width, depth cut
NEW_DENSE = ("qwen3-14b", "starcoder2-15b")
NEW_DENSE_LAYERS = 4


def new_dense_phase(dev):
    """qwen3-14b (GQA group 5) and starcoder2-15b (group 12) at full
    width, cut to NEW_DENSE_LAYERS layers: the serve mix's prompts (4
    requests, 8 new tokens each) through ``serve.run`` on plans lowered
    by the DSE, then one request on the kernels against the same steps
    on the plain versions (LOGIT_TOL).  starcoder2-15b must launch
    #1-#3; qwen3-14b's qk-norm walks its Q-fusion rungs down to #1 (a
    downgrade on the plan's ledger, as qwen3-8b's).  Returns the
    launches of the two serves."""
    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    launches = collections.Counter()
    for arch in NEW_DENSE:
        args = serve.parser().parse_args([
            "--arch", arch, "--layers", str(NEW_DENSE_LAYERS), "--batch",
            "4", "--requests", "4", "--max-len", "1024", "--max-new", "8",
            "--prefill-chunk", "256", "--device", "cuda"])
        cfg, params = serve.model_for(args)
        requests = serve.make_requests(cfg, args.requests, args.max_new,
                                       prompt_lens=PROMPT_LENS)
        lower.clear_plan_cache()
        gc.collect()
        before = plan_clock()
        ops.reset_counts()
        out = serve.run(args, cfg, params, requests)
        torch.cuda.synchronize()
        got = dict(build.LAUNCHES)
        spent = plan_since(before)
        finished = out["finished"]
        gen = sum(len(r.generated) for r in finished)
        steps = out["decode_step_s"]
        log(f"{arch}: d_model={cfg.d_model}, {cfg.n_heads} query heads over "
            f"{cfg.kv_heads} KV heads (group {cfg.n_heads // cfg.kv_heads}), "
            f"cut to {cfg.n_layers} layers; {len(finished)}/{len(requests)} "
            f"requests, median decode step "
            f"{sorted(steps)[len(steps) // 2] * 1e3:.3f} ms; launches {got}")
        log_rates(arch, gen, out["seconds"], spent,
                  len(out["plan"].resolutions))
        log_lowerings(spent[0])
        check_served_plans(arch, out["plan"], cfg)
        downs = sorted({d.reason for d in out["plan"].downgrades()})
        log(f"  plan ledger: {downs or 'no downgrade'}")
        want = ("fused_attention_masked",) if cfg.qk_norm else DENSE_KERNELS
        missing = [n for n in want if not got.get(n)]
        extra = [n for n in got if n not in want]
        if missing or extra or len(finished) != len(requests) or any(
                len(r.generated) != args.max_new for r in finished):
            raise SystemExit(f"{arch}: kernels missing {missing}, "
                             f"unexpected {extra}, or a request short")
        if cfg.qk_norm and not any("qk-norm" in d for d in downs):
            raise SystemExit(f"{arch}: no qk-norm downgrade on the ledger")
        launches.update(got)
        runs = []
        for plan_dev in (dev, torch.device("cpu")):
            plan = lower.ServingPlan(cfg=cfg, max_len=args.max_len,
                                     device=plan_dev, n_blocks=cfg.n_layers)
            eng = ContinuousBatchingEngine(
                params, cfg, batch_size=1, max_len=args.max_len, plan=plan,
                dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
                device=dev)
            runs.append(_one_request_logits(eng, requests[1].prompt,
                                            runs[0][1] if runs else None))
            del eng
        worst = compare_logits(arch, runs[0][0], runs[1][0])
        log(f"{arch}: ok (prompt {len(requests[1].prompt)} tokens, prefill "
            f"+ {DECODE_COMPARED} decode steps, worst rel {worst:.4e})")
        del params, out
        torch.cuda.empty_cache()
    return launches


#: the three cells of validate_costmodel_torch.py the smoke run takes:
#: prefill either side of M = N = 128, decode past C = 2N = 256
PLAN_CELLS = (("prefill", 64, 64), ("prefill", 256, 256),
              ("decode", 1, 1024))


def plan_phase(dev):
    """The DSE's ranking on the card: starcoder2-7b at full width, one
    block, the three PLAN_CELLS of ``validate_costmodel_torch.py``;
    each candidate path's attention sub-block timed and its peak
    memory read, against the plan's predicted cycles and peak words.
    Launches here are not the main path's."""
    import validate_costmodel_torch as vc
    rows = vc.validate(dev, PLAN_CELLS, log=log)
    vc.print_rows(rows, log=lambda t: log("  " + t))
    tot = vc.print_agreement(rows, log=lambda t: log("  " + t))
    log(f"plan: ok ({len(rows)} candidates in {len(PLAN_CELLS)} cells; "
        f"latency ranking {vc._frac(*tot['latency'])}, memory "
        f"{vc._frac(*tot['memory'])}; {card_line()})")


# ---------------------------------------------------------------------------
# Mamba-2: kernel #11, the cache-free forward, the served mix
# ---------------------------------------------------------------------------

#: mamba2-130m's SSD widths: H heads of width P, G groups, state S
MAMBA = dict(H=24, P=64, G=1, S=128, CHUNK=128)
#: fp32 tolerance of #11 against its plain version, relative to the
#: largest magnitude: both compute in fp32, summing in other orders
SSD_TOL_F32 = 1e-4


#: dt's scale in #11's long-memory inputs: a dt about -0.05 a position,
#: so the state carries across 128-position chunks.  At the other inputs'
#: a dt of about -1 it decays to nothing within a chunk, and a dropped
#: or stale incoming state could pass a gate.
SSD_LONG_DT = 0.05


def ssd_unfused(x, dt, a, b, c, d, chunk, h0):
    """#11's yardstick, for reference only (the port never calls it):
    the chunked SSD with every chunk at once, the products batched
    through torch.einsum in the inputs' dtype (the decay terms in fp32,
    cast for the products, as the kernel rounds them), and the chunk
    states passed by one batched fp32 product over the (chunk, chunk)
    matrix of decays, as the Mamba-2 reference's minimal SSD does.
    Returns (y, the final state)."""
    bsz, length, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    rep, nj = h // g, -(-length // chunk)
    lp, dtype = nj * chunk, x.dtype

    def pad(t):
        return torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, lp - length))

    xc = pad(x).reshape(bsz, nj, chunk, h, p)
    dtc = pad(dt).float().reshape(bsz, nj, chunk, h)
    bg = pad(b).reshape(bsz, nj, chunk, g, s)
    cg = pad(c).reshape(bsz, nj, chunk, g, s)
    cum = torch.cumsum(dtc * a.float(), dim=2)              # (B, nj, C, H)
    total = cum[:, :, -1]                                   # (B, nj, H)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    cumh = cum.transpose(2, 3)                              # (B, nj, H, C)
    rel = torch.where(tri, cumh[..., :, None] - cumh[..., None, :], 0.0)
    lmat = torch.where(tri, torch.exp(rel)
                       * dtc.transpose(2, 3)[..., None, :], 0.0)
    cb = torch.einsum("bjtgs,bjugs->bjgtu", cg, bg).float() \
        .repeat_interleave(rep, 2)                          # (B,nj,H,C,C)
    y = torch.einsum("bjhtu,bjuhp->bjthp", (cb * lmat).to(dtype), xc).float()
    w = torch.exp(total[:, :, None] - cum) * dtc            # (B, nj, C, H)
    own = torch.einsum("bjuhp,bjuhs->bjhps", xc,
                       (bg.repeat_interleave(rep, 3).float()
                        * w[..., None]).to(dtype)).float()
    init = torch.zeros_like(own[:, :1]) if h0 is None else h0.float()[:, None]
    states = torch.cat([init, own], dim=1)                  # (B,nj+1,H,P,S)
    # the state entering chunk j (row nj: the final state) from state i
    # (0: h0; i: chunk i-1's own) decays by exp(ct[j] - ct[i]), i <= j
    ct = torch.nn.functional.pad(torch.cumsum(total, 1), (0, 0, 1, 0))
    live = torch.tril(torch.ones(nj + 1, nj + 1, dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    dm = torch.where(live, ct[:, :, None] - ct[:, None], 0.0)
    passed = torch.einsum("bjih,bihps->bjhps", torch.where(
        live, torch.exp(dm), 0.0), states)                  # (B,nj+1,H,P,S)
    y_inter = torch.einsum("bjths,bjhps->bjthp", cg.repeat_interleave(rep, 3),
                           passed[:, :nj].to(dtype)).float()
    y = y + torch.exp(cum)[..., None] * y_inter
    y = y.reshape(bsz, lp, h, p)[:, :length]
    if d is not None:
        y = y + d.float()[None, None, :, None] * x.float()
    return y.to(dtype), passed[:, nj]


def ssd_plain_dropped(args, chunk, h0, drop):
    """The plain version with chunk ``drop``'s incoming state dropped
    (zeros in its place): what a body that lost one link of the chain
    would give."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    x, dt, a, b, c, d = args
    cut = drop * chunk
    y1 = ssd_scan_plain(x[:, :cut], dt[:, :cut], a, b[:, :cut], c[:, :cut],
                        d, chunk=chunk, h0=h0)
    y2, h2 = ssd_scan_plain(x[:, cut:], dt[:, cut:], a, b[:, cut:],
                            c[:, cut:], d, chunk=chunk,
                            return_final_state=True)
    return torch.cat([y1, y2], dim=1), h2


def ssd_kernel_phase(dev, g):
    """#11 against its plain version in bf16 and fp32, y and the final
    state, at the serve path's prefill chunk (off the chunk grid, with a
    non-zero h0) and the cache-free forward's shape, each within
    KERNEL_TOL (bf16) or SSD_TOL_F32 of the largest |want|; in bf16 also
    per (row, position, head) of y and (row, head, P row) of the state
    within ROW_TOL of that row's largest |want|, and bitwise repeatable.
    Then the same two shapes with long-memory inputs (dt scaled by
    SSD_LONG_DT, with h0): the per-row gate, and that gate shown to
    reject the plain result with one chunk's incoming state dropped.
    Times both shapes in bf16, with the unfused yardstick beside them."""
    timed = ssd_records(dev, g, MAMBA, (
        ("serve chunk", 1, 188, True, 1.0),
        ("cache-free", 4, 2048, False, 1.0),
        ("serve chunk, long memory", 1, 188, True, SSD_LONG_DT),
        ("cache-free, long memory", 4, 2048, True, SSD_LONG_DT)))
    return {"ssd_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:102",
        **timed["cache-free"])}


def ssd_records(dev, g, dims, cases) -> dict:
    """ssd_kernel_phase's checks and timings of #11 at the heads of
    ``dims`` (H, P, G, S, CHUNK), for each case (tag, B, L, with h0, dt
    scale): bf16 and fp32 against the plain version, in bf16 per row
    and bitwise repeatable; a long-memory case (dt scale below 1)
    shows the per-row gate rejecting a dropped incoming state, every
    other case is timed.  Returns {tag: record} of the timed cases."""
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan, \
        ssd_scan_plain

    H, P, G, S, C = (dims[k] for k in ("H", "P", "G", "S", "CHUNK"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(b, length, dtype, dt_scale=1.0):
        def r(*shape):
            return torch.randn(*shape, generator=g, device=dev)
        return ((r(b, length, H, P).to(dtype),
                 (torch.nn.functional.softplus(r(b, length, H))
                  * dt_scale).to(dtype),
                 -torch.exp(r(H)), (r(b, length, G, S) * 0.3).to(dtype),
                 (r(b, length, G, S) * 0.3).to(dtype), r(H)),
                r(b, H, P, S) * 0.5)

    timed = {}
    for tag, b, length, with_h0, dt_scale in cases:
        long_memory = dt_scale != 1.0
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                           (torch.float32, SSD_TOL_F32)):
            if long_memory and dtype != torch.bfloat16:
                continue
            args, h0 = inputs(b, length, dtype, dt_scale)
            h0 = h0 if with_h0 else None
            f = lambda: ssd_scan(*args, chunk=C, h0=h0,
                                 return_final_state=True)
            p_ = lambda: ssd_scan_plain(*args, chunk=C, h0=h0,
                                        return_final_state=True)
            (y, h), (wy, wh) = f(), p_()
            torch.cuda.synchronize()
            errs = []
            for what, got, want in (("y", y, wy), ("state", h, wh)):
                err, rel = rel_err(got, want)
                ok = bool(torch.isfinite(got.float()).all()) and rel <= tol
                log(f"  ssd_scan [{tag} B={b} L={length} h0={with_h0} "
                    f"{str(dtype)[6:]} {what}] max_abs_err={err:.3e} "
                    f"rel={rel:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"ssd_scan disagrees with its plain "
                                     f"version ({tag}, {dtype}, {what})")
                errs.append(err)
            if dtype != torch.bfloat16:
                continue
            plan = ssd_plan(b, length, H, P, G, S, C, n_sm)
            log(f"  ssd_scan [{tag}] plan: {plan.n_items} items of {plan.ht} "
                f"heads x {plan.pw} P columns, {plan.nj} chunks")
            row_gate("ssd_scan", tag, {"y": (y, wy), "state": (h, wh)})
            y2, h2 = f()
            same = bool(torch.equal(y2, y) and torch.equal(h2, h))
            log(f"  ssd_scan [{tag}] bitwise repeatable: {same}")
            if not same:
                raise SystemExit(f"ssd_scan is not bitwise repeatable ({tag})")
            if long_memory:
                drop = plan.nj // 2
                dy, dh = ssd_plain_dropped(args, C, h0, drop)
                row_gate("ssd_scan", f"{tag}: plain with chunk {drop}'s "
                         f"incoming state dropped",
                         {"y": (dy, wy), "state": (dh, wh)}, expect=False)
                continue
            flops, byts = cost.cost("ssd_scan", b, length, H, P, G, S, C,
                                    el=args[0].element_size(), h0=with_h0)
            bms, by = cost.bound_ms(flops, byts)
            u = lambda: ssd_unfused(*args, C, h0)
            uy, uh = u()
            _, urel = rel_err(uy, wy)
            _, urel_h = rel_err(uh, wh)
            timed[tag] = dict(max_abs_err=errs[0], ms=time_ms(f, 20),
                              plain_ms=time_ms(p_, 3), bound_ms=bms,
                              bound_by=by, library_ms=None,
                              unfused_ms=time_ms(u, 5))
            t = timed[tag]
            log(f"  ssd_scan [{tag}] kernel_ms={t['ms']:.4f} plain_ms="
                f"{t['plain_ms']:.4f} bound_ms={bms:.4f} ({by}: "
                f"{byts / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP) "
                f"library_ms=null (no PyTorch call computes the scan); "
                f"unfused_ms={t['unfused_ms']:.4f} (batched einsum "
                f"chunks, for reference only; its rel err y {urel:.3e}, "
                f"state {urel_h:.3e})")
    return timed


def _ssd_side_by_side(ops, worst):
    """An ``ops.ssd`` that runs the plain version and, on the same
    inputs, the kernel; records the kernel's error relative to the plain
    output's largest magnitude in ``worst`` and returns the plain output
    (so the forward stays on the plain path)."""
    orig = ops.ssd

    def both(*a, **kw):
        want = orig(*a, **dict(kw, impl="torch"))
        got = orig(*a, **dict(kw, impl="cuda"))
        pairs = zip(want, got) if isinstance(want, tuple) else \
            [(want, got)]
        worst.append(max(rel_err(g_, w_)[1] for w_, g_ in pairs))
        return want
    return orig, both


def mamba_forward_phase(dev):
    """The TPU's #11 path: the cache-free forward of mamba2-130m at full
    width and depth, B=4, L=2048, bf16, on the kernel and on the plain
    versions.  The bf16 logits of the two are compared and reported
    beside the plain versions' own spread (the same forward with the
    chunk halved: the same function, summed in another order); the
    gates are each layer's #11 output against the plain version's on
    the same inputs along the plain forward (bf16, KERNEL_TOL), and the
    whole forward with the compute dtype raised to fp32, kernel against
    plain versions (LOGIT_TOL)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import init_params

    cfg = configs.get_config("mamba2-130m")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                         device=dev)
    with torch.no_grad():
        tf.forward(params, cfg, toks[:, :256])          # warm-up
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        got = tf.forward(params, cfg, toks)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        launches = collections.Counter(build.LAUNCHES)
        t0 = time.perf_counter()
        want = tf.forward(params, cfg, toks, impl="torch")
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        if got.shape != (4, 2048, cfg.vocab_size) or not bool(
                torch.isfinite(got.float()).all()):
            raise SystemExit("mamba forward: logits of the wrong shape or "
                             "not finite")
        err, rel = rel_err(got, want)
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        del got
        half = tf.forward(params, dataclasses.replace(cfg, ssd_chunk=64),
                          toks, impl="torch")
        _, floor = rel_err(half, want)
        del half
        worst = []
        orig, both = _ssd_side_by_side(ops, worst)
        ops.ssd = both
        try:
            tf.forward(params, cfg, toks)
        finally:
            ops.ssd = orig
        del want
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        got32 = tf.forward(params, cfg32, toks)
        want32 = tf.forward(params, cfg32, toks, impl="torch")
        _, rel32 = rel_err(got32, want32)
        del got32, want32
    log(f"mamba forward: {cfg.name} {cfg.n_layers} layers d_model="
        f"{cfg.d_model} bf16, B=4 L=2048 cache-free: {k_ms:.3f} ms on the "
        f"kernel, {p_ms:.3f} ms on the plain versions (host clock); "
        f"ssd_scan launches {launches['ssd_scan']}")
    log(f"  bf16 logits, kernel against plain versions: max_abs_err="
        f"{err:.4e} rel={rel:.4e}, argmax agreement {same:.4f}; the plain "
        f"versions against themselves at chunk 64: rel={floor:.4e}")
    log(f"  each layer's ssd_scan against the plain version on its inputs "
        f"(bf16): worst rel={max(worst):.4e} over {len(worst)} layers "
        f"tol={KERNEL_TOL}")
    log(f"  fp32 compute, logits kernel against plain versions: "
        f"rel={rel32:.4e} tol={LOGIT_TOL}")
    if launches["ssd_scan"] != cfg.n_layers:
        raise SystemExit(f"mamba forward: {launches['ssd_scan']} ssd_scan "
                         f"launches, expected {cfg.n_layers}")
    if len(worst) != cfg.n_layers or max(worst) > KERNEL_TOL:
        raise SystemExit("mamba forward: a layer's ssd_scan disagrees "
                         "with the plain version")
    if rel32 > LOGIT_TOL:
        raise SystemExit("mamba forward: fp32 logits disagree with the "
                         "plain versions'")
    del params
    torch.cuda.empty_cache()
    return launches


def mamba_serve_phase(dev):
    """launch/serve on mamba2-130m at full depth with the dense serve's
    request mix: no serving plan, #11 on every multi-token prefill chunk
    (a one-token last chunk takes the decode step), ssd_step in decode."""
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    args = serve.parser().parse_args([
        "--arch", "mamba2-130m", "--batch", "4", "--requests", "6",
        "--max-len", "1024", "--max-new", "16", "--prefill-chunk", "256",
        "--device", "cuda"])
    cfg, params = serve.model_for(args)
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    lens = [len(r.prompt) for r in requests]
    chunks = sum(sum(1 for st in range(0, n, args.prefill_chunk)
                     if n - st > 1) for n in lens)
    predicted = cfg.n_layers * chunks
    log(f"mamba serve: {cfg.name} {cfg.n_layers} layers bf16 random "
        f"weights (seed 0); prompts {lens} tokens, chunk "
        f"{args.prefill_chunk}: {chunks} multi-token chunks, so "
        f"{predicted} ssd_scan launches predicted")
    ops.reset_counts()
    out = serve.run(args, cfg, params, requests)
    launches = collections.Counter(build.LAUNCHES)
    calls = dict(ops.CALLS)
    finished, secs = out["finished"], out["seconds"]
    gen = sum(len(r.generated) for r in finished)
    steps = out["decode_step_s"]
    step_ms = sorted(steps)[len(steps) // 2] * 1e3
    log(f"  finished {len(finished)}/{len(requests)} requests, {gen} "
        f"tokens in {secs:.3f}s = {gen / secs:.2f} tok/s; decode steps "
        f"{len(steps)}, median step {step_ms:.3f} ms")
    for r in sorted(finished, key=lambda r: r.uid):
        log(f"  req {r.uid}: prompt {len(r.prompt)} -> {r.generated}")
    log(f"  launches: {dict(launches)}; calls by impl: "
        f"{ {f'{e}/{i}': n for (e, i), n in sorted(calls.items())} }")
    if out["plan"] is not None:
        raise SystemExit("mamba serve: a serving plan for an SSM config")
    if len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit("mamba serve: not every request finished")
    if launches["ssd_scan"] != predicted:
        raise SystemExit(f"mamba serve: {launches['ssd_scan']} ssd_scan "
                         f"launches, predicted {predicted}")

    # one request again, fed the kernel run's tokens: on the plain
    # versions with each prefill chunk's ssd_scan run beside them on the
    # same inputs (the gate, KERNEL_TOL), and at chunk 64 (the plain
    # versions' own spread); then both with the compute dtype raised to
    # fp32 (the gate, LOGIT_TOL)
    import dataclasses
    prompt = requests[1].prompt
    worst = []
    orig, both = _ssd_side_by_side(ops, worst)

    def one(c, impl, forced=None, side=False):
        eng = ContinuousBatchingEngine(
            params, c, batch_size=1, max_len=args.max_len,
            dtype=c.torch_dtype(), prefill_chunk=args.prefill_chunk,
            device=dev, impl=impl)
        if side:
            ops.ssd = both
        try:
            return _one_request_logits(eng, prompt, forced)
        finally:
            ops.ssd = orig

    k_logits, toks = one(cfg, "auto")
    p_logits, _ = one(cfg, "torch", toks, side=True)
    h_logits, _ = one(dataclasses.replace(cfg, ssd_chunk=64), "torch", toks)
    for i, (a, b, h) in enumerate(zip(k_logits, p_logits, h_logits)):
        err, rel = rel_err(a, b)
        log(f"  bf16 step {i}: kernel against plain versions max_abs_err="
            f"{err:.4e} rel={rel:.4e}, argmax "
            f"{'same' if int(a.argmax()) == int(b.argmax()) else 'FLIPPED'}"
            f"; plain versions at chunk 64 rel={rel_err(h, b)[1]:.4e}")
    log(f"  each prefill chunk's ssd_scan against the plain version on its "
        f"inputs (bf16): worst rel={max(worst):.4e} over {len(worst)} "
        f"calls tol={KERNEL_TOL}")
    calls = cfg.n_layers * sum(1 for st in range(0, len(prompt),
                                                 args.prefill_chunk)
                               if len(prompt) - st > 1)
    if len(worst) != calls or max(worst) > KERNEL_TOL:
        raise SystemExit("mamba serve: a prefill chunk's ssd_scan "
                         "disagrees with the plain version")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    k32, toks32 = one(cfg32, "auto")
    p32, _ = one(cfg32, "torch", toks32)
    worst32 = compare_logits("mamba serve fp32", k32, p32)
    log(f"mamba serve: ok (prompt {len(prompt)} tokens, prefill + "
        f"{DECODE_COMPARED} decode steps; fp32 compute worst rel "
        f"{worst32:.4e})")
    profile_windows(args, cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training: kernels #7-#10, the 2-layer parity, the full-depth run
# ---------------------------------------------------------------------------

#: the training kernels' main-path shapes: starcoder2-7b, B=2, seq 2048
TRAIN_B, TRAIN_SEQ, TRAIN_LR = 2, 2048, 3e-4
#: the training kernels of the model's layers
TRAIN_KERNELS = ("fused_attention_fwd", "fused_attention_bwd_dq",
                 "fused_attention_bwd_dkv")


#: the bf16 times of #1, #2, #3, #5, #6 and #7-#10 at their table shapes
#: on the fp32-FMA bodies that preceded their tensor-core bodies, as
#: PERF.md records them (this script's kernel phase, H100 80GB HBM3,
#: 700.00 W): logged beside this run's times, and kept out of the
#: kernels' record, which holds only what this run measured
RECORDED_FMA_MS = {"fused_attention_masked": 0.1408,
                   "fused_qproj_attention_masked": 1.2039,
                   "fused_decode_block": 0.3413,
                   "fused_decode_block_paged": 0.3573,
                   "fused_qproj_attention_paged": 1.0101,
                   "fused_attention_fwd": 10.0170,
                   "fused_attention_bwd_dq": 11.2974,
                   "fused_attention_bwd_dkv": 13.3167,
                   "fused_qproj_attention_fwd": 20.8773}


def tensor_core_usage() -> dict:
    """Logs one line with the HMMA (tensor-core) instructions in the
    SASS of each instantiation of the bf16 tensor-core bodies (#1-#11,
    and #1's wide body with its registers and spill; fails if cuobjdump
    is missing or one has none);
    returns {kernel: (symbol, registers, spill bytes)} of its main-width
    instantiation (D = 128; #11's 64-column P slice), from its ptxas
    report."""
    from repro_torch.kernels import build
    parts, usage = [], {}
    for name, symbols in build.TENSOR_CORE_BODIES.items():
        counts = {s: build.sass_hmma(name, s) for s in symbols}
        if not all(counts.values()):
            raise SystemExit(f"{name}: an instantiation without HMMA in its "
                             f"SASS: {counts}")
        parts.append(f"{name} " + ", ".join(f"{s} {n} HMMA"
                                            for s, n in counts.items()))
        usage[name] = (symbols[0], *build.ptxas_usage(
            build.ptxas_report(name), symbols[0]))
    for name, (symbol, _) in build.WIDE_BODIES.items():
        n = build.sass_hmma(name, symbol)
        regs, spill = build.ptxas_usage(build.ptxas_report(name), symbol)
        if not n:
            raise SystemExit(f"{name}: no HMMA in {symbol}'s SASS")
        parts.append(f"{name} wide body {symbol} {n} HMMA ({regs} "
                     f"registers, {spill} B spill)")
    log("sass: " + "; ".join(parts) + " (cuobjdump -sass)")
    return usage


def _train_launches(cfg) -> dict:
    """The training kernels' launches in one forward and backward with
    remat "full": each attention layer's forward runs twice (the forward
    and the recompute), its backward once; a Mamba-2 layer launches
    none."""
    n = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))
    return {"fused_attention_fwd": 2 * n, "fused_attention_bwd_dq": n,
            "fused_attention_bwd_dkv": n}


#: The second gate of the training kernels (and of #1, #2 and #10) at
#: their main shapes.  KERNEL_TOL of
#: the largest |want| (about 3.5 for o) is as large as a typical late
#: row's values (|o| about 0.03 at seq 2048), so a body that dropped a
#: key tile for those rows would pass it.  So each row of o, dq, dk and
#: dv (a query row; a key row) is held to ROW_TOL of that row's own
#: largest |want|, and lse to LSE_TOL absolute.  Measured on an H100
#: 80GB HBM3: the worst rows at 7.4e-3 to 7.8e-3 (one bf16 ulp of a
#: value at the bottom of its binade is 2^-7 = 7.8e-3 of it), lse within
#: 9.5e-7; the plain results with a tile dropped (dropped_tile) at 0.61
#: (o), 1.11 (dk), 0.92 (dv) and 0.049 (lse).
ROW_TOL = 2e-2
LSE_TOL = 1e-3
#: #10's lse against the TPU kernel's arithmetic in plain PyTorch (Q
#: projected and rotated in fp32, rounded to bf16 once).  #10 builds Q
#: in-kernel, summing E = 4608 products in another order than the
#: reference, so a Q element near a bf16 rounding boundary may round to
#: the neighbouring value on one side: one bf16 ulp, which moves the
#: scores of a row that sees few keys by up to ulp(q) |k| / sqrt(D).
#: Measured on an H100 80GB HBM3: 1.005e-3 at the main shape, where #7,
#: given the same Q, stays within 1.9e-6; the reference with a key tile
#: dropped, 4.9e-2.  So LSE_TOL holds #7, whose Q is an input, and #10
#: takes twice its measured floor.
QPROJ_LSE_TOL = 2e-3
#: dq's causal row 0, whose exact value is 0, against the largest |dq|:
#: bf16's unit roundoff 2^-8 = 3.9e-3 of it would be one rounding of the
#: largest value; rounding noise of an exact zero is orders below that
ZERO_ROW_TOL = 1e-4


def row_err(got, want) -> float:
    """The largest, over the rows (the last dimension), of a row's max
    |got - want| over its max |want| (over 1 where want's row is 0)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return ((got - want).abs().amax(-1) / scale).max().item()


def row_gate(name, tag, outs, lse=None, expect=True,
             lse_tol=LSE_TOL) -> dict:
    """Every (got, want) of ``outs`` within ROW_TOL per row and ``lse``'s
    (got, want) within ``lse_tol`` absolute.  ``expect=False`` turns the
    gate on itself: given a plain version with a tile dropped it must
    fail, else it could pass a kernel with that bug."""
    errs = {k: row_err(got, want) for k, (got, want) in outs.items()}
    ok = all(e <= ROW_TOL for e in errs.values())
    # beside it, each one's error over its largest |want|: check_kernel's
    whole = {k: rel_err(got, want)[1] for k, (got, want) in outs.items()}
    if lse is not None:
        errs["lse_abs"] = (lse[0] - lse[1]).abs().max().item()
        whole["lse"] = rel_err(*lse)[1]
        ok = ok and errs["lse_abs"] <= lse_tol
    text = " ".join(f"{k}={e:.3e}" for k, e in errs.items())
    text += "; over the largest |want| " + " ".join(
        f"{k}={e:.3e}" for k, e in whole.items())
    verdict = ("ok" if ok else "FAIL") if expect else \
        ("FAIL: passed" if ok else "rejected, as it must be")
    log(f"  {name} [{tag}] per row {text} (row tol {ROW_TOL}, lse tol "
        f"{lse_tol}) {verdict}")
    if ok != expect:
        raise SystemExit(f"{name}: per-row gate {verdict} ({tag})")
    return errs


def dropped_tile(q, k, v, do, o_p, lse_p, delta, want_q, want_k, want_v,
                 causal=True):
    """Plain results with one tile of work left out, to try the row gate
    on: #7's and #8's last row tile without its last key tile (the walk
    one tile short for the heaviest rows), and #9's walk one step short
    (the last head of each group loses its last query tile from every
    key tile's sum).  Returns (o, lse, dq, dk, dv)."""
    from repro_torch.kernels.fused_attention import (
        fused_attention_bwd_dkv_plain, fused_attention_bwd_dq_plain,
        fused_attention_fwd_plain)
    t, sq = 64, q.shape[2]
    kw = dict(causal=causal, q_offset=sq - t if causal else None)
    o_m, lse_m, dq_m = o_p.clone(), lse_p.clone(), want_q.clone()
    o_t, lse_t = fused_attention_fwd_plain(
        q[:, :, -t:], k[:, :, :-t], v[:, :, :-t], **kw)
    o_m[:, :, -t:], lse_m[:, :, -t:] = o_t, lse_t
    dq_m[:, :, -t:] = fused_attention_bwd_dq_plain(
        q[:, :, -t:], k[:, :, :-t], v[:, :, :-t], do[:, :, -t:],
        lse_p[:, :, -t:], delta[:, :, -t:], **kw)
    group = q.shape[1] // k.shape[1]
    heads = [h * group + group - 1 for h in range(k.shape[1])]
    part = lambda x: x[:, heads, -t:].float()
    ck, cv = fused_attention_bwd_dkv_plain(
        part(q), k.float(), v.float(), part(do), lse_p[:, heads, -t:],
        delta[:, heads, -t:], **kw)
    return (o_m, lse_m, dq_m, (want_k.float() - ck).to(want_k.dtype),
            (want_v.float() - cv).to(want_v.dtype))


#: the aten operator each SDPA backend runs under
SDPA_OPS = {"aten::_scaled_dot_product_flash_attention": "flash",
            "aten::_scaled_dot_product_efficient_attention":
                "efficient (memory-efficient, CUTLASS)",
            "aten::_scaled_dot_product_cudnn_attention": "cuDNN",
            "aten::_scaled_dot_product_attention_math": "math"}


def sdpa_backend(call) -> str:
    """The backend PyTorch's SDPA dispatcher took for ``call()``, from the
    aten operator a host-side profile of one call shows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    seen = {e.key for e in prof.key_averages()}
    return next((b for op, b in SDPA_OPS.items() if op in seen), "unknown")


def attention_train_records(q, k, v, do, causal, tag) -> dict:
    """#7, #8 and #9 on q, do (B, Hq, S, D) and k, v (B, Hkv, S, D),
    causal or not: each against its plain version, held per row, the
    row gate shown to reject a plain result with a tile dropped, bitwise
    repeatable; timed on CUDA events, with its bound and its library
    yardstick (SDPA's forward for #7; SDPA's backward, forward + backward
    less the forward, for #8 and #9 together: SDPA splits the backward
    its own way, so that one number stands in both rows).  Returns
    {kernel: record}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_attention import (
        fused_attention_bwd_dkv, fused_attention_bwd_dkv_plain,
        fused_attention_bwd_dq, fused_attention_bwd_dq_plain,
        fused_attention_fwd, fused_attention_fwd_plain)

    kw = dict(causal=causal)
    b, hq, sq, d = q.shape
    d_v = v.shape[-1]
    gqa = dict(enable_gqa=True) if hq != k.shape[1] else {}
    sdpa = lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, is_causal=causal, **gqa)
    what = "causal" if causal else "non-causal"
    backend = sdpa_backend(lambda: sdpa(q, k, v))
    what += f", the {backend} backend"
    if d_v != d:
        log(f"  SDPA at D {d} != Dv {d_v} [{tag}]: the dispatcher takes the "
            f"{backend} backend (flash requires D = Dv)")

    o, lse = fused_attention_fwd(q, k, v, **kw)
    o_p, lse_p = fused_attention_fwd_plain(q, k, v, **kw)
    err7 = max(check_kernel("fused_attention_fwd", o, o_p, f"{tag} o"),
               check_kernel("fused_attention_fwd", lse, lse_p, f"{tag} lse"))
    row_gate("fused_attention_fwd", tag, {"o": (o, o_p)}, (lse, lse_p))
    again = fused_attention_fwd(q, k, v, **kw)
    if not (torch.equal(again[0], o) and torch.equal(again[1], lse)):
        raise SystemExit("fused_attention_fwd is not deterministic")
    del o, lse, again

    delta = ref.attention_delta(o_p, do)
    args = (q, k, v, do, lse_p, delta)
    dq = fused_attention_bwd_dq(*args, **kw)
    want_q = fused_attention_bwd_dq_plain(*args, **kw)
    err8 = check_kernel("fused_attention_bwd_dq", dq, want_q, f"{tag} dq")
    # Causal row 0 sees one key: p = 1 and dp = delta, so its dq is 0 in
    # exact arithmetic and both sides hold rounding noise, which its own
    # largest |want| cannot scale.  The per-row gate then takes rows 1..,
    # and row 0 must stay noise: within ZERO_ROW_TOL of the largest |want|.
    first = 1 if causal else 0
    rows = f"{tag} rows 1.." if causal else tag
    row_gate("fused_attention_bwd_dq", rows,
             {"dq": (dq[:, :, first:], want_q[:, :, first:])})
    if causal:
        top = want_q.float().abs().max().item()
        row0, row0_p = (x[:, :, 0].float().abs().max().item() / top
                        for x in (dq, want_q))
        log(f"  fused_attention_bwd_dq [{tag}] row 0 (dq = 0 exactly): "
            f"largest |dq| {row0:.3e} of the largest |want|, plain "
            f"{row0_p:.3e} (tol {ZERO_ROW_TOL})")
        if row0 > ZERO_ROW_TOL:
            raise SystemExit("fused_attention_bwd_dq: row 0 is not zero")
    if not torch.equal(fused_attention_bwd_dq(*args, **kw), dq):
        raise SystemExit("fused_attention_bwd_dq is not deterministic")
    dk, dv = fused_attention_bwd_dkv(*args, **kw)
    want_k, want_v = fused_attention_bwd_dkv_plain(*args, **kw)
    err9 = max(check_kernel("fused_attention_bwd_dkv", dk, want_k,
                            f"{tag} dk"),
               check_kernel("fused_attention_bwd_dkv", dv, want_v,
                            f"{tag} dv"))
    row_gate("fused_attention_bwd_dkv", tag,
             {"dk": (dk, want_k), "dv": (dv, want_v)})
    again = fused_attention_bwd_dkv(*args, **kw)
    if not (torch.equal(again[0], dk) and torch.equal(again[1], dv)):
        raise SystemExit("fused_attention_bwd_dkv is not deterministic")
    log(f"  #7, #8, #9 [{tag}] bitwise repeatable")
    del dq, dk, dv, again
    o_m, lse_m, dq_m, dk_m, dv_m = dropped_tile(
        q, k, v, do, o_p, lse_p, delta, want_q, want_k, want_v, causal)
    row_gate("fused_attention_fwd", f"{tag}, plain with a key tile dropped",
             {"o": (o_m, o_p)}, (lse_m, lse_p), expect=False)
    row_gate("fused_attention_bwd_dq",
             f"{rows}, plain with a key tile dropped",
             {"dq": (dq_m[:, :, first:], want_q[:, :, first:])},
             expect=False)
    row_gate("fused_attention_bwd_dkv",
             f"{tag}, plain with a query tile dropped",
             {"dk": (dk_m, want_k), "dv": (dv_m, want_v)}, expect=False)
    del o_m, lse_m, dq_m, dk_m, dv_m, want_q, want_k, want_v, o_p

    results = {}
    f7 = lambda: fused_attention_fwd(q, k, v, **kw)
    # products: S = Q.K^T (2 D a score entry), O = P.V (2 Dv); #8 adds
    # dP = dO.V^T and dQ = dS.K, #9 computes S, dP, dV = P^T.dO, dK
    shapes = (b, hq, k.shape[1], sq, k.shape[2], d, d_v)
    bms, by = bound("fused_attention_fwd", *shapes, causal=causal,
                    el=q.element_size())
    results["fused_attention_fwd"] = dict(
        max_abs_err=err7, ms=time_ms(f7, 10),
        plain_ms=time_ms(lambda: fused_attention_fwd_plain(q, k, v, **kw),
                         2, 1),
        bound_ms=bms, bound_by=by,
        library_ms=lib_ms(f"SDPA forward, {what}, for fused_attention_fwd "
                          f"[{tag}]", lambda: time_ms(lambda: sdpa(q, k, v),
                                                      10)),
        library_backend=backend)
    if backend == "math" and d > d_v:
        # the math backend materialises S: flash at V zero-padded to D
        # is the faster yardstick there
        vp = torch.nn.functional.pad(v, (0, d - d_v))
        lib_ms(f"SDPA forward, flash with V zero-padded to {d} [{tag}]",
               lambda: time_ms(lambda: sdpa(q, k, vp), 10))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    fwd_g = lambda: sdpa(qg, kg, vg)
    both = lambda: torch.autograd.grad(fwd_g(), (qg, kg, vg), do)
    lib_bwd = lib_ms(f"SDPA backward, {what} (forward + backward less "
                     f"forward: dq, dk and dv together) for "
                     f"fused_attention_bwd_dq and _dkv [{tag}]",
                     lambda: time_ms(both, 5) - time_ms(fwd_g, 5))
    bms, by = bound("fused_attention_bwd_dq", *shapes, causal=causal,
                    el=q.element_size())
    results["fused_attention_bwd_dq"] = dict(
        max_abs_err=err8,
        ms=time_ms(lambda: fused_attention_bwd_dq(*args, **kw), 5),
        plain_ms=time_ms(lambda: fused_attention_bwd_dq_plain(*args, **kw),
                         2, 1),
        bound_ms=bms, bound_by=by, library_ms=lib_bwd)
    bms, by = bound("fused_attention_bwd_dkv", *shapes, causal=causal,
                    el=q.element_size())
    results["fused_attention_bwd_dkv"] = dict(
        max_abs_err=err9,
        ms=time_ms(lambda: fused_attention_bwd_dkv(*args, **kw), 5),
        plain_ms=time_ms(lambda: fused_attention_bwd_dkv_plain(*args, **kw),
                         2, 1),
        bound_ms=bms, bound_by=by, library_ms=lib_bwd)
    return results


def train_kernel_phase(dev, g, check):
    """#7, #8, #9 at starcoder2-7b's training shapes (bf16, causal, B=2,
    Sq = Skv = 2048) as attention_train_records holds them, and #10's
    forward on x (2, 2048, 4608) against its plain version, timed on
    CUDA events, with its bound and the unfused path's time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_attention import fused_attention_fwd_plain
    from repro_torch.kernels.fused_qproj_attention import (
        fused_qproj_attention_fwd, fused_qproj_attention_fwd_plain)

    bf = torch.bfloat16
    E, HQ, HKV, D = (STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    b, sq, theta = TRAIN_B, TRAIN_SEQ, 1e5

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(bf)

    q, k, v, do = rnd(b, HQ, sq, D), rnd(b, HKV, sq, D), rnd(b, HKV, sq, D), \
        rnd(b, HQ, sq, D)
    sources = {"fused_attention_fwd": ("fused_attention.cu", 155),
               "fused_attention_bwd_dq": ("fused_attention_bwd.cu", 537),
               "fused_attention_bwd_dkv": ("fused_attention_bwd.cu", 564)}
    results = {
        name: dict(source=f"src/repro_torch/kernels/csrc/{sources[name][0]}",
                   replaces=f"src/repro/kernels/fused_attention.py:"
                            f"{sources[name][1]}", **r)
        for name, r in attention_train_records(
            q, k, v, do, True, f"B={b} S={sq}").items()}

    x, wq = rnd(b, sq, E), rnd(E, HQ, D, scale=E ** -0.5)
    f10 = lambda: fused_qproj_attention_fwd(x, wq, k, v, rope_theta=theta)
    p10 = lambda: fused_qproj_attention_fwd_plain(x, wq, k, v,
                                                  rope_theta=theta)
    (o, lse), (o_p, lse_p) = f10(), p10()
    err = max(check("fused_qproj_attention_fwd", o, o_p, f"B={b} S={sq} o"),
              check("fused_qproj_attention_fwd", lse, lse_p,
                    f"B={b} S={sq} lse"))
    again = f10()
    if not (torch.equal(again[0], o) and torch.equal(again[1], lse)):
        raise SystemExit("fused_qproj_attention_fwd is not deterministic")
    log(f"  fused_qproj_attention_fwd [B={b} S={sq}] bitwise repeatable")

    def at_kernel_cast(xx, kk, vv, q_offset=None):
        """The TPU kernel's arithmetic in plain PyTorch: Q projected in
        fp32, rotated in fp32 with _rope_tile's frequency schedule
        exp(i * (-ln theta / half)) and rounded to bf16 once.  The plain
        version, as the JAX package's unfused path, rounds the
        projection to bf16 before RoPE and takes RoFormer's theta^(-i /
        half): Q off by up to a bf16 ulp, lse by up to about 7e-3 at this
        shape, more than LSE_TOL."""
        qq = torch.einsum("bse,ehd->bhsd", xx.float(), wq.float())
        half = qq.shape[-1] // 2
        step = -torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=dev)) / half
        freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                      device=dev) * step)
        pos = ref.rope_positions(xx.shape[1], kk.shape[2], q_offset=q_offset,
                                 device=dev)
        ang = pos.float()[:, None] * freq
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = qq[..., :half], qq[..., half:]
        qq = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return fused_attention_fwd_plain(qq.to(bf), kk, vv, q_offset=q_offset)

    o_r, lse_r = at_kernel_cast(x, k, v)
    log(f"  fused_qproj_attention_fwd [B={b} S={sq}] lse against the plain "
        f"version (Q rounded twice): "
        f"{(lse - lse_p).abs().max().item():.3e} absolute")
    row_gate("fused_qproj_attention_fwd",
             f"B={b} S={sq}, against Q rounded once", {"o": (o, o_r)},
             (lse, lse_r), lse_tol=QPROJ_LSE_TOL)
    # that result with its last row tile's last key tile dropped
    t = 64
    o_t, lse_t = at_kernel_cast(x[:, -t:], k[:, :, :-t], v[:, :, :-t],
                                q_offset=sq - t)
    o_m, lse_m = o_r.clone(), lse_r.clone()
    o_m[:, :, -t:], lse_m[:, :, -t:] = o_t, lse_t
    row_gate("fused_qproj_attention_fwd",
             f"B={b} S={sq}, against Q rounded once with a key tile dropped",
             {"o": (o_m, o_r)}, (lse_m, lse_r), expect=False,
             lse_tol=QPROJ_LSE_TOL)
    del again, o_r, lse_r, o_t, lse_t, o_m, lse_m
    bms, by = bound("fused_qproj_attention_fwd", b, sq, E, HQ, HKV, sq, D, D,
                    el=x.element_size())
    results["fused_qproj_attention_fwd"] = dict(
        source="src/repro_torch/kernels/csrc/fused_qproj_attention.cu",
        replaces="src/repro/kernels/fused_qproj_attention.py:104",
        max_abs_err=err, ms=time_ms(f10, 5), plain_ms=time_ms(p10, 2, 1),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=unfused_ms("fused_qproj_attention_fwd", x, wq, k, v,
                              ref.rope_positions(sq, sq, device=dev), theta,
                              iters=5))
    for name, r in results.items():
        log_record(name, r)
    return results


#: bf16 tolerances of the 2-layer train parity, kernels against plain
#: versions.  Loss and grad_norm: relative 1e-2 (both are sums over the
#: whole batch of values the two runs round to bf16 at the same points
#: and sum in other orders).  Each gradient leaf: KERNEL_TOL of its
#: largest magnitude.  Parameters after two AdamW steps: 4 * lr plus 2
#: bf16 ulps of the leaf's largest magnitude, absolute: AdamW's update is
#: about lr * sign(g) per step (at most lr in magnitude for steps 1 and
#: 2), so a near-zero gradient whose sign differs between the runs moves
#: one element by up to 2 * lr per step.
PARITY_REL = 1e-2


def _grad_leaves(tree, name=""):
    """(name, tensor) of every leaf of a parameter or gradient tree,
    stacked ``layers`` leaves split per layer: the leaves the model
    differentiates.  (A plain recursion: a nested recursive closure
    would hold the tensors in a reference cycle until the garbage
    collector runs, 14.8 GB of gradients at full size.)"""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _grad_leaves(tree[k], f"{name}.{k}" if name else k)]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _grad_leaves(t, f"{name}[{i}]")]
    if name.startswith("layers"):
        return [(f"{name}[layer {j}]", tree[j]) for j in range(tree.shape[0])]
    return [(name, tree)]


def check_grads_nonzero(grads, phase):
    """Every per-layer gradient leaf is finite and not all zero."""
    bad = [n for n, t in _grad_leaves(grads)
           if not bool(torch.isfinite(t).all()) or t.abs().max().item() == 0]
    if bad:
        raise SystemExit(f"{phase}: zero or non-finite gradients: {bad[:8]}")
    return len(_grad_leaves(grads))


def train_parity_phase(dev):
    """starcoder2-7b at full width cut to 2 layers, bf16, random weights
    from seed 0: the loss and gradients of one batch, then two AdamW
    steps on SyntheticTokenDataset(seed=0) batches, on the kernels and
    with impl forced to the plain versions; loss, grad_norm, every
    gradient leaf and the parameters after the updates compared.
    Returns the kernel run's launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.kernels import build
    from repro_torch.train import step as train_step

    cfg = dataclasses.replace(configs.get_config("starcoder2-7b"), n_layers=2)
    ds = SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_B, seed=0,
                               structured=True)
    batches = [{"tokens": torch.from_numpy(ds.batch(i)).long().to(dev)}
               for i in range(2)]
    runs = {}
    for impl in ("auto", "torch"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = train_step.init_train_state(gen, cfg, moment_dtype="bfloat16",
                                            device=dev)
        before = [t.clone() for _, t in _grad_leaves(state.params)]
        build.reset_launches()
        (loss, _), grads = train_step.value_and_grad(state.params, cfg,
                                                     batches[0], impl=impl)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        metrics = []
        for bt in batches:
            state, m = train_step.train_step(state, bt, cfg, lr=TRAIN_LR,
                                             impl=impl)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[impl] = (float(loss), grads, metrics, before,
                      _grad_leaves(state.params), launches)
        del state
    (l_k, g_k, m_k, p0, p_k, launches), (l_p, g_p, m_p, _, p_p, plain_l) = \
        runs["auto"], runs["torch"]
    log(f"train parity: {cfg.name} d_model={cfg.d_model} cut to "
        f"{cfg.n_layers} layers, B={TRAIN_B} seq {TRAIN_SEQ}, bf16, "
        f"launches on the kernels {launches}, on the plain versions "
        f"{plain_l or 'none'}")
    want = _train_launches(cfg)
    if {n: launches.get(n, 0) for n in TRAIN_KERNELS} != want:
        raise SystemExit(f"train parity: expected launches {want} for one "
                         f"forward and backward, got {launches}")
    if plain_l:
        raise SystemExit(f"train parity: the plain run launched {plain_l}")
    n = check_grads_nonzero(g_k, "train parity")
    worst = ("none", -1.0)
    for (name, a), (_, b) in zip(_grad_leaves(g_k), _grad_leaves(g_p)):
        _, rel = rel_err(a, b)
        worst = max(worst, (name, rel), key=lambda w: w[1])
    log(f"  loss {l_k:.6f} vs plain {l_p:.6f}; {n} gradient leaves, worst "
        f"{worst[0]} rel {worst[1]:.4e} (tol {KERNEL_TOL})")
    if abs(l_k - l_p) > PARITY_REL * abs(l_p) or worst[1] > KERNEL_TOL:
        raise SystemExit("train parity: loss or gradients disagree")
    for i, ((lk, gk), (lp, gp)) in enumerate(zip(m_k, m_p)):
        log(f"  step {i}: loss {lk:.6f} vs {lp:.6f}, grad_norm {gk:.6f} vs "
            f"{gp:.6f} (tol rel {PARITY_REL})")
        if abs(lk - lp) > PARITY_REL * abs(lp) or \
                abs(gk - gp) > PARITY_REL * abs(gp):
            raise SystemExit(f"train parity: step {i} loss or grad_norm "
                             "disagree")
    worst_p, share = 0.0, 0.0
    for (name, a), (_, b), b0 in zip(p_k, p_p, p0):
        ulp = 2 ** -7 * 2 ** torch.floor(torch.log2(b.float().abs().max()))
        diff = (a.float() - b.float()).abs()
        tol = 4 * TRAIN_LR + 2 * float(ulp)
        worst_p = max(worst_p, diff.max().item() / tol)
        share = max(share, (diff > TRAIN_LR / 2).float().mean().item())
        # a weight matrix must move; a norm weight at 1.0 may not (lr
        # 3e-4 is below half a bf16 ulp of 1.0, 2^-8)
        if not torch.isfinite(a.float()).all() or \
                ("norm" not in name.rsplit(".", 1)[-1]
                 and torch.equal(a, b0)):
            raise SystemExit(f"train parity: {name} did not update")
    log(f"  parameters after 2 steps: worst |kernel - plain| at "
        f"{worst_p:.3f} of its tolerance (4 lr + 2 ulp); largest share of "
        f"a leaf's elements differing by more than lr/2: {share:.4e}")
    if worst_p > 1.0:
        raise SystemExit("train parity: parameters disagree after the "
                         "updates")
    log("train parity: ok")
    del runs, g_k, g_p, p_k, p_p, p0
    torch.cuda.empty_cache()
    return launches


def qproj_train_phase(dev, g):
    """The JAX package's cache-free ``ops.qproj_attention`` entry point on
    the card, forward and backward at starcoder2-7b's training shapes:
    #10, then #8/#9 on the recomputed Q; the gradients of x, wq, k and v
    against impl forced to the plain versions.  Returns the kernel run's
    launches."""
    from repro_torch.kernels import build, ops

    E, HQ, HKV, D = (STARCODER[k] for k in ("E", "HQ", "HKV", "D"))
    b, sq = TRAIN_B, TRAIN_SEQ
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                                * scale).to(torch.bfloat16)
    inputs = (mk(b, sq, E), mk(E, HQ, D, scale=E ** -0.5), mk(b, HKV, sq, D),
              mk(b, HKV, sq, D))
    do = mk(b, HQ, sq, D)
    grads = []
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_() for t in inputs]
        ops.reset_counts()
        out = ops.qproj_attention(*leaves, rope_theta=1e5, impl=impl)
        out.backward(do)
        torch.cuda.synchronize()
        if impl == "auto":
            launches = dict(build.LAUNCHES)
        grads.append([t.grad for t in leaves])
    log(f"qproj train: ops.qproj_attention without lengths, B={b} S={sq} "
        f"E={E}, forward + backward: launches {launches}")
    if [launches.get(n, 0) for n in ("fused_qproj_attention_fwd",
                                     "fused_attention_bwd_dq",
                                     "fused_attention_bwd_dkv")] != [1, 1, 1]:
        raise SystemExit(f"qproj train: expected #10, #8, #9 once, got "
                         f"{launches}")
    for name, a, w in zip(("dx", "dwq", "dk", "dv"), *grads):
        err, rel = rel_err(a, w)
        log(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} tol={KERNEL_TOL}")
        if not torch.isfinite(a.float()).all() or rel > KERNEL_TOL \
                or a.abs().max().item() == 0:
            raise SystemExit(f"qproj train: {name} disagrees with the plain "
                             "versions")
    return launches


@contextlib.contextmanager
def checked_grads(phase, counts, unused=(), after=None):
    """``train.step.value_and_grad`` patched for the block: each call's
    gradient leaves (all but the top-level keys ``unused``) checked finite
    and non-zero, their number appended to ``counts``; then
    ``after(grads)`` where given."""
    from repro_torch.train import step as train_step

    value_and_grad = train_step.value_and_grad

    def checked(*a, **kw):
        out = value_and_grad(*a, **kw)
        counts.append(check_grads_nonzero(
            {k: v for k, v in out[1].items() if k not in unused}, phase))
        if after is not None:
            after(out[1])
        return out

    train_step.value_and_grad = checked
    try:
        yield
    finally:
        train_step.value_and_grad = value_and_grad


def profiled_step(step_fn, state, batch, title, top):
    """One more training step under torch.profiler, AdamW in a range of
    its own; logs its device time by kernel and idle share.  Returns
    (state, loss, the profile, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import step as train_step

    adamw = train_step.adamw_update

    def ranged(*a, **kw):
        with torch.profiler.record_function("adamw_update"):
            return adamw(*a, **kw)

    torch.cuda.synchronize()
    train_step.adamw_update = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        train_step.adamw_update = adamw
    return state, loss, prof, device_report(prof, wall, title, top=top)


def train_phase(dev):
    """``launch/train.train_loop`` at full width and depth: starcoder2-7b,
    32 layers, remat full, bf16 AdamW moments, B=2, seq 2048, lr 3e-4, 3
    steps on structured synthetic data, no checkpoint.  Each step's loss,
    grad_norm, time and training-kernel launches; every per-layer
    gradient leaf must be finite and non-zero; then one more step under
    torch.profiler.  Returns the launches of the 3 steps."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.train import step as train_step

    cfg = configs.get_config("starcoder2-7b")
    # the serve phases' engines hold their weights (14.3 GB) through
    # reference cycles (the paged phase's wrapped methods): collect them
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory allocated before the run: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats()
    per_step, total = [], collections.Counter()
    grad_leaves, peaks = [], collections.defaultdict(float)

    def on_grads(grads):
        # the peak of init (first step) or the forward and backward
        peaks["forward + backward"] = max(peaks["forward + backward"],
                                          torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def on_step(step, metrics, secs):
        peaks["optimizer"] = max(peaks["optimizer"],
                                 torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        per_step.append((step, float(metrics["loss"]),
                         float(metrics["grad_norm"]), secs,
                         {n: build.LAUNCHES[n] for n in TRAIN_KERNELS}))
        total.update(build.LAUNCHES)
        build.reset_launches()

    log(f"train: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}, remat {cfg.remat}, bf16 "
        f"params and moments, B={TRAIN_B} seq {TRAIN_SEQ} lr {TRAIN_LR}, "
        f"3 steps")
    build.reset_launches()
    t0 = time.perf_counter()
    with checked_grads("train", grad_leaves, after=on_grads):
        state, losses = train.train_loop(
            cfg, steps=3, batch=TRAIN_B, seq=TRAIN_SEQ, lr=TRAIN_LR,
            moment_dtype="bfloat16", device=dev, on_step=on_step,
            log_every=1)
    wall = time.perf_counter() - t0
    peak = max(peaks.values())
    pbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(state.params))
    for step, loss, gn, secs, launches in per_step:
        log(f"  step {step}: loss {loss:.6f} grad_norm {gn:.6f} "
            f"{secs * 1e3:.1f} ms, launches {launches}")
    med = statistics.median(p[3] for p in per_step[1:])
    tok = TRAIN_B * TRAIN_SEQ
    log(f"  step time: median of steps 2-3 {med * 1e3:.1f} ms; "
        f"{tok / med:.1f} training tokens/s; wall {wall:.1f}s incl. init")
    log(f"  peak memory {peak / 1e9:.3f} GB (max_memory_allocated over "
        f"the 3 steps: forward + backward "
        f"{peaks['forward + backward'] / 1e9:.3f} GB, optimizer "
        f"{peaks['optimizer'] / 1e9:.3f} GB); parameters "
        f"{pbytes / 1e9:.3f} GB; gradient leaves checked non-zero per "
        f"step: {grad_leaves}")
    want = _train_launches(cfg)
    if len(per_step) != 3 or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"train: losses {losses}")
    if any(p[4] != want for p in per_step):
        raise SystemExit(f"train: launches per step {[p[4] for p in per_step]}"
                         f", predicted {want}")

    # one more step under the profiler: where a step's time goes
    from repro_torch.data import SyntheticTokenDataset
    ds = SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_B, seed=0,
                               structured=True)
    batch = {"tokens": torch.from_numpy(ds.batch(3)).long().to(dev)}
    state, loss, prof, busy = profiled_step(
        train_step.make_train_step(cfg, lr=TRAIN_LR), state, batch,
        "profiled training step", 14)
    n_params = sum(t.numel() for t in _leaves(state.params))
    train_breakdown(prof, busy, cfg, n_params)
    log(f"  profiled step: loss {loss:.6f}")
    del state, prof
    torch.cuda.empty_cache()
    return total


def train_gemm_flops(cfg, batch=TRAIN_B) -> float:
    """The GEMM operations of one training step from the shapes: the
    forward (every layer's projections and MLP, and the LM head), the
    remat recompute (each layer again, less its last GEMM, w_down,
    whose output no saved tensor needs, so the recompute stops before
    it) and the backward (two products per forward GEMM).  A MoE layer
    computes its experts on the capacity buffer, E x C rows a batch row
    (its own routing group), beside the router's product; the combine
    saves w_down's output, so its recompute runs every product.  A
    Mamba-2 layer (a pure Mamba-2 stack's, without FFN) has in_proj and
    out_proj, and the plain scan's four batched products a chunk (C B^T
    and the scores' product with x over C x C, C.h and the state update
    over P x S), which cuBLAS runs too; out_proj is its last."""
    from repro_torch.models import mamba, moe
    if cfg.attn_every == 0:
        d_in, h, _, g, s = mamba.dims(cfg)
        e = cfg.d_model
        layer = e * (2 * d_in + 2 * g * s + h) + d_in * e + scan_macs(cfg)
        tok = 2 * batch * TRAIN_SEQ
        fwd = tok * (cfg.n_layers * layer + e * cfg.vocab_size)
        return fwd + tok * cfg.n_layers * (layer - d_in * e) + 2 * fwd
    e, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    n_mlp = 3 if cfg.mlp == "silu_glu" else 2
    attn = e * cfg.n_heads * hd * 2 + e * cfg.kv_heads * hd * 2
    if cfg.attention == "mla":          # its six projections' MACs
        h, rq, rkv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope_d, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.v_head_dim)
        attn = (e * rq + rq * h * (nope + rope_d) + e * (rkv + rope_d)
                + rkv * h * nope + rkv * h * dv + h * dv * e)
    if cfg.moe:
        rows = cfg.n_experts * moe.capacity(cfg, TRAIN_SEQ) / TRAIN_SEQ
        layer = attn + rows * n_mlp * e * cfg.d_expert + e * cfg.n_experts
        last = 0
    else:
        layer, last = attn + n_mlp * e * f, f * e
    tok = 2 * batch * TRAIN_SEQ                 # 2 FLOP per MAC per token
    fwd = tok * (cfg.n_layers * layer + e * cfg.vocab_size)
    recompute = tok * cfg.n_layers * (layer - last)
    return fwd + recompute + 2 * fwd


def scan_macs(cfg) -> int:
    """The plain SSD scan's multiply-adds a token and Mamba-2 layer: per
    head, C B^T and the scores' product with x (C x S and C x P a row of
    a chunk of C), C.h and the state update (P x S each)."""
    from repro_torch.models import mamba
    _, h, p, _, s = mamba.dims(cfg)
    c = cfg.ssd_chunk
    return h * (c * s + c * p + 2 * s * p)


def train_breakdown(prof, busy_ms: float, cfg, n_params: int,
                    batch=TRAIN_B) -> None:
    """A profiled training step's device time by part: the three
    training kernels (by their CUDA kernel names), the GEMMs (cuBLAS
    kernel names), the optimizer (device time under the adamw_update
    range) and the rest; with the GEMMs' rate and the optimizer's bytes
    floor (AdamW must read p, g, mu, nu and write p, mu, nu: 14 bytes
    per bf16 parameter with bf16 moments)."""
    from torch.autograd import DeviceType
    parts = collections.Counter()
    names = {"fwd_mma_kernel": "#7 fused_attention_fwd",
             "dq_mma_kernel": "#8 fused_attention_bwd_dq",
             "dkv_mma_kernel": "#9 fused_attention_bwd_dkv"}
    opt = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            if e.key == "adamw_update":   # its span on the device
                opt += e.self_device_time_total / 1e3
            continue
        part = next((v for k, v in names.items() if k in e.key), None)
        if part is None and any(w in e.key.lower() for w in
                                ("gemm", "xmma", "cutlass", "nvjet")):
            part = "GEMMs (cuBLAS)"
        parts[part or "other"] += e.self_device_time_total / 1e3
    log(f"  training step by part (device ms, share of {busy_ms:.1f} ms "
        f"busy):")
    for part, ms in parts.most_common():
        log(f"    {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% {part}")
    log(f"    {opt:10.3f} ms {100 * opt / busy_ms:6.2f}% the adamw_update "
        f"range on the device (the optimizer; its kernels are in 'other')")
    flops = train_gemm_flops(cfg, batch)
    gemm = parts["GEMMs (cuBLAS)"]
    rate = flops / (gemm / 1e3)                 # FLOP/s
    log(f"  GEMMs: {flops:.4e} FLOP counted from the shapes in "
        f"{gemm:.3f} ms = {rate / 1e12:.1f} TFLOP/s "
        f"({100 * rate / PEAK_BF16:.1f}% of the bf16 peak)")
    opt_bytes = 14 * n_params
    log(f"  optimizer: {n_params} parameters x 14 bytes = "
        f"{opt_bytes / 1e9:.3f} GB, floor {opt_bytes / PEAK_BYTES * 1e3:.3f} "
        f"ms at 3.35 TB/s; measured {opt:.3f} ms")


# ---------------------------------------------------------------------------
# frontends: hubert-xlarge and internvl2-2b at full width and depth
# ---------------------------------------------------------------------------

#: hubert-xlarge's train_4k sequence (4096 frames) with the batch cut from
#: 256 to 2: the encoder forward and the training steps under each remat
HUBERT_B, HUBERT_S, HUBERT_STEPS = 2, 4096, 3
REMATS = ("none", "full", "dots")
#: phi3.5-moe's training attention: B=2, 32 query heads over 8 KV heads
#: of 128, S = 2048, causal (the MoE phase's train_loop shape)
MOE_ATTN = (2, 32, 8, 2048, 128)


def moe_kernel_phase(dev, g) -> dict:
    """#7, #8 and #9 at phi3.5-moe's training shape (MOE_ATTN), held as
    at their main shapes by attention_train_records.  Returns {kernel:
    {"phi35moe": record}}."""
    bf = torch.bfloat16
    b, hq, hkv, s, d = MOE_ATTN
    tag = f"phi35moe B={b} H={hq}/{hkv} S={s} D={d} causal"
    q, do = (torch.randn(b, hq, s, d, generator=g, device=dev).to(bf)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g, device=dev).to(bf)
            for _ in range(2))
    out = {}
    for name, r in attention_train_records(q, k, v, do, True, tag).items():
        out[name] = {"phi35moe": dict(shape=tag, **r)}
        log_record(name, r, tag)
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


#: internvl2-2b's serve: B=4 rows of 256 patch rows and 300 text tokens
#: (556 prompt rows), max_len 1024, 16 greedy decode steps
VLM_B, VLM_TEXT, VLM_MAX_LEN, VLM_NEW = 4, 300, 1024, 16
#: its training batch: the train_4k layout at seq 2048 (256 patch rows,
#: 1793 tokens: 1792 text rows and their targets), B=4
VLM_TRAIN_TEXT = 2048 - 256 + 1


def frontend_kernel_phase(dev, g) -> dict:
    """The kernels at the frontends' shapes, held as at their main
    shapes: #7, #8 and #9 at hubert-xlarge's training shape (B=2, 16 of
    16 heads of 80, S = 4096, non-causal: the ``_any`` instantiations);
    #1 at internvl2-2b's prefill (B=4, 556 rows into a 1024-row cache,
    16 query heads over 8 of 128, causal) and #3 at its decode (B=4,
    M=1, contexts 557-560, E = 2048).  Returns {kernel: {"hubert" or
    "internvl": record}}."""
    from repro_torch.kernels.fused_decode_block import (
        fused_decode_block, fused_decode_block_plain)

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(bf)

    out = collections.defaultdict(dict)
    b, h, s, d = HUBERT_B, 16, HUBERT_S, 80
    tag = f"hubert B={b} H=16/16 S={s} D={d} non-causal"
    for name, r in attention_train_records(
            *(rnd(b, h, s, d) for _ in range(4)), False, tag).items():
        out[name]["hubert"] = dict(shape=tag, **r)
    torch.cuda.empty_cache()

    # internvl2-2b: #1 over the 556-row prompt, #3 at its decode
    E, HQ, HKV, D, theta = 2048, 16, 8, 128, 1e6
    b, sq = VLM_B, 256 + VLM_TEXT
    tag = f"internvl B={b} Sq={sq} into {VLM_MAX_LEN} Hq={HQ}/{HKV} D={D}"
    k, v = rnd(b, HKV, VLM_MAX_LEN, D), rnd(b, HKV, VLM_MAX_LEN, D)
    lens = torch.full((b,), sq, dtype=torch.int32, device=dev)
    out["fused_attention_masked"]["internvl"] = dict(
        shape=tag, **masked_attention_record(rnd(b, HQ, sq, D), k, v, lens,
                                             tag))
    lens = torch.tensor([sq + 1 + i for i in range(b)], dtype=torch.int32,
                        device=dev)
    tag = f"internvl B={b} M=1 lengths={lens.tolist()} E={E}"
    x, res = rnd(b, 1, E), rnd(b, 1, E)
    pairs = [(rnd(E, HQ, D, scale=E ** -0.5),
              rnd(HQ, D, E, scale=(HQ * D) ** -0.5))
             for _ in range(WEIGHT_COPIES)]
    wq, wo = pairs[0]
    zero = torch.zeros_like(res)
    err = check_kernel(
        "fused_decode_block",
        fused_decode_block(x, wq, k, v, wo, zero, lens, rope_theta=theta),
        fused_decode_block_plain(x, wq, k, v, wo, zero, lens,
                                 rope_theta=theta), f"{tag} zero residual")
    out["fused_decode_block"]["internvl"] = dict(
        shape=tag, **decode_block_record(x, res, pairs, k, v, lens, theta,
                                         tag, err))
    for name, shapes in out.items():
        for r in shapes.values():
            log_record(name, r, r["shape"])
    del k, v, x, res, pairs, wq, wo
    torch.cuda.empty_cache()
    return dict(out)


def _train_steps(cfg, batches, phase, dev, unused=(), profiled=False,
                 keep_first=False):
    """``train.step.train_step`` over ``batches`` from fresh parameters
    drawn from seed 0, bf16 moments, lr TRAIN_LR: per step (loss,
    grad_norm, host ms between synchronizes, launches), the peak of
    max_memory_allocated over the steps, the gradient leaves checked
    finite and non-zero per step (all but ``unused``: hubert's token
    embedding, which its batches never read), the host seconds of
    garbage collection during the steps and, with ``keep_first``, a host
    copy of the first step's gradients (else None).  ``profiled``: then
    one more step on the first batch under torch.profiler."""
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.train import step as train_step

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = train_step.init_train_state(gen, cfg, moment_dtype="bfloat16",
                                        device=dev)
    step_fn = train_step.make_train_step(cfg, lr=TRAIN_LR)
    leaves, first = [], []

    def keep(grads):
        if keep_first and not first:
            first.append(tree.map(lambda t: t.cpu(), grads))

    rows = []
    plan_clock()                    # installs the collections' timer
    gc_s = _GC["secs"]
    with checked_grads(phase, leaves, unused, after=keep):
        for batch in batches:
            build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rows.append((loss, float(m["grad_norm"]),
                         (time.perf_counter() - t0) * 1e3,
                         dict(build.LAUNCHES)))
    peak = torch.cuda.max_memory_allocated()
    gc_s = _GC["secs"] - gc_s
    if profiled:
        state, _, _, _ = profiled_step(step_fn, state, batches[0],
                                       f"{phase}: profiled step", 5)
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return rows, peak, base, leaves, gc_s, (first[0] if first else None)


#: remat changes what the backward keeps, not what it computes: under
#: ``full`` and ``dots`` each step's loss and grad_norm within REMAT_REL
#: of ``none``'s, relative, and every per-layer leaf of the first step's
#: gradients within REMAT_REL of its largest |none|.  Measured on an H100
#: 80GB HBM3 (700 W), hubert's 48 layers at B=2, S=4096: the losses and
#: grad_norms of all three steps equal to the 6 printed digits.  The
#: recompute replays the same kernels and cuBLAS calls on the same
#: inputs, so a wrong selective recompute (a saved tensor read in place
#: of another, a stale one) moves some layer's gradients by far more.
REMAT_REL = 1e-3


def remat_gate(runs, dev) -> None:
    """Holds ``full`` and ``dots`` to ``none``: {remat: (rows of
    _train_steps, host copy of the first step's gradients)}."""
    ref_rows, ref_grads = runs["none"]
    want = _grad_leaves(ref_grads)
    for remat in ("full", "dots"):
        rows, grads = runs[remat]
        worst = ("", -1.0)
        for (name, a), (_, b) in zip(_grad_leaves(grads), want):
            a, b = a.to(dev).float(), b.to(dev).float()
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            rel = err / scale if scale > 0 else err
            worst = max(worst, (name, rel), key=lambda w: w[1])
        steps = [max(abs(x - y) / abs(y) for x, y in zip(r[:2], q[:2]))
                 for r, q in zip(rows, ref_rows)]
        log(f"  remat {remat} against none: step-0 gradients, worst leaf "
            f"{worst[0]} at {worst[1]:.3e} of its largest |none|; loss and "
            f"grad_norm per step, worst relative "
            f"{', '.join(f'{x:.3e}' for x in steps)} (tol {REMAT_REL})")
        if worst[1] > REMAT_REL or max(steps) > REMAT_REL:
            raise SystemExit(f"frontends: remat {remat} disagrees with none")
    # the forward does not change with the policy: the first loss is
    # bit-equal under all three
    firsts = {r: v[0][0][0] for r, v in runs.items()}
    log(f"  step-0 loss under none/full/dots: {firsts}")
    if len(set(firsts.values())) != 1:
        raise SystemExit("frontends: the remat policies' first losses differ")


def frontends_phase(dev):
    """hubert-xlarge (48 layers) and internvl2-2b (24 layers) at full
    width and depth, bf16, random weights from seed 0, through the port's
    entry points: hubert's encoder forward (#7, 48 launches) and three
    training steps under each remat policy, ``full`` and ``dots`` held
    to ``none`` (remat_gate); internvl2-2b served with its
    patch embeddings (prefill on the plan's path, 16 decode steps)
    against the plain versions, then one training step.  Returns the
    launches of the driven runs."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.internvl2_2b import PATCH_TOKENS
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import init_params
    from repro_torch.serve import engine

    total = collections.Counter()
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # -- hubert-xlarge: the encoder forward ------------------------------
    cfg = configs.get_config("hubert-xlarge")
    params = init_params(cfg, g, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    emb = torch.randn(HUBERT_B, HUBERT_S, cfg.frontend_dim, generator=g,
                      device=dev).to(bf)
    log(f"frontends: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads {cfg.n_heads} of {cfg.head_dim} non-causal, {n_params} "
        f"parameters; "
        f"encoder forward B={HUBERT_B} S={HUBERT_S} frames of "
        f"{cfg.frontend_dim}, bf16, no grad")
    with torch.no_grad():
        tf.forward(params, cfg, None, emb[:, :256])     # warm-up
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        logits = tf.forward(params, cfg, None, emb)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(build.LAUNCHES)
        total.update(launches)
        build.reset_launches()
        plain = tf.forward(params, cfg, None, emb, impl="torch")
        if build.LAUNCHES:
            raise SystemExit(f"frontends: impl torch launched "
                             f"{dict(build.LAUNCHES)}")
    want = (HUBERT_B, HUBERT_S, cfg.vocab_size)
    log(f"  encoder forward: {fwd_ms:.1f} ms, launches {launches}, logits "
        f"{tuple(logits.shape)}")
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise SystemExit(f"frontends: hubert logits {tuple(logits.shape)} "
                         f"or not finite")
    if launches != {"fused_attention_fwd": cfg.n_layers}:
        raise SystemExit(f"frontends: hubert forward launches {launches}")
    err, rel = rel_err(logits, plain)
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"  against the plain versions (impl torch), {cfg.n_layers} bf16 "
        f"layers: "
        f"max_abs_err={err:.4e} rel={rel:.4e} (tol {LOGIT_TOL}), argmax "
        f"agreement {agree:.4f}")
    if rel > LOGIT_TOL:
        raise SystemExit("frontends: hubert logits disagree with the plain "
                         "versions")
    del logits, plain, params, emb
    torch.cuda.empty_cache()

    # -- hubert-xlarge: training under none, full and dots ---------------
    tok = HUBERT_B * HUBERT_S
    batches = []
    for _ in range(HUBERT_STEPS):
        batches.append({
            "embeds": torch.randn(HUBERT_B, HUBERT_S, cfg.frontend_dim,
                                  generator=g, device=dev).to(bf),
            "targets": torch.randint(0, cfg.vocab_size,
                                     (HUBERT_B, HUBERT_S), generator=g,
                                     device=dev)})
    runs = {}
    for remat in REMATS:
        rc = dataclasses.replace(cfg, remat=remat)
        rows, peak, base, leaves, gc_s, first = _train_steps(
            rc, batches, f"hubert {remat}", dev, unused=("embed",),
            profiled=True, keep_first=True)
        log(f"  train remat={remat}: B={HUBERT_B} S={HUBERT_S} (train_4k's "
            f"sequence, batch cut from 256), bf16 params and moments, "
            f"{HUBERT_STEPS} steps")
        for i, (loss, gn, ms, ln) in enumerate(rows):
            log(f"    step {i}: loss {loss:.6f} grad_norm {gn:.6f} "
                f"{ms:.1f} ms, launches {ln}")
        med = statistics.median(r[2] for r in rows[1:])
        log(f"    step time: median of steps 2-3 {med:.1f} ms; "
            f"{tok / med * 1e3:.1f} training tokens/s; peak memory "
            f"{peak / 1e9:.3f} GB (max_memory_allocated, {base / 1e9:.3f} "
            f"GB allocated before); gradient leaves checked per step "
            f"{leaves}; garbage collection {gc_s * 1e3:.1f} ms of host "
            f"time over the {HUBERT_STEPS} steps")
        fwd = cfg.n_layers * (1 if remat == "none" else 2)
        want = {"fused_attention_fwd": fwd,
                "fused_attention_bwd_dq": cfg.n_layers,
                "fused_attention_bwd_dkv": cfg.n_layers}
        if any(r[3] != want for r in rows):
            raise SystemExit(f"frontends: hubert {remat} launches "
                             f"{[r[3] for r in rows]}, predicted {want}")
        if not all(math.isfinite(r[0]) for r in rows):
            raise SystemExit(f"frontends: hubert {remat} losses {rows}")
        for r in rows:
            total.update(r[3])
        runs[remat] = (rows, first)
    remat_gate(runs, dev)
    del runs, batches

    # -- internvl2-2b: served with its patch embeddings ------------------
    cfg = configs.get_config("internvl2-2b")
    params = init_params(cfg, g, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    emb = torch.randn(VLM_B, PATCH_TOKENS, cfg.frontend_dim, generator=g,
                      device=dev).to(bf)
    toks = torch.randint(0, cfg.vocab_size, (VLM_B, VLM_TEXT), generator=g,
                         device=dev)
    rows = PATCH_TOKENS + VLM_TEXT
    log(f"frontends: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads {cfg.n_heads} over {cfg.kv_heads} of {cfg.head_dim}, "
        f"{n_params} parameters; B={VLM_B}, {PATCH_TOKENS} patch rows of "
        f"{cfg.frontend_dim} + {VLM_TEXT} text tokens = {rows} prompt rows, "
        f"max_len {VLM_MAX_LEN}, {VLM_NEW} greedy decode steps")
    before = plan_clock()
    plan = engine.make_serving_plan(cfg, VLM_MAX_LEN, device=dev)
    runs, calls = [], []
    with torch.no_grad():
        for impl in ("auto", "torch"):
            state = engine.init_decode_state(cfg, VLM_B, VLM_MAX_LEN, bf,
                                             plan=plan, device=dev)
            build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.prefill(params, cfg, toks, state, embeds=emb,
                                   plan=plan, impl=impl)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            if state.cache_len.tolist() != [rows] * VLM_B:
                raise SystemExit(f"frontends: cache_len "
                                 f"{state.cache_len.tolist()}")
            logits, fed, step_ms = [], [], []
            for i in range(VLM_NEW):
                if runs:
                    state.last_token.copy_(runs[0]["fed"][i])
                fed.append(state.last_token.clone())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, lg = engine.decode_step(params, cfg, state,
                                               plan=plan, impl=impl)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg.float())
            runs.append(dict(logits=logits, fed=fed, pre_ms=pre_ms,
                             step_ms=step_ms, launches=dict(build.LAUNCHES),
                             tokens=state.last_token.tolist()))
            calls.append(len(plan.resolutions))
    served, plain = runs
    total.update(served["launches"])
    paths = [f"{r[0]} {r[1]} {r[3]}" for r in plan.resolutions[:calls[0]]]
    log(f"  plan path per call of the served run (phase, context, path): "
        + ", ".join(paths))
    log_lowerings(plan_since(before)[0])
    check_served_plans("frontends", plan, cfg)
    log(f"  served: prefill {served['pre_ms']:.1f} ms, decode median "
        f"{statistics.median(served['step_ms']):.3f} ms "
        f"({min(served['step_ms']):.3f}-{max(served['step_ms']):.3f}), "
        f"launches {served['launches']}, last tokens {served['tokens']}; "
        f"plain versions: prefill {plain['pre_ms']:.1f} ms, decode median "
        f"{statistics.median(plain['step_ms']):.3f} ms, launches "
        f"{plain['launches']}")
    if plain["launches"]:
        raise SystemExit("frontends: impl torch launched a kernel")
    want = {"fused_attention_masked": cfg.n_layers,
            "fused_decode_block": VLM_NEW * cfg.n_layers}
    if served["launches"] != want:
        raise SystemExit(f"frontends: internvl launches "
                         f"{served['launches']}, predicted {want}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(served["logits"], plain["logits"])):
        # per row: within LOGIT_TOL of its largest |logit|; a flipped
        # argmax only where the plain top-2 margin is inside that
        top2 = torch.topk(b, 2, dim=-1).values
        scale = b.abs().amax(-1)
        rel = ((a - b).abs().amax(-1) / scale).max().item()
        margin = (top2[:, 0] - top2[:, 1]) / scale
        flipped = a.argmax(-1) != b.argmax(-1)
        worst = max(worst, rel)
        log(f"  parity step {i}: worst row rel={rel:.4e} (tol {LOGIT_TOL}), "
            f"argmax flipped in {int(flipped.sum())} of {VLM_B} rows")
        if not torch.isfinite(a).all() or rel > LOGIT_TOL or bool(
                (flipped & (margin > LOGIT_TOL)).any()):
            raise SystemExit(f"frontends: served logits disagree at step {i}")
    log(f"  served logits against the plain versions: worst rel "
        f"{worst:.4e} over {VLM_B} rows x {VLM_NEW} steps (tol {LOGIT_TOL})")
    del runs, served, plain, state, params
    torch.cuda.empty_cache()

    # -- internvl2-2b: one training step on the VLM batch ----------------
    rc = dataclasses.replace(cfg, remat="full")
    batch = {"embeds": torch.randn(VLM_B, PATCH_TOKENS, cfg.frontend_dim,
                                   generator=g, device=dev).to(bf),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (VLM_B, VLM_TRAIN_TEXT), generator=g,
                                     device=dev)}
    rows_, peak, base, leaves, _, _ = _train_steps(rc, [batch],
                                                   "internvl train", dev)
    loss, gn, ms, ln = rows_[0]
    log(f"  train: remat full, bf16 params and moments, batch embeds "
        f"{tuple(batch['embeds'].shape)} tokens {tuple(batch['tokens'].shape)}"
        f": loss {loss:.6f} grad_norm {gn:.6f}, one step {ms:.1f} ms, "
        f"launches {ln}, peak memory {peak / 1e9:.3f} GB ({base / 1e9:.3f} "
        f"GB allocated before); gradient leaves checked {leaves}")
    want = {"fused_attention_fwd": 2 * cfg.n_layers,
            "fused_attention_bwd_dq": cfg.n_layers,
            "fused_attention_bwd_dkv": cfg.n_layers}
    if ln != want or not math.isfinite(loss):
        raise SystemExit(f"frontends: internvl train launches {ln} "
                         f"(predicted {want}), loss {loss}")
    total.update(ln)
    return total


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# MoE: phi3.5-moe at full width, served at 28 layers, trained at 4
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
#: the served depth: all 32 layers' bf16 weights (83.7 GB) leave the
#: 85.5 GB card no room for the KV cache, the init's fp32 temporaries
#: and the CUDA context; 28 layers are 73.3 GB with the embeddings
MOE_SERVE_LAYERS = 28
#: the depth of the fp32-compute logits gate and of the training run
MOE_SHORT_LAYERS = 4
#: decode steps of the fp32-compute logits gate
MOE_LOGIT_STEPS = 8
#: gate (b)'s limit, relative to the largest |logit|: the fp32-compute
#: run on the kernels against the plain versions read 9.9853e-06 on an
#: H100 (700 W); a tile lost or mis-scaled would err by percents
MOE_FP32_TOL = 1e-4
#: the ops of the MoE FFN whose device time the profiled decode window
#: logs (the expert products are the aten::bmm calls: decode runs the
#: attention in the megakernel, with no bmm)
MOE_OPS = ("aten::mm", "aten::bmm", "aten::_softmax", "aten::sort",
           "aten::searchsorted", "aten::gather", "aten::scatter",
           "aten::cat", "aten::silu", "aten::mul", "aten::sum",
           "aten::one_hot")


def _moe_first(params, n: int) -> dict:
    """``params`` cut to its first ``n`` body layers (views)."""
    from repro_torch import tree
    return dict(params, layers=[tree.map(lambda t: t[:n], lp)
                                for lp in params["layers"]])


def _serve_counted(eng, cfg, args):
    """The serve mix's requests (made anew) through a RequestBatcher on
    ``eng``, preempts and resumes counted and each decode step timed.
    Returns (tokens by uid, counts, step seconds, wall seconds)."""
    from repro_torch.launch import serve
    from repro_torch.serve import RequestBatcher
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    batcher = RequestBatcher(args.batch, max_len=args.max_len)
    counts, step_s = {"preempt": 0, "resume": 0}, []
    orig = eng.preempt, eng.resume, eng.decode_once

    def preempt(slot):
        counts["preempt"] += 1
        return orig[0](slot)

    def resume(pre, slot):
        counts["resume"] += 1
        return orig[1](pre, slot)

    def decode_once():
        t = time.perf_counter()
        out = orig[2]()
        if out is not None:
            step_s.append(time.perf_counter() - t)
        return out

    eng.preempt, eng.resume, eng.decode_once = preempt, resume, decode_once
    for req in requests:
        batcher.submit(req)
    t0 = time.perf_counter()
    finished = batcher.serve(eng, max_steps=2000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit("moe: a served request did not finish its budget")
    return ({r.uid: list(r.generated) for r in finished}, counts, step_s,
            secs)


def _attention_side_by_side(pairs):
    """Patch ``models.attention.gqa_forward`` so each call with a cache
    and a fused plan dispatch also runs that path's kernel and its plain
    version on the call's input and a copy of its cache, both on a zero
    residual (the sub-block's own output), appending (path, rows, paged,
    rel err) to ``pairs``.  The call itself then runs as it was asked.
    The compared calls' launches are taken back out of the counts.
    Returns the original."""
    import dataclasses

    from repro_torch.kernels import build
    from repro_torch.models import attention as attn
    orig = attn.gqa_forward

    def both(params, cfg, x, positions, *, cache=None, plan=None,
             residual=None, **kw):
        if cache is not None and plan is not None \
                and plan.impl in ("cuda", "torch"):
            zero = torch.zeros_like(residual)
            outs, saved = [], collections.Counter(build.LAUNCHES)
            for impl in ("cuda", "torch"):
                outs.append(orig(
                    params, cfg, x, positions,
                    cache={k: v.clone() for k, v in cache.items()},
                    plan=dataclasses.replace(plan, impl=impl),
                    residual=zero, **kw)[0])
            # the comparison's launches are not the run's
            build.LAUNCHES.clear()
            build.LAUNCHES.update(saved)
            pairs.append((plan.path, x.shape[1], plan.paged,
                          rel_err(outs[0], outs[1])[1]))
        return orig(params, cfg, x, positions, cache=cache, plan=plan,
                    residual=residual, **kw)

    attn.gqa_forward = both
    return orig


def _side_by_side_gate(phase, pairs, want_paths) -> None:
    """Every compared attention call within KERNEL_TOL, and the paths of
    ``want_paths`` among them."""
    by = collections.defaultdict(list)
    for path, rows, paged, rel in pairs:
        by[(path, "paged" if paged else "dense",
            "decode" if rows == 1 else "chunk")].append(rel)
    for key, rels in sorted(by.items()):
        log(f"  {phase}: {'/'.join(key)}: {len(rels)} calls, worst rel "
            f"{max(rels):.4e} tol={KERNEL_TOL}")
    bad = [p for p in pairs if p[3] > KERNEL_TOL]
    missing = [p for p in want_paths if p not in {k[0] for k in by}]
    if bad or missing or not pairs:
        raise SystemExit(f"{phase}: kernel against plain version beyond "
                         f"tolerance {bad[:4]} or paths never compared "
                         f"{missing}")


def decode_window(args, cfg, params, requests, floor_ms,
                  label="moe") -> None:
    """A steady window of whole-batch decode steps, every row live: its
    step on the host clock against the bytes floor, then again under
    torch.profiler, by kernel and, for a MoE config, by MoE op, the
    expert products' rate beside.  ``label`` starts each line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import lower
    from repro_torch.models import moe
    from repro_torch.serve.engine import ContinuousBatchingEngine

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
    _, step_txt = timed_decode(eng, DECODE_WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_WINDOW):
        eng.decode_once()
    host_ms = (time.perf_counter() - t0) / DECODE_WINDOW * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_WINDOW):
            eng.decode_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"  {label} decode window: B={args.batch} live, contexts {eng.row_ctx}; "
        f"each step synchronised: {step_txt}; {DECODE_WINDOW} steps back to "
        f"back {host_ms:.3f} ms/step against the {floor_ms:.3f} ms bytes "
        f"floor ({floor_ms / host_ms:.4f} of it); then {DECODE_WINDOW} "
        f"profiled {wall / DECODE_WINDOW * 1e3:.3f} ms/step")
    busy = device_report(prof, wall, f"{label} profiled decode window",
                         top=10,
                         also=("decode_mma_kernel",))
    log(f"  {label} decode window: device busy {busy / DECODE_WINDOW:.3f} "
        f"ms/step; against the back-to-back step, idle share "
        f"{1 - busy / DECODE_WINDOW / host_ms:.4f}")
    if not cfg.moe:
        del eng
        return
    rows = args.batch * moe.capacity(cfg, 1)     # one token a group
    ff = cfg.d_expert or cfg.d_ff
    moe_op_table(prof, DECODE_WINDOW, bmm=(
        cfg.n_layers * 3 * 2 * cfg.n_experts * rows * cfg.d_model * ff,
        cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * ff * 2,
        f"E x C = {cfg.n_experts} x {rows} rows"))
    del eng


def moe_op_table(prof, steps: int, bmm=None) -> None:
    """The device time a step of each op of MOE_OPS in a profile of
    ``steps`` steps (each op's kernels, children included); with ``bmm``
    = (FLOP, weight bytes, label) a step, the expert products' rates."""
    from torch.autograd import DeviceType
    ops = {e.key: e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key in MOE_OPS}
    for key in MOE_OPS:
        e = ops.get(key)
        if e is None:
            continue
        ms = e.device_time_total / 1e3 / steps
        extra = ""
        if key == "aten::bmm" and bmm is not None and ms > 0:
            flops, wbytes, label = bmm
            extra = (f"; {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s on "
                     f"{flops / 1e12:.3f} TFLOP a step ({label}), "
                     f"{wbytes / (ms * 1e-3) / 1e12:.3f} TB/s of expert "
                     f"weights")
        log(f"    {key:20s} x{e.count // steps:<5d} a step, device "
            f"{ms:.3f} ms a step{extra}")


def moe_serve(dev):
    """phi3.5-moe at full width cut to MOE_SERVE_LAYERS: the serve mix
    through launch/serve.run (dense engine), again with the routing
    recorded, through the paged engine (page 16, the paged serve's pool:
    a preempt and its resume) with gate (c), a steady profiled decode
    window, the paged engine one and two rungs down (#5, #4), gate (a)
    on a plain run and gate (b) at MOE_SHORT_LAYERS in fp32 compute.
    Returns the launches of the driven serves."""
    import dataclasses

    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.serve.engine import ContinuousBatchingEngine

    args = serve.parser().parse_args([
        "--arch", MOE_ARCH, "--layers", str(MOE_SERVE_LAYERS), "--batch",
        "4", "--requests", "6", "--max-len", "1024", "--max-new", "16",
        "--prefill-chunk", "256", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg, params = serve.model_for(args)
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params) if t is not params["embed"])
    floor_ms = wbytes / PEAK_BYTES * 1e3
    log(f"moe serve: {cfg.name} d_model={cfg.d_model}, {cfg.n_experts} "
        f"experts of {cfg.d_expert} top-{cfg.top_k}, {cfg.n_heads} query "
        f"heads over {cfg.kv_heads} KV heads, cut to {cfg.n_layers} of 32 "
        f"layers; bf16 random weights (seed 0) in {time.time() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated (init "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB); | {card_line()}")
    log(f"  weights read per decode step {wbytes / 1e9:.3f} GB (every "
        f"expert: the capacity layout computes all {cfg.n_experts} each "
        f"step): floor {floor_ms:.3f} ms at {PEAK_BYTES / 1e12} TB/s")
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)

    # the dense serve through the launcher
    lower.clear_plan_cache()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = plan_clock()
    ops.reset_counts()
    out = serve.run(args, cfg, params, requests)
    launches = collections.Counter(build.LAUNCHES)
    spent = plan_since(before)
    finished, steps = out["finished"], out["decode_step_s"]
    gen = sum(len(r.generated) for r in finished)
    step_ms = statistics.median(steps) * 1e3
    peak = torch.cuda.max_memory_allocated()
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    free = total_mem - torch.cuda.max_memory_reserved()
    log(f"  dense serve: {len(finished)}/{len(requests)} requests, {gen} "
        f"tokens in {out['seconds']:.3f}s; decode steps {len(steps)}, median "
        f"step {step_ms:.3f} ms against the {floor_ms:.3f} ms floor; peak "
        f"memory {peak / 1e9:.3f} GB allocated, "
        f"{torch.cuda.max_memory_reserved() / 1e9:.3f} GB reserved of the "
        f"card's {total_mem / 1e9:.3f} GB: {free / 1e9:.3f} GB left")
    log_rates("moe dense serve", gen, out["seconds"], spent,
              len(out["plan"].resolutions))
    log_lowerings(spent[0])
    check_served_plans("moe serve", out["plan"], cfg)
    log(f"  launches: {dict(launches)}")
    missing = [n for n in DENSE_KERNELS if launches[n] == 0]
    if missing or len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit(f"moe serve: kernels never launched {missing}, or "
                         "a request short")
    if free < 4e9:
        log(f"  moe serve: under 4 GB of the card left at "
            f"{cfg.n_layers} layers")
    served = {r.uid: r.generated for r in finished}
    del out, finished

    # gate (c): the dense engine again and the paged engine; the paged
    # tokens equal to the dense
    plan = lower.serving_plan(cfg, args.max_len, device=dev)
    dense = _serve_counted(ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len, plan=plan,
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=dev), cfg, args)
    log(f"  dense engine again, routing recorded: tokens "
        f"{'equal to' if dense[0] == served else 'NOT equal to'} the "
        f"launcher's serve")
    pages_for = lambda n: -(-n // PAGE)
    num_pages = 2 + sum(pages_for(len(r.prompt) + 1)
                        for r in requests[:args.batch])
    lower.clear_plan_cache()
    before = plan_clock()
    ops.reset_counts()
    plan = lower.serving_plan(cfg, args.max_len, device=dev, paged=True,
                              page_size=PAGE)
    paged = _serve_counted(paged_engine(params, cfg, args, plan, num_pages,
                                       dev), cfg, args)
    got = dict(build.LAUNCHES)
    spent = plan_since(before)
    toks, counts, steps, secs = paged
    log(f"  paged serve: pool {num_pages} pages of {PAGE}, preempts "
        f"{counts['preempt']}, resumes {counts['resume']}; decode steps "
        f"{len(steps)}, median step {statistics.median(steps) * 1e3:.3f} "
        f"ms; launches {got}")
    log_rates("moe paged serve", sum(map(len, toks.values())), secs, spent,
              len(plan.resolutions))
    if not counts["preempt"] or counts["resume"] != counts["preempt"] \
            or not got.get("fused_decode_block_paged"):
        raise SystemExit(f"moe paged serve: {counts}, launches {got}")
    differ = sorted(u for u in dense[0] if toks.get(u) != dense[0][u])
    log(f"  gate (c): paged tokens equal to the dense engine's for "
        f"{len(dense[0]) - len(differ)}/{len(dense[0])} requests")
    if differ:
        raise SystemExit(f"moe gate (c): paged tokens differ from the "
                         f"dense engine's for requests {differ}")
    launches.update(got)
    del dense, paged

    decode_window(args, cfg, params, requests, floor_ms)

    # gate (a): one request on the plain versions, each attention call's
    # kernel beside its plain version on the same input; then the paged
    # engine at its own rung and one and two rungs down (#6, #5, #4) on
    # the kernels, compared so
    prompt = requests[1].prompt
    pairs = []
    orig = _attention_side_by_side(pairs)
    try:
        eng = ContinuousBatchingEngine(
            params, cfg, batch_size=1, max_len=args.max_len,
            plan=lower.ServingPlan(cfg=cfg, max_len=args.max_len,
                                   device=torch.device("cpu"),
                                   n_blocks=cfg.n_layers),
            dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
            device=dev)
        _one_request_logits(eng, prompt)
        del eng
        _side_by_side_gate(f"gate (a), prompt {len(prompt)} tokens", pairs,
                           ("fused_attention", "qproj_attention",
                            "decode_megakernel"))
        for demotions in (0, 1, 2):
            del pairs[:]
            plan = lower.ServingPlan(cfg=cfg, max_len=args.max_len,
                                     device=dev, n_blocks=cfg.n_layers,
                                     paged=True, page_size=PAGE)
            eng = paged_engine(params, cfg, args, plan,
                               args.max_len // PAGE + 1, dev, batch=1)
            eng.demotions = demotions
            ops.reset_counts()
            _one_request_logits(eng, prompt)
            got = dict(build.LAUNCHES)
            step = f"{eng.last_dispatch.path}/{eng.last_dispatch.impl}"
            del eng
            log(f"  rung-down: demotions={demotions}, decode on {step}, "
                f"launches {got}")
            _side_by_side_gate(f"rung-down {demotions}", pairs,
                               {0: ("decode_megakernel",)}.get(demotions,
                                                               ()))
            want = {0: "fused_decode_block_paged",
                    1: "fused_qproj_attention_paged",
                    2: "fused_attention_paged"}[demotions]
            if not got.get(want):
                raise SystemExit(f"moe rung-down: {want} never launched")
            launches.update({want: got[want]})
    finally:
        attn.gqa_forward = orig

    # gate (b): MOE_SHORT_LAYERS layers in fp32 compute, bf16 weights
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_SHORT_LAYERS,
                                compute_dtype="float32")
    p32 = _moe_first(params, MOE_SHORT_LAYERS)
    runs = []
    for plan_dev in (dev, torch.device("cpu")):
        eng = ContinuousBatchingEngine(
            p32, cfg32, batch_size=1, max_len=args.max_len,
            plan=lower.ServingPlan(cfg=cfg32, max_len=args.max_len,
                                   device=plan_dev, n_blocks=cfg32.n_layers),
            dtype=cfg32.torch_dtype(), prefill_chunk=args.prefill_chunk,
            device=dev)
        ops.reset_counts()
        runs.append(_one_request_logits(eng, prompt,
                                        runs[0][1] if runs else None,
                                        steps=MOE_LOGIT_STEPS))
        runs[-1] += (dict(build.LAUNCHES),)
        del eng
    fp32_launches, plain_launches = runs[0][2], runs[1][2]
    worst = compare_logits("moe fp32", runs[0][0], runs[1][0],
                           tol=MOE_FP32_TOL)
    log(f"  gate (b): {cfg32.n_layers} layers, fp32 compute, prompt "
        f"{len(prompt)} tokens, prefill + {MOE_LOGIT_STEPS} decode steps: "
        f"worst rel {worst:.4e} (tol {MOE_FP32_TOL}); launches "
        f"{fp32_launches}, on the plain versions {plain_launches}")
    unrun = [n for n in DENSE_KERNELS if not fp32_launches.get(n)]
    if unrun or any(plain_launches.values()):
        raise SystemExit(f"moe gate (b): kernels never launched in fp32 "
                         f"{unrun}, or the plain run launched "
                         f"{plain_launches}")
    del params, p32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def short_train(cfg, phase, dev, after_profile=None, batch=TRAIN_B):
    """``launch/train.train_loop`` on ``cfg`` (a full-width config, cut in
    depth where it must be): remat full, bf16 moments, B=``batch``, seq
    2048, 3 steps.  The first step's gradients are taken twice from the
    same state and must be equal bit for bit; every per-layer leaf
    finite and non-zero; the launches of #7-#9 a step as _train_launches
    predicts, and none of #11 (no backward: training scans on the plain
    version); the aux losses positive where ``cfg.moe``.  Then one more
    step under the profiler, by part, and ``after_profile(prof)`` where
    given.  Returns the launches of the 3 steps."""
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.train import step as train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_step, total, grad_leaves = [], collections.Counter(), []
    value_and_grad = train_step.value_and_grad
    first, repeat = {}, {}

    def capture(*a, **kw):
        if not first:
            first.update(a=a, kw=kw)
        return value_and_grad(*a, **kw)

    def twice(grads):
        """The first call's gradients again from the same state (its
        launches not counted), compared bit for bit."""
        if repeat:
            return
        saved = collections.Counter(build.LAUNCHES)
        _, again = value_and_grad(*first["a"], **first["kw"])
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        pairs = list(zip(_grad_leaves(grads), _grad_leaves(again)))
        repeat["differ"] = [n for (n, a), (_, b) in pairs
                            if not torch.equal(a, b)]
        repeat["leaves"] = len(pairs)
        first.clear()
        del again, pairs

    aux = ("moe_lb_loss", "moe_z_loss") if cfg.moe else ()

    def on_step(step, metrics, secs):
        per_step.append((step, float(metrics["loss"]),
                         [float(metrics[k]) for k in aux],
                         float(metrics["grad_norm"]), secs,
                         {n: build.LAUNCHES[n] for n in TRAIN_KERNELS},
                         build.LAUNCHES["ssd_scan"]))
        total.update(build.LAUNCHES)
        build.reset_launches()

    build.reset_launches()
    t0 = time.perf_counter()
    train_step.value_and_grad = capture
    try:
        with checked_grads(phase, grad_leaves, after=twice):
            state, losses = train.train_loop(
                cfg, steps=3, batch=batch, seq=TRAIN_SEQ, lr=TRAIN_LR,
                moment_dtype="bfloat16", device=dev, on_step=on_step,
                log_every=1)
    finally:
        train_step.value_and_grad = value_and_grad
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pbytes = sum(t.numel() * t.element_size() for t in _leaves(state.params))
    obytes = sum(t.numel() * t.element_size() for m in
                 (state.opt.mu, state.opt.nu) for t in _leaves(m))
    for step, loss, auxes, gn, secs, launches, _ in per_step:
        log(f"  step {step}: loss {loss:.6f} " + "".join(
            f"{k} {x:.6f} " for k, x in zip(aux, auxes)) +
            f"grad_norm {gn:.6f} {secs * 1e3:.1f} ms, launches {launches}")
    med = statistics.median(p[4] for p in per_step[1:])
    tok = batch * TRAIN_SEQ
    log(f"  step time: median of steps 2-3 {med * 1e3:.1f} ms; "
        f"{tok / med:.1f} training tokens/s; wall {wall:.1f}s incl. init "
        f"and the first step's second gradient")
    log(f"  peak memory {peak / 1e9:.3f} GB (max_memory_allocated, the "
        f"first step's two gradient sets included); parameters "
        f"{pbytes / 1e9:.3f} GB, moments {obytes / 1e9:.3f} GB, gradients "
        f"{pbytes / 1e9:.3f} GB: state {(2 * pbytes + obytes) / 1e9:.3f} GB")
    log(f"  first step's gradients taken twice: "
        f"{repeat['leaves'] - len(repeat['differ'])}/{repeat['leaves']} "
        f"leaves equal bit for bit; gradient leaves checked non-zero per "
        f"call: {grad_leaves}")
    want = _train_launches(cfg)
    if len(per_step) != 3 or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{phase}: losses {losses}")
    if any(p[5] != want for p in per_step):
        raise SystemExit(f"{phase}: launches per step "
                         f"{[p[5] for p in per_step]}, predicted {want}")
    if any(p[6] for p in per_step):
        raise SystemExit(f"{phase}: ssd_scan launched in a training step "
                         f"{[p[6] for p in per_step]}")
    if repeat["differ"]:
        raise SystemExit(f"{phase}: gradients not bitwise repeatable: "
                         f"{repeat['differ'][:8]}")
    if not all(x > 0 for p in per_step for x in p[2]):
        raise SystemExit(f"{phase}: zero aux losses")

    # one more step under the profiler: where a step's time goes
    from repro_torch.data import SyntheticTokenDataset
    ds = SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, batch, seed=0,
                               structured=True)
    feed = {"tokens": torch.from_numpy(ds.batch(3)).long().to(dev)}
    state, loss, prof, busy = profiled_step(
        train_step.make_train_step(cfg, lr=TRAIN_LR), state, feed,
        f"{phase} profiled training step", 12)
    train_breakdown(prof, busy, cfg,
                    sum(t.numel() for t in _leaves(state.params)), batch)
    if after_profile is not None:
        after_profile(prof)
    log(f"  profiled step: loss {loss:.6f}")
    del state, prof
    gc.collect()
    torch.cuda.empty_cache()
    return total


def moe_train(dev):
    """``short_train`` on phi3.5-moe at full width cut to
    MOE_SHORT_LAYERS, with the MoE ops of the profiled step.  Returns the
    launches of the 3 steps."""
    import dataclasses

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              n_layers=MOE_SHORT_LAYERS)
    log(f"moe train: {cfg.name} d_model={cfg.d_model}, {cfg.n_experts} "
        f"experts of {cfg.d_expert}, cut to {cfg.n_layers} layers, remat "
        f"{cfg.remat}, bf16 params and moments, B={TRAIN_B} seq {TRAIN_SEQ} "
        f"lr {TRAIN_LR}, 3 steps; | {card_line()}")
    return short_train(cfg, "moe train", dev,
                       after_profile=lambda prof: moe_op_table(prof, 1))


def moe_phase(dev):
    """phi3.5-moe: the serve (moe_serve), then the training run
    (moe_train), every earlier phase's weights freed first."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe: device memory allocated before the phase "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    launches = moe_serve(dev)
    launches.update(moe_train(dev))
    return launches


# ---------------------------------------------------------------------------
# MLA: deepseek-v3 at full width, served through #1's wide body
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
#: the served depth: the 3 dense-prefix layers and 1 MoE layer (15.11 G
#: parameters, 30.2 GB in bf16)
MLA_LAYERS = 4
#: the absorbed call's widths: 128 query heads of r_kv + rope = 576 over
#: one latent head, V its first 512 columns, scaled by (128 + 64)^-0.5
MLA_HQ, MLA_D, MLA_DV = 128, 576, 512
MLA_SCALE = 192 ** -0.5
#: the shape-only plans' crossovers at that head config: decode fuses at
#: C > 2N = 1152; prefill buckets M to a power of two, so chunks of more
#: than 512 rows fuse (576 and 577 alike)
MLA_CROSS, MLA_PREFILL_EDGE = 2 * MLA_D, 512
#: the served mix, B = 4, chunks of 1024, max_len 2048, 24 new tokens.
#: Prompt lengths chosen in [900, 1700) so every regime shows: 1140
#: (chunks 1024 on #1 and 116 on the reference; the deepest of the first
#: four, whose decode crosses C = 1152 at its 13th step), 950, 1000 and
#: 900 (one chunk each on #1, decode at C <= 1152 on the reference),
#: then 1600 (chunks 1024 and 576, both on #1) and 1300 (1024 on #1, 276
#: on the reference), decoding past C = 1152 on #1
MLA_PROMPTS = (1140, 950, 1000, 900, 1600, 1300)
MLA_NEW, MLA_CHUNK, MLA_MAX_LEN = 24, 1024, 2048
#: gate (b): one 1200-token request (a 1024-row chunk on #1's fp32 one
#: pass, 176 rows on the reference), then 8 decode steps at C 1201-1208
#: on #1's fp32 split, all 4 layers in fp32 compute, against the plain
#: versions
MLA_FP32_PROMPT, MLA_FP32_STEPS = 1200, 8
#: gate (b)'s limit, relative to the largest |logit|, as phi3.5-moe's
MLA_FP32_TOL = 1e-4
#: #1's tolerance per row in fp32 (FMAs in another order; bf16 takes
#: ROW_TOL)
WIDE_FP32_TOL = 1e-4


def mla_attention_record(q, k, lens, tag) -> dict:
    """#1's wide body on q (B, 128, Sq, 576) over the latent k (B, 1, C,
    576), V its first 512 columns, causal at ``lens``: per row against
    the plain version (ROW_TOL in bf16, WIDE_FP32_TOL in fp32), bitwise
    repeatable, and that gate shown to reject the plain result with the
    deepest rows' last 32 keys (a tile's worth) dropped.  Its record:
    times, the bound over the score entries and latent rows these
    lengths need, and SDPA with a boolean mask (heads broadcast over
    the one latent head) as the yardstick."""
    from repro_torch.kernels.chunked import chunked_attention
    from repro_torch.kernels.fused_attention import (
        WIDE_TILE, fused_attention_masked, fused_attention_masked_plain)
    name = "fused_attention_masked"
    v = k[..., :MLA_DV]
    b, hq, sq, d = q.shape
    f = lambda: fused_attention_masked(q, k, v, lens, scale=MLA_SCALE)
    p = lambda: fused_attention_masked_plain(q, k, v, lens, scale=MLA_SCALE)
    out, want = f(), p()
    if not torch.isfinite(out.float()).all():
        raise SystemExit(f"{name} [{tag}]: non-finite output")
    if not torch.equal(f(), out):
        raise SystemExit(f"{name} [{tag}] is not deterministic")
    log(f"  {name} [{tag}] bitwise repeatable")
    # the deepest rows without their last WIDE_TILE keys
    cut = want.clone()
    r0 = max(0, sq - 64)
    offs = lens - sq + r0
    cut[:, :, r0:] = chunked_attention(
        q[:, :, r0:], k, v, causal=True, scale=MLA_SCALE, q_offset=offs,
        lengths=lens - WIDE_TILE)
    if q.dtype == torch.bfloat16:
        row_gate(name, tag, {"o": (out, want)})
        row_gate(name, f"{tag}, plain without the last {WIDE_TILE} keys",
                 {"o": (cut, want)}, expect=False)
    else:
        e, e_cut = row_err(out, want), row_err(cut, want)
        log(f"  {name} [{tag}] per row {e:.3e} (tol {WIDE_FP32_TOL}); plain "
            f"without the last {WIDE_TILE} keys {e_cut:.3e}: "
            f"{'rejected, as it must be' if e_cut > WIDE_FP32_TOL else 'FAIL'}")
        if e > WIDE_FP32_TOL or e_cut <= WIDE_FP32_TOL:
            raise SystemExit(f"{name} [{tag}]: fp32 per-row gate")
    err = rel_err(out, want)[0]
    del out, want, cut
    bms, by = bound("fused_attention_masked", b, hq, k.shape[1], sq,
                    k.shape[2], d, MLA_DV, lengths=lens.tolist(),
                    causal=True, el=q.element_size(), v_in_k=True)
    mask = mask_of(lens, sq, k.shape[2], q.device)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)
    return dict(max_abs_err=err, ms=time_ms(f, 10), plain_ms=time_ms(p, 3),
                bound_ms=bms, bound_by=by,
                library_ms=lib_ms(f"SDPA (boolean mask) for {name} [{tag}]",
                                  lambda: time_ms(lib, 5)))


def mla_kernel_phase(dev, g) -> dict:
    """#1's wide body at MLA's served shapes, bf16 and fp32: decode (B=4,
    Sq=1, C 1153-2048: the split into KV chunks) and a second prefill
    chunk (B=1, Sq=1024, C=2048: one pass).  Returns {kernel:
    {"mla_decode": record, "mla_prefill": record}} (the bf16 records;
    fp32's are logged)."""
    from repro_torch.kernels.fused_attention import wide_chunks
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for key, b, sq, lens in (("mla_decode", 4, 1, [1153, 1400, 1800, 2048]),
                             ("mla_prefill", 1, 1024, [2048])):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, MLA_HQ, sq, MLA_D, generator=g,
                            device=dev).to(dtype)
            k = torch.randn(b, 1, MLA_MAX_LEN, MLA_D, generator=g,
                            device=dev).to(dtype)
            ll = torch.tensor(lens, dtype=torch.int32, device=dev)
            n = wide_chunks(b, MLA_HQ, 1, sq, n_sms, dtype)
            tag = (f"MLA B={b} H={MLA_HQ}/1 Sq={sq} C={MLA_MAX_LEN} "
                   f"lengths={lens} D={MLA_D} Dv={MLA_DV} "
                   f"{str(dtype)[6:]} {n} KV chunks")
            r = mla_attention_record(q, k, ll, tag)
            log_record("fused_attention_masked", r, tag)
            if dtype == torch.bfloat16:
                out[key] = dict(shape=tag, **r)
            del q, k
            torch.cuda.empty_cache()
    return {"fused_attention_masked": out}


def _mla_requests(cfg):
    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(0)
    return [Request(uid=uid, prompt=torch.randint(
        0, cfg.vocab_size, (n,), generator=rng).tolist(),
        max_new_tokens=MLA_NEW) for uid, n in enumerate(MLA_PROMPTS)]


@contextlib.contextmanager
def _mla_recorders(calls, steps, gate=False):
    """While open: every ``ops.attention`` call appends [rows, the impl
    it ran (from ops.CALLS), #1 launches it made (build.LAUNCHES), and
    with ``gate`` its per-row error against #1's plain version on the
    same input]; every dense engine decode step appends (C = the deepest
    live row + 1, its impl, {slot: context} of the live rows)."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fused_attention import (
        fused_attention_masked_plain)
    from repro_torch.serve import engine as em
    attention, decode_once = ops.attention, em.ContinuousBatchingEngine.decode_once

    def attention_recorded(q, k, v, **kw):
        before = collections.Counter(ops.CALLS)
        n = build.LAUNCHES["fused_attention_masked"]
        out = attention(q, k, v, **kw)
        impl = next(i for (e, i), c in ops.CALLS.items()
                    if e == "attention" and c > before[(e, i)])
        rec = [q.shape[2], impl, build.LAUNCHES["fused_attention_masked"] - n,
               None]
        if gate and kw.get("lengths") is not None:
            want = fused_attention_masked_plain(
                q, k, v, kw["lengths"].to(torch.int32),
                causal=kw.get("causal", True), scale=kw.get("scale"))
            rec[3] = row_err(out, want)
        calls.append(rec)
        return out

    def decode_recorded(self):
        live = {i: c for i, (c, a) in enumerate(zip(self.row_ctx,
                                                      self.live)) if a}
        out = decode_once(self)
        if out is not None:
            steps.append((max(live.values()) + 1, self.last_dispatch.impl,
                          live))
        return out

    ops.attention = attention_recorded
    em.ContinuousBatchingEngine.decode_once = decode_recorded
    try:
        yield
    finally:
        ops.attention = attention
        em.ContinuousBatchingEngine.decode_once = decode_once


def mla_regimes(calls, steps) -> dict:
    """The served run's regimes, counted: (i) prefill chunks of more than
    512 rows on #1, (ii) chunks of 2-512 rows on the reference, (iii)
    decode steps at C <= 1152 on the reference, (iv) at C > 1152 on #1,
    (v) rows whose request crossed C = 1152 mid-decode (a reference step
    and a later #1 step of one unbroken run of the row); #1's launches at
    each shape.  Every call must be consistent with its regime."""
    chunks = [c for c in calls if c[0] > 1]
    dec = [c for c in calls if c[0] == 1]
    n = {"i": sum(1 for r, i, l, _ in chunks if r > MLA_PREFILL_EDGE
                  and i == "cuda" and l == 1),
         "ii": sum(1 for r, i, l, _ in chunks if r <= MLA_PREFILL_EDGE
                   and i == "reference" and l == 0),
         "iii": sum(1 for c, i, _ in steps if c <= MLA_CROSS
                    and i == "reference"),
         "iv": sum(1 for c, i, _ in steps if c > MLA_CROSS and i == "cuda")}
    odd = [c for c in chunks if (c[0] > MLA_PREFILL_EDGE) != (c[1] == "cuda")
           or c[2] != (c[1] == "cuda")]
    odd += [s[:2] for s in steps if (s[0] > MLA_CROSS) != (s[1] == "cuda")]
    crossed = set()
    for a, (_, ia, la) in enumerate(steps):
        for bb in range(a + 1, len(steps)):
            _, ib, lb = steps[bb]
            crossed |= {s for s in la if s in lb and ia == "reference"
                        and ib == "cuda" and lb[s] - la[s] == bb - a
                        and la[s] + 1 <= MLA_CROSS < lb[s] + 1}
    n["v"] = len(crossed)
    n["launches_decode"] = sum(c[2] for c in dec)
    n["launches_prefill"] = sum(c[2] for c in chunks)
    if odd or not all(n[k] for k in ("i", "ii", "iii", "iv", "v")):
        raise SystemExit(f"mla serve: regimes {n}, calls off their plan "
                         f"{odd[:6]}")
    return n


def _upcast(tree) -> None:
    """Every floating leaf of ``tree`` as fp32, in place, largest first,
    each bf16 leaf dropped once its copy is made."""
    slots = []

    def walk(t):
        items = t.items() if isinstance(t, dict) else enumerate(t)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif v.is_floating_point() and v.dtype != torch.float32:
                slots.append((v.numel(), t, k))
    walk(tree)
    for _, t, k in sorted(slots, key=lambda s: -s[0]):
        t[k] = t[k].float()
    gc.collect()
    torch.cuda.empty_cache()


def mla_phase(dev, g):
    """deepseek-v3-671b at full width, MLA_LAYERS layers, bf16, random
    weights from seed 0, every earlier phase's weights freed first: the
    kernel records of #1's wide body (mla_kernel_phase); the mix of
    MLA_PROMPTS through launch/serve.run on the dense engine, its
    regimes counted (mla_regimes); gate (a): the mix again with every
    attention call beside #1's plain version on the same input, per
    row; a steady B=4 decode window, then profiled; gate (b): the
    weights upcast to fp32 (the bf16 ones freed), all MLA_LAYERS layers
    in fp32 compute on the kernels against the plain versions.  Returns
    (launches of the served run, #1's MLA records)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import lower
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ContinuousBatchingEngine

    gc.collect()
    torch.cuda.empty_cache()
    log(f"mla: device memory allocated before the phase "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB | {card_line()}")
    records = mla_kernel_phase(dev, g)
    args = serve.parser().parse_args([
        "--arch", MLA_ARCH, "--layers", str(MLA_LAYERS), "--batch", "4",
        "--requests", str(len(MLA_PROMPTS)), "--max-len", str(MLA_MAX_LEN),
        "--max-new", str(MLA_NEW), "--prefill-chunk", str(MLA_CHUNK),
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg, params = serve.model_for(args)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    wbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params) if t is not params["embed"])
    floor_ms = wbytes / PEAK_BYTES * 1e3
    latent = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    per_head = cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                              + cfg.v_head_dim) * 2
    log(f"mla serve: {cfg.name} d_model={cfg.d_model}, {cfg.n_heads} heads "
        f"(q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope "
        f"{cfg.qk_rope_head_dim}, nope {cfg.qk_nope_head_dim}, v "
        f"{cfg.v_head_dim}), {cfg.first_dense_layers} dense-prefix layers "
        f"(d_ff {cfg.d_ff}) then MoE ({cfg.n_experts} experts of "
        f"{cfg.d_expert}, top-{cfg.top_k}, {cfg.n_shared_experts} shared), "
        f"cut to {cfg.n_layers} of 61 layers; {n_params / 1e9:.3f} G bf16 "
        f"parameters (seed 0) in {time.time() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated (init peak "
        f"{init_peak / 1e9:.3f} GB); | {card_line()}")
    log(f"  weights read per decode step {wbytes / 1e9:.3f} GB (all but the "
        f"embedding; the capacity layout computes every expert): floor "
        f"{floor_ms:.3f} ms at {PEAK_BYTES / 1e12} TB/s")
    log(f"  latent cache: {latent} B a token a layer ((kv_lora + rope) x 2 B) "
        f"against per-head K/V's {per_head} B ({cfg.n_heads} heads x (nope "
        f"+ rope + v) x 2 B): {per_head / latent:.1f}x less; "
        f"{latent * cfg.n_layers * args.batch * args.max_len / 1e6:.3f} MB "
        f"for the batch's {args.batch} x {args.max_len} rows")
    requests = _mla_requests(cfg)

    # the served run, through the launcher
    lower.clear_plan_cache()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = plan_clock()
    ops.reset_counts()
    calls, steps = [], []
    with _mla_recorders(calls, steps):
        out = serve.run(args, cfg, params, requests)
    launches = collections.Counter(build.LAUNCHES)
    spent = plan_since(before)
    finished, step_s = out["finished"], out["decode_step_s"]
    gen = sum(len(r.generated) for r in finished)
    peak = torch.cuda.max_memory_allocated()
    served = {r.uid: list(r.generated) for r in finished}
    log(f"  dense serve: prompts {list(MLA_PROMPTS)}, {len(finished)}/"
        f"{len(requests)} requests, {gen} tokens in {out['seconds']:.3f}s; "
        f"decode steps {len(step_s)}, median step "
        f"{statistics.median(step_s) * 1e3:.3f} ms against the "
        f"{floor_ms:.3f} ms floor; peak memory {peak / 1e9:.3f} GB "
        f"allocated; plan {out['plan']} (MLA is no DSE workload: the engine "
        f"resolves the shape-only plan of the {MLA_HQ} x {MLA_D} heads) | "
        f"{card_line()}")
    log_rates("mla dense serve", gen, out["seconds"], spent, len(steps))
    log_lowerings(spent[0])
    reg = mla_regimes(calls, steps)
    log(f"  regimes: (i) {reg['i']} prefill chunks of > {MLA_PREFILL_EDGE} "
        f"rows on #1, (ii) {reg['ii']} chunks of <= {MLA_PREFILL_EDGE} rows "
        f"on the reference, (iii) {reg['iii']} decode steps at C <= "
        f"{MLA_CROSS} on the reference, (iv) {reg['iv']} at C > {MLA_CROSS} "
        f"on #1, (v) {reg['v']} request(s) crossing C = {MLA_CROSS} "
        f"mid-decode; #1 launches: {reg['launches_decode']} at decode "
        f"(B<=4, Sq=1), {reg['launches_prefill']} at prefill chunks; "
        f"ops.CALLS {dict(ops.CALLS)}; launches {dict(launches)}")
    if len(finished) != len(requests) or any(
            len(r.generated) != MLA_NEW for r in finished):
        raise SystemExit("mla serve: a request did not finish its budget")
    records["fused_attention_masked"]["mla_decode"]["launches"] = \
        reg["launches_decode"]
    records["fused_attention_masked"]["mla_prefill"]["launches"] = \
        reg["launches_prefill"]
    del out, finished

    # gate (a): the mix again, each attention call beside #1's plain
    # version on its own input (the reference's calls too)
    calls_a, steps_a = [], []
    with _mla_recorders(calls_a, steps_a, gate=True):
        again = serve.run(args, cfg, params, _mla_requests(cfg))
    toks = {r.uid: list(r.generated) for r in again["finished"]}
    del again
    by = collections.defaultdict(list)
    for rows, impl, _, e in calls_a:
        by[("decode" if rows == 1 else "chunk", impl)].append(e)
    for key, errs in sorted(by.items()):
        log(f"  gate (a): {'/'.join(key)}: {len(errs)} calls (4 layers "
            f"each), worst per row {max(errs):.4e} (tol {ROW_TOL})")
    worst = max(e for _, _, _, e in calls_a)
    log(f"  gate (a): tokens {'equal to' if toks == served else 'NOT equal to'}"
        f" the served run's")
    if worst > ROW_TOL:
        raise SystemExit(f"mla gate (a): an attention call at {worst:.4e}")

    # a steady decode window, every row live past C = 1152
    eng = ContinuousBatchingEngine(
        params, cfg, batch_size=args.batch, max_len=args.max_len,
        dtype=cfg.torch_dtype(), prefill_chunk=args.prefill_chunk,
        device=dev)
    for slot, req in enumerate(sorted(requests, key=lambda r: -len(
            r.prompt))[:args.batch]):
        eng.begin_prefill(slot, req.prompt)
    while not all(eng.live):
        eng._advance_prefills()
    eng.decode_once()
    _, step_txt = timed_decode(eng, DECODE_WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_WINDOW):
        eng.decode_once()
    host_ms = (time.perf_counter() - t0) / DECODE_WINDOW * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_WINDOW):
            eng.decode_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"  mla decode window: B={args.batch} live, contexts {eng.row_ctx} "
        f"({eng.last_dispatch.path}/{eng.last_dispatch.impl}); each step "
        f"synchronised: {step_txt}; {DECODE_WINDOW} steps back to back "
        f"{host_ms:.3f} ms/step against the {floor_ms:.3f} ms bytes floor "
        f"({floor_ms / host_ms:.4f} of it); then {DECODE_WINDOW} profiled "
        f"{wall / DECODE_WINDOW * 1e3:.3f} ms/step")
    busy = device_report(prof, wall, "mla profiled decode window", top=10,
                         also=("masked_wide",))
    log(f"  mla decode window: device busy {busy / DECODE_WINDOW:.3f} "
        f"ms/step; against the back-to-back step, idle share "
        f"{1 - busy / DECODE_WINDOW / host_ms:.4f} | {card_line()}")
    moe_op_table(prof, DECODE_WINDOW)
    del eng, prof
    gc.collect()
    torch.cuda.empty_cache()

    # gate (b): all MLA_LAYERS layers in fp32 compute, the bf16 weights
    # upcast in place (the bf16 leaves freed as they go)
    _upcast(params)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                param_dtype="float32")
    prompt = torch.randint(0, cfg.vocab_size, (MLA_FP32_PROMPT,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for impl in ("auto", "torch"):
        eng = ContinuousBatchingEngine(
            params, cfg32, batch_size=1, max_len=args.max_len,
            dtype=torch.float32, prefill_chunk=args.prefill_chunk,
            device=dev, impl=impl)
        ops.reset_counts()
        runs.append(_one_request_logits(eng, prompt,
                                        runs[0][1] if runs else None,
                                        steps=MLA_FP32_STEPS))
        runs[-1] += (dict(build.LAUNCHES), dict(ops.CALLS))
        del eng
    worst = compare_logits("mla fp32", runs[0][0], runs[1][0],
                           tol=MLA_FP32_TOL)
    log(f"  gate (b): all {cfg32.n_layers} layers in fp32 (weights upcast, "
        f"{sum(t.numel() * 4 for t in _leaves(params)) / 1e9:.3f} GB; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB), prompt "
        f"{len(prompt)} tokens in chunks of {args.prefill_chunk}, + "
        f"{MLA_FP32_STEPS} decode steps: worst rel {worst:.4e} (tol "
        f"{MLA_FP32_TOL}); kernels: launches {runs[0][2]}, calls "
        f"{runs[0][3]}; plain versions: launches {runs[1][2]}, calls "
        f"{runs[1][3]}")
    if runs[0][2].get("fused_attention_masked", 0) != \
            cfg32.n_layers * (1 + MLA_FP32_STEPS) or any(runs[1][2].values()):
        raise SystemExit("mla gate (b): #1 not on the fp32 chunk and every "
                         "decode step, or the plain run launched a kernel")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, records


# ---------------------------------------------------------------------------
# MLA training: deepseek-v3's dense layers through #7-#9 at D 192 / Dv 128
# ---------------------------------------------------------------------------

#: deepseek-v3's cache-free training attention: B=2, 128 query heads over
#: 128 (group 1), S = 2048, causal, D = nope 128 + rope 64, Dv = 128, at
#: the kernels' default scale D^-0.5 = 192^-0.5, MLA's own
MLA_ATTN = (2, 128, 2048, 192, 128)
#: #7-#9's fp32 tolerance per row (FMAs summing in another order than
#: the plain versions; bf16 takes ROW_TOL), and on lse, absolute
TRAIN_FP32_TOL = 1e-4
#: the trained depth: deepseek-v3's dense-layer math (MLA and a SwiGLU of
#: d_ff 18432) as a body of 3 layers without MoE or prefix (3.60 G
#: parameters, 28.8 GB of state with bf16 moments).  One MoE layer alone
#: is 11.3 G parameters, about 90 GB with its gradients and moments: no
#: depth that holds one fits one card.
MLA_TRAIN_LAYERS = 3


def fp32_train_gate(q, k, v, do, tag) -> None:
    """#7, #8 and #9 in fp32 (the FMA bodies) against their plain
    versions: o, dq (rows 1..: causal row 0 is 0 exactly), dk and dv per
    row and lse absolute within TRAIN_FP32_TOL; bitwise repeatable; the
    gate shown to reject the plain results with a tile dropped."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_attention as fa

    o, lse = fa.fused_attention_fwd(q, k, v)
    o_p, lse_p = fa.fused_attention_fwd_plain(q, k, v)
    delta = ref.attention_delta(o_p, do)
    args = (q, k, v, do, lse_p, delta)
    dq = fa.fused_attention_bwd_dq(*args)
    dk, dv = fa.fused_attention_bwd_dkv(*args)
    want_q = fa.fused_attention_bwd_dq_plain(*args)
    want_k, want_v = fa.fused_attention_bwd_dkv_plain(*args)

    def errs(o_, lse_, dq_, dk_, dv_):
        return {"o": row_err(o_, o_p), "dq": row_err(dq_[:, :, 1:],
                                                     want_q[:, :, 1:]),
                "dk": row_err(dk_, want_k), "dv": row_err(dv_, want_v),
                "lse_abs": (lse_ - lse_p).abs().max().item()}

    got = errs(o, lse, dq, dk, dv)
    again = (*fa.fused_attention_fwd(q, k, v),
             fa.fused_attention_bwd_dq(*args),
             *fa.fused_attention_bwd_dkv(*args))
    same = all(torch.equal(a, b) for a, b in zip(again, (o, lse, dq, dk, dv)))
    dropped = errs(*dropped_tile(q, k, v, do, o_p, lse_p, delta, want_q,
                                 want_k, want_v))
    ok = all(e <= TRAIN_FP32_TOL for e in got.values())
    rejected = any(e > TRAIN_FP32_TOL for e in dropped.values())
    log(f"  #7, #8, #9 fp32 [{tag}] per row " + " ".join(
        f"{n}={e:.3e}" for n, e in got.items()) +
        f" (tol {TRAIN_FP32_TOL}) {'ok' if ok else 'FAIL'}; bitwise "
        f"repeatable {same}; plain with a tile dropped " + " ".join(
            f"{n}={e:.3e}" for n, e in dropped.items()) +
        (" rejected, as it must be" if rejected else " PASSED"))
    if not (ok and same and rejected):
        raise SystemExit(f"#7-#9 fp32 gate failed [{tag}]")


def mla_train_kernel_phase(dev, g) -> dict:
    """#7, #8 and #9 at MLA's training shape (MLA_ATTN, the
    ``*_mma_kernel_d192`` instantiations in bf16): as at their main
    shapes by attention_train_records (per row, a dropped tile rejected,
    bitwise repeatable, timed beside SDPA, whose backend is named), then
    in fp32 by fp32_train_gate.  Returns {kernel: {"mla": record}}, each
    with its instantiation's registers and spill."""
    from repro_torch.kernels import build

    b, h, s, d, dv = MLA_ATTN
    tag = f"mla B={b} H={h}/{h} S={s} D={d} Dv={dv} causal"
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    q, k, v, do = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, dv), \
        rnd(b, h, s, dv)
    out = {}
    recs = attention_train_records(*(x.to(torch.bfloat16)
                                     for x in (q, k, v, do)), True, tag)
    for name, r in recs.items():
        sym = build.TENSOR_CORE_BODIES[name][2]
        regs, spill = build.ptxas_usage(build.ptxas_report(name), sym)
        out[name] = {"mla": dict(shape=tag, instantiation=sym,
                                 registers=regs, spill_bytes=spill, **r)}
        log_record(name, out[name]["mla"], tag)
    fp32_train_gate(q, k, v, do, tag)
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


def mla_train_cfg():
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_config(MLA_ARCH),
                               n_layers=MLA_TRAIN_LAYERS,
                               first_dense_layers=0, moe=False)


def mla_train_parity(cfg, dev) -> None:
    """The loss and every gradient leaf of one B=2, seq 2048 batch on the
    kernels against impl forced to the plain versions, at the trained
    config's full width and depth (the plain attention's fp32 S x S
    tensors, 4.3 GB each, fit beside it): loss within PARITY_REL,
    each leaf within KERNEL_TOL of its largest; #7-#9 launched as
    _train_launches predicts, nothing by the plain run."""
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.kernels import build
    from repro_torch.models.weights import init_params
    from repro_torch.train import step as train_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev)
    ds = SyntheticTokenDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_B, seed=0,
                               structured=True)
    batch = {"tokens": torch.from_numpy(ds.batch(0)).long().to(dev)}
    runs = {}
    for impl in ("auto", "torch"):
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = train_step.value_and_grad(params, cfg, batch,
                                                     impl=impl)
        torch.cuda.synchronize()
        runs[impl] = (float(loss), grads, dict(build.LAUNCHES),
                      torch.cuda.max_memory_allocated())
    (l_k, g_k, launches, peak_k), (l_p, g_p, plain_l, peak_p) = \
        runs["auto"], runs["torch"]
    log(f"mla train parity: B={TRAIN_B} seq {TRAIN_SEQ}, {cfg.n_layers} "
        f"layers at full width, bf16; launches on the kernels {launches}, "
        f"on the plain versions {plain_l or 'none'}; peak "
        f"{peak_k / 1e9:.3f} GB (kernels), {peak_p / 1e9:.3f} GB (plain)")
    if {n: launches.get(n, 0) for n in TRAIN_KERNELS} != \
            _train_launches(cfg) or plain_l:
        raise SystemExit(f"mla train parity: launches {launches}, plain "
                         f"{plain_l}")
    n = check_grads_nonzero(g_k, "mla train parity")
    worst = ("none", -1.0)
    for (name, a), (_, b) in zip(_grad_leaves(g_k), _grad_leaves(g_p)):
        worst = max(worst, (name, rel_err(a, b)[1]), key=lambda w: w[1])
    ok = abs(l_k - l_p) <= PARITY_REL * abs(l_p) and worst[1] <= KERNEL_TOL
    log(f"  loss {l_k:.6f} vs plain {l_p:.6f} (tol rel {PARITY_REL}); {n} "
        f"gradient leaves, worst {worst[0]} rel {worst[1]:.4e} (tol "
        f"{KERNEL_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("mla train parity: loss or gradients disagree")
    del params, runs, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()


def mla_train_phase(dev):
    """deepseek-v3's dense layers at full width (mla_train_cfg), every
    earlier phase's weights freed first: the parity of the kernels
    against the plain versions (mla_train_parity), then short_train.
    Returns the launches of the 3 steps."""
    cfg = mla_train_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mla train: {cfg.name} d_model={cfg.d_model}, {cfg.n_heads} heads "
        f"(D {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, Dv "
        f"{cfg.v_head_dim}), d_ff {cfg.d_ff}, its dense layers as a body of "
        f"{cfg.n_layers} without MoE, remat {cfg.remat}, bf16 params and "
        f"moments, B={TRAIN_B} seq {TRAIN_SEQ} lr {TRAIN_LR}, 3 steps; "
        f"device memory allocated before "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB | {card_line()}")
    mla_train_parity(cfg, dev)
    return short_train(cfg, "mla train", dev)


# ---------------------------------------------------------------------------
# Mamba-2 training, and jamba: the attention/Mamba-2 hybrid served
# ---------------------------------------------------------------------------

#: mamba2-130m's training batch: 8 rows of 2048 tokens (B=2 would leave a
#: 130 M-parameter step to the launch rate)
MAMBA_TRAIN_B = 8
#: mamba2-130m's depth in the training phase: 6 of its 24 layers, which
#: cuts the profiled step's ~50k launches a step and the host time of
#: their processing, to pay for the roofline phase (24 -> 12) and the
#: mesh phase's (l) and (m) (12 -> 6)
MAMBA_TRAIN_LAYERS = 6


def mamba_train_phase(dev):
    """``short_train`` on mamba2-130m at full width, MAMBA_TRAIN_LAYERS of
    its 24 layers (remat full, bf16 moments, B=MAMBA_TRAIN_B, seq 2048,
    3 steps).  Under
    autograd ``ops.ssd`` takes the plain scan (#11 has no backward): no
    ssd_scan launch in a step, ("ssd", "torch") calls counted.  Returns
    the launches of the 3 steps."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(configs.get_config("mamba2-130m"),
                              n_layers=MAMBA_TRAIN_LAYERS)
    log(f"mamba train: {cfg.name} {cfg.n_layers} layers d_model="
        f"{cfg.d_model}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}; remat {cfg.remat}, bf16 params and moments, "
        f"B={MAMBA_TRAIN_B} seq {TRAIN_SEQ} lr {TRAIN_LR}, 3 steps; "
        f"| {card_line()}")
    # the scan's products run in the forward, the recompute and twice in
    # the backward, 2 FLOP a multiply-add
    scan = 4 * 2 * MAMBA_TRAIN_B * TRAIN_SEQ * cfg.n_layers * scan_macs(cfg)
    proj = train_gemm_flops(cfg, MAMBA_TRAIN_B) - scan
    floor = proj / PEAK_BF16 + scan / PEAK_FP32
    log(f"  operations floor of a step {floor * 1e3:.3f} ms: the "
        f"projections and LM head {proj / 1e12:.3f} TFLOP at the bf16 "
        f"peak, the plain scan's products {scan / 1e12:.3f} TFLOP in fp32 "
        f"at {PEAK_FP32 / 1e12:.0f} TFLOP/s (CUDA cores; tf32 is off)")
    ops.reset_counts()
    launches = short_train(cfg, "mamba train", dev, batch=MAMBA_TRAIN_B)
    calls = {f"{e}/{i}": n for (e, i), n in sorted(ops.CALLS.items())}
    log(f"  mamba train: ops calls {calls}; ssd_scan launches over the 3 "
        f"steps {launches['ssd_scan']}")
    if not ops.CALLS[("ssd", "torch")] or ops.CALLS[("ssd", "cuda")] \
            or launches["ssd_scan"]:
        raise SystemExit("mamba train: the scan did not run on the plain "
                         "version alone")
    return launches


JAMBA_ARCH = "jamba-1.5-large-398b"
#: the served cut: one full-width period (8 layers: attention at offset
#: 3, seven Mamba-2 layers) with dense FFNs.  With its four 16-expert
#: MoE layers the period is 90.49 GB of bf16 weights, more than the card
#: holds; phi3.5-moe holds the MoE FFN at full width.
JAMBA_LAYERS = 8
#: jamba's Mamba-2 heads (256 of 64, 8 groups, state 128) and attention
#: heads (64 query heads over 8 KV heads of 128)
JAMBA_SSD = dict(H=256, P=64, G=8, S=128, CHUNK=128)
JAMBA_ATTN = dict(HQ=64, HKV=8, D=128)
#: gate (b)'s limit, relative to the largest |logit|: the one period in
#: fp32 compute on the kernels against the plain versions
JAMBA_FP32_TOL = 1e-4


def jamba_cfg():
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_config(JAMBA_ARCH),
                               n_layers=JAMBA_LAYERS, moe=False)


def jamba_kernel_phase(dev, g) -> dict:
    """#11 and #1 at jamba's served shapes, held as at their main shapes:
    #11 on a prefill chunk (B=1, L=256, with h0: 256 heads of 64 in 8
    groups, state 128) in bf16 and fp32, per row, bitwise repeatable,
    the gate shown to reject a dropped incoming state at long-memory
    inputs, timed beside the unfused yardstick; #1 (64 query heads over
    8 of 128) on a second prefill chunk (B=1, Sq=256 at C=512 in a
    1024-row cache: per row, bitwise repeatable, a dropped key tile
    rejected) and at decode (B=4, M=1, contexts PAGED_LENS: per row,
    bitwise repeatable), each timed beside SDPA.  Returns {kernel:
    {"jamba..." : record}}."""
    from repro_torch.kernels.fused_attention import \
        fused_attention_masked_plain

    out = collections.defaultdict(dict)
    timed = ssd_records(dev, g, JAMBA_SSD, (
        ("jamba chunk", 1, 256, True, 1.0),
        ("jamba chunk, long memory", 1, 256, True, SSD_LONG_DT)))
    tag = "jamba B=1 L=256 h0 H=256 P=64 G=8 S=128 chunk 128"
    out["ssd_scan"]["jamba"] = dict(shape=tag, **timed["jamba chunk"])

    bf = torch.bfloat16
    HQ, HKV, D = (JAMBA_ATTN[k] for k in ("HQ", "HKV", "D"))
    skv = 1024

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    sq, total = 256, 512
    q, k, v = rnd(1, HQ, sq, D), rnd(1, HKV, skv, D), rnd(1, HKV, skv, D)
    lens = torch.tensor([total], dtype=torch.int32, device=dev)
    tag = f"jamba B=1 Sq={sq} C={total} Hq={HQ}/{HKV} D={D}"
    out["fused_attention_masked"]["jamba_prefill"] = dict(
        shape=tag, **masked_attention_record(
            q, k, v, lens, tag,
            lambda o, want, run: masked_gates(
                "fused_attention_masked", tag, o, want, run, total,
                lambda rows, end: fused_attention_masked_plain(
                    q[:, :, rows:].contiguous(), k, v,
                    torch.tensor([end], dtype=torch.int32, device=dev),
                    causal=False))))
    b = len(PAGED_LENS)
    q, k, v = rnd(b, HQ, 1, D), rnd(b, HKV, skv, D), rnd(b, HKV, skv, D)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    tag = f"jamba B={b} M=1 lengths={PAGED_LENS} Hq={HQ}/{HKV} D={D}"

    def decode_gates(o, want, run):
        if not torch.equal(run(), o):
            raise SystemExit(f"fused_attention_masked [{tag}] is not "
                             f"deterministic")
        log(f"  fused_attention_masked [{tag}] bitwise repeatable")
        row_gate("fused_attention_masked", tag, {"o": (o, want)})

    out["fused_attention_masked"]["jamba_decode"] = dict(
        shape=tag, **masked_attention_record(q, k, v, lens, tag,
                                             decode_gates))
    for name, shapes in out.items():
        for r in shapes.values():
            log_record(name, r, r["shape"])
    del q, k, v
    torch.cuda.empty_cache()
    return dict(out)


def _attention_calls_side_by_side(ops, worst):
    """An ``ops.attention`` that, on each cached call (one with lengths),
    also runs #1 and its plain version on the call's inputs, appending
    (rows, the kernel's error relative to the plain output's largest
    magnitude) to ``worst``; the comparison's launches are taken back
    out of the counts, and the call itself runs as it was asked.
    Returns (the original, the wrapper)."""
    from repro_torch.kernels import build
    orig = ops.attention

    def both(q, k, v, **kw):
        if kw.get("lengths") is not None and kw.get("block_tables") is None:
            saved = collections.Counter(build.LAUNCHES)
            got, want = (orig(q, k, v, **dict(kw, impl=impl, plan=None))
                         for impl in ("cuda", "torch"))
            build.LAUNCHES.clear()
            build.LAUNCHES.update(saved)
            worst.append((q.shape[2], rel_err(got, want)[1]))
        return orig(q, k, v, **kw)
    return orig, both


def jamba_serve_phase(dev):
    """One full-width period of jamba (jamba_cfg: 9.008 G parameters,
    18.02 GB in bf16), random weights from seed 0, every earlier phase's
    weights freed first: the serve mix through launch/serve.run (no
    serving plan: the Mamba layers' prefill chunks on #11, the attention
    layer on the shape-only plan at the cache's max_len, #1 for decode
    and the chunks it fuses), the median decode step against the bytes
    floor, tok/s and peak memory; gate (a): one request on the plain
    versions with each layer's #11 and #1 run beside them on the same
    inputs (KERNEL_TOL); gate (b): that request with the compute in fp32,
    the kernels against the plain versions (JAMBA_FP32_TOL); then a
    steady B=4 decode window, profiled.  Returns the serve's launches."""
    import dataclasses

    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models.weights import init_params
    from repro_torch.serve.engine import ContinuousBatchingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = jamba_cfg()
    args = serve.parser().parse_args([
        "--arch", JAMBA_ARCH, "--batch", "4", "--requests", "6",
        "--max-len", "1024", "--max-new", "16", "--prefill-chunk", "256",
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    all_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    wbytes = all_bytes - params["embed"].numel() * \
        params["embed"].element_size()
    floor_ms = wbytes / PEAK_BYTES * 1e3
    mamba = [i for i in range(cfg.n_layers) if cfg.block_kind(i) == "mamba"]
    log(f"jamba serve: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} query heads over {cfg.kv_heads} of {cfg.head_dim}; "
        f"Mamba-2 {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, G "
        f"{cfg.ssm_groups}, state {cfg.ssm_state}; d_ff {cfg.d_ff}) cut to "
        f"one period of {cfg.n_layers} layers (attention at {cfg.attn_offset},"
        f" Mamba-2 at {mamba}), dense FFNs (moe=False); {n_params} "
        f"parameters, {all_bytes / 1e9:.3f} GB bf16, random (seed 0), in "
        f"{time.time() - t0:.1f}s (init peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB); | {card_line()}")
    log(f"  weights read per decode step (the embedding table aside) "
        f"{wbytes / 1e9:.3f} GB: floor {floor_ms:.3f} ms at "
        f"{PEAK_BYTES / 1e12} TB/s; all weights {all_bytes / 1e9:.3f} GB: "
        f"{all_bytes / PEAK_BYTES * 1e3:.3f} ms")
    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    lens = [len(r.prompt) for r in requests]
    chunks = sum(sum(1 for st in range(0, n, args.prefill_chunk)
                     if n - st > 1) for n in lens)
    predicted = len(mamba) * chunks
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    out = serve.run(args, cfg, params, requests)
    launches = collections.Counter(build.LAUNCHES)
    calls = {f"{e}/{i}": n for (e, i), n in sorted(ops.CALLS.items())}
    finished, secs = out["finished"], out["seconds"]
    gen = sum(len(r.generated) for r in finished)
    steps = out["decode_step_s"]
    step_ms = statistics.median(steps) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"  served {len(finished)}/{len(requests)} requests (prompts {lens},"
        f" chunk {args.prefill_chunk}), {gen} tokens in {secs:.3f}s = "
        f"{gen / secs:.2f} tok/s; decode steps {len(steps)}, median step "
        f"{step_ms:.3f} ms against the {floor_ms:.3f} ms floor; peak memory "
        f"{peak / 1e9:.3f} GB")
    log(f"  launches {dict(launches)} (ssd_scan predicted {predicted}: "
        f"{len(mamba)} Mamba layers x {chunks} multi-token chunks); calls "
        f"by impl {calls}")
    if out["plan"] is not None:
        raise SystemExit("jamba serve: a serving plan for the hybrid")
    if len(finished) != len(requests) or any(
            len(r.generated) != args.max_new for r in finished):
        raise SystemExit("jamba serve: not every request finished")
    if launches["ssd_scan"] != predicted \
            or not launches["fused_attention_masked"] \
            or set(+launches) != {"ssd_scan", "fused_attention_masked"}:
        raise SystemExit(f"jamba serve: launches {dict(launches)}, "
                         f"ssd_scan predicted {predicted}")
    del out, finished

    # gate (a): one request on the plain versions, each layer's #11 and
    # #1 beside them on the same inputs
    prompt = requests[1].prompt
    ssd_worst, attn_worst = [], []
    orig_ssd, both_ssd = _ssd_side_by_side(ops, ssd_worst)
    orig_attn, both_attn = _attention_calls_side_by_side(ops, attn_worst)

    def one(c, impl, forced=None, side=False):
        eng = ContinuousBatchingEngine(
            params, c, batch_size=1, max_len=args.max_len,
            dtype=c.torch_dtype(), prefill_chunk=args.prefill_chunk,
            device=dev, impl=impl)
        if side:
            ops.ssd, ops.attention = both_ssd, both_attn
        try:
            ops.reset_counts()
            return _one_request_logits(eng, prompt, forced) + (
                dict(build.LAUNCHES),)
        finally:
            ops.ssd, ops.attention = orig_ssd, orig_attn

    k_logits, toks, _ = one(cfg, "auto")
    p_logits, _, _ = one(cfg, "torch", toks, side=True)
    for i, (a, b) in enumerate(zip(k_logits, p_logits)):
        err, rel = rel_err(a, b)
        log(f"  bf16 step {i}: kernels against plain versions max_abs_err="
            f"{err:.4e} rel={rel:.4e}, argmax "
            f"{'same' if int(a.argmax()) == int(b.argmax()) else 'FLIPPED'}")
    n_chunks = sum(1 for st in range(0, len(prompt), args.prefill_chunk)
                   if len(prompt) - st > 1)
    by_rows = collections.defaultdict(list)
    for rows, rel in attn_worst:
        by_rows["decode" if rows == 1 else "chunk"].append(rel)
    log(f"  gate (a), prompt {len(prompt)} tokens: each Mamba layer's "
        f"ssd_scan against the plain version on its inputs: worst rel "
        f"{max(ssd_worst):.4e} over {len(ssd_worst)} calls; the attention "
        f"layer's #1: " + ", ".join(
            f"{k} {len(v)} calls worst rel {max(v):.4e}"
            for k, v in sorted(by_rows.items())) + f" (tol {KERNEL_TOL})")
    if len(ssd_worst) != len(mamba) * n_chunks \
            or len(attn_worst) != len(range(0, len(prompt),
                                            args.prefill_chunk)) \
            + DECODE_COMPARED \
            or max(ssd_worst + [r for _, r in attn_worst]) > KERNEL_TOL:
        raise SystemExit("jamba gate (a): a kernel disagrees with its plain "
                         "version, or a call was not compared")

    # gate (b): the compute in fp32, kernels against plain versions
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    k32, toks32, k_l = one(cfg32, "auto")
    p32, _, p_l = one(cfg32, "torch", toks32)
    worst32 = compare_logits("jamba fp32", k32, p32, tol=JAMBA_FP32_TOL)
    log(f"  gate (b): {cfg.n_layers} layers, fp32 compute, prompt "
        f"{len(prompt)} tokens, prefill + {DECODE_COMPARED} decode steps: "
        f"worst rel {worst32:.4e} (tol {JAMBA_FP32_TOL}); launches {k_l}, on "
        f"the plain versions {p_l}")
    if not k_l.get("ssd_scan") or not k_l.get("fused_attention_masked") \
            or any(p_l.values()):
        raise SystemExit(f"jamba gate (b): kernels never launched in fp32 "
                         f"{k_l}, or the plain run launched {p_l}")
    decode_window(args, cfg, params, requests, floor_ms, label="jamba")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: the mesh phase: two gloo ranks sharing cuda:0
MESH_RANKS = 2
#: (a)/(b)'s depth: cut from 4 layers to 2 to keep the call's time with
#: (h)-(j) added (its gates unchanged)
MESH_LAYERS = 2
#: (g)'s depth: phi3.5-moe served on the sharded serving state
MESH_MOE_LAYERS = 2
MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 1024, 3
#: the training sub-phases' archs; (f)'s steps
MESH_ARCHS = {"d": "starcoder2-7b", "f": "phi3.5-moe-42b-a6.6b",
              "l": MLA_ARCH, "m": "mamba2-130m"}
#: each training sub-phase's depth: (f) cut from 2 layers to 1 to keep
#: the call's time with (g) added, (d) (and (k), which trains its config)
#: from 2 to 1 with (h)-(j) added (their gates unchanged); (l) deepseek-v3's
#: MLA training config (no MoE, no dense prefix) at 1 layer, (m)
#: mamba2-130m at 4 of its 24
MESH_DEPTH = {"d": 1, "f": 1, "l": 1, "m": 4}
MESH_MOE_STEPS = 2
#: the mesh phase's serve mix: prompts past C = 2N = 256, 16 new tokens
MESH_REQUESTS, MESH_MAX_NEW = 4, 16
#: the mesh of 2 ranks against the mesh of 1: logits per step within
#: this of the largest |logit| (fp32 partial sums in another order)
MESH_TOL = 1e-3
#: the FSDP losses against the single-rank run of the global batch (bf16)
MESH_TRAIN_REL = 2e-2
#: (f)'s step-0 load-balance loss against the single rank's: both read
#: the same weights and the global batch's means, so they differ only by
#: fp32 sums in another order (per-rank means would be about 1e-2 off)
MESH_LB_REL = 1e-4
MOE_MESH = dict(B=2, S=256)


def _mesh_serve(cfg, params, args, dev, ctx) -> dict:
    """The mesh phase's requests (made anew) through a RequestBatcher on
    a ContinuousBatchingEngine made under ``ctx`` (a mesh or a null
    context): tokens by request, the logits that sampled each token,
    the kernels launched, the calls by impl and the bytes the engine
    holds of parameters and caches (its blocks under a sharded
    serve); for a MoE config each router call's top-(k+1) probabilities
    and top-k ids, in call order ("routes")."""
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.batcher import RequestBatcher
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          make_serving_plan)
    from repro_torch.sharding.fsdp import held_bytes

    requests = serve.make_requests(cfg, args.requests, args.max_new,
                                   prompt_lens=PROMPT_LENS)
    plan = make_serving_plan(cfg, max_len=args.max_len, device=dev)
    batcher = RequestBatcher(args.batch, max_len=args.max_len)
    store = {}
    for req in requests:
        batcher.submit(req)
    from repro_torch.models import moe as moe_mod

    routes, route = [], moe_mod.route

    def recorded_route(router, x, k, *a):
        out = route(router, x, k, *a)
        top = torch.sort(out[1], dim=-1, descending=True).values
        routes.append((top[..., :k + 1].cpu(),
                       torch.sort(out[3], dim=-1).values.cpu()))
        return out

    build.reset_launches()
    ops.reset_counts()
    t0 = time.perf_counter()
    if cfg.moe:
        moe_mod.route = recorded_route
    try:
        with ctx:
            eng = ContinuousBatchingEngine(
                params, cfg, batch_size=args.batch, max_len=args.max_len,
                plan=plan, dtype=cfg.torch_dtype(),
                prefill_chunk=args.prefill_chunk, device=dev)
            _recorded(eng, batcher, store)
            done = batcher.serve(eng, max_steps=64 * len(requests))
    finally:
        moe_mod.route = route
    torch.cuda.synchronize()
    return {"tokens": {r.uid: r.generated for r in done}, "logits": store,
            "routes": routes,
            "launches": dict(build.LAUNCHES), "calls": dict(ops.CALLS),
            "seconds": time.perf_counter() - t0, "plan": plan,
            "held": {"params": held_bytes(eng.params),
                     "caches": held_bytes(eng.state)}}


def _prefix_logits(got, want) -> tuple:
    """``got``'s serve against ``want``'s, request by request: every
    request finishes its budget with finite logits.  Returns (the
    requests whose streams differ, the worst relative error of the
    logits that sampled each request's tokens before its first
    differing one, the number of those steps)."""
    differ, worst, steps = 0, 0.0, 0
    for uid, want_toks in sorted(want["tokens"].items()):
        toks = got["tokens"].get(uid)
        if toks is None or len(toks) != MESH_MAX_NEW:
            raise SystemExit(f"request {uid} did not finish its budget "
                             f"({toks})")
        first = next((j for j, (a, b) in enumerate(zip(toks, want_toks))
                      if a != b), len(toks))
        differ += first < len(toks)
        for j in range(len(toks)):
            if not torch.isfinite(got["logits"][(uid, j)]).all():
                raise SystemExit(f"request {uid}: non-finite logits")
        for j in range(first):
            worst = max(worst, rel_err(got["logits"][(uid, j)],
                                       want["logits"][(uid, j)])[1])
            steps += 1
    return differ, worst, steps


def _mesh_gate(phase, two, one, alone, rank) -> None:
    """In bf16: the mesh of 2 ranks against the mesh of 1 and against
    the mesh-less engine, each request's logits before its first
    differing token within LOGIT_TOL, and that token through tie_check
    (the partial sums' order moves bf16 roundings through the layers,
    so a stream may part at an argmax near-tie; past it the two serves
    read other contexts)."""
    for name, want in (("1 rank", one), ("the mesh-less engine", alone)):
        if want is None:
            continue
        differ = tie_check(f"mesh {phase}", two, want, MESH_MAX_NEW)
        _, worst, steps = _prefix_logits(two, want)
        log(f"  [rank {rank}] {phase}: 2 ranks against {name}: {differ} of "
            f"{len(want['tokens'])} requests differ (argmax ties only); "
            f"{steps} steps' logits before each first difference, worst "
            f"rel {worst:.3e} (tol {LOGIT_TOL})")
        if worst > LOGIT_TOL:
            raise SystemExit(f"mesh {phase}: 2 ranks' logits off {name}'s")


def _moe_mesh_report(phase, two, one, alone, rank) -> None:
    """An MoE serve in bf16, the mesh of 2 ranks against the mesh of 1
    and against the mesh-less engine, and the mesh of 1 rank against the
    mesh-less engine: every request finishes its budget with finite
    logits, and each request's logits before its first differing token
    are reported.  The streams part, the 1-rank serve from the mesh-less
    one too: a bf16 rounding moves a router near-tie and the token takes
    another expert.  So where the 2-rank streams part, the first router
    call that picks other experts (:func:`_first_reroute`) must do so
    only at tokens whose top-k margin in the other serve is within
    MOE_ROUTE_MARGIN; where no call reroutes, the dense rule of
    :func:`_mesh_gate` holds.  Each MoE layer alone is gated on the
    same inputs (:func:`_moe_layer_gate`), and the streams in fp32
    (:func:`_mesh_gate32`)."""
    pairs = (("2 ranks", two, "1 rank", one),
             ("2 ranks", two, "the mesh-less engine", alone),
             ("1 rank", one, "the mesh-less engine", alone))
    for label, got, name, want in pairs:
        if want is None:
            continue
        differ, worst, steps = _prefix_logits(got, want)
        text, margin = _first_reroute(got["routes"], want["routes"])
        log(f"  [rank {rank}] {phase} bf16: {label} against {name}: "
            f"{differ} of {len(want['tokens'])} requests differ; {steps} "
            f"steps' logits before each first difference, worst rel "
            f"{worst:.3e}; {text}")
        if label != "2 ranks":
            continue
        if margin is None:
            tie_check(f"mesh {phase}", got, want, MESH_MAX_NEW)
            if worst > LOGIT_TOL:
                raise SystemExit(f"mesh {phase}: 2 ranks' logits off "
                                 f"{name}'s with no token rerouted")
        elif margin > MOE_ROUTE_MARGIN:
            raise SystemExit(f"mesh {phase}: the 2-rank serve first "
                             f"reroutes a token whose top-k margin is "
                             f"{margin:.3e}, over {MOE_ROUTE_MARGIN:.3e}")


def _first_reroute(got, want) -> tuple:
    """Where two serves' router calls (``_mesh_serve``'s "routes", in
    call order) first pick other top-k ids: (a line naming the call,
    its tokens that differ and their top-k margins (the k-th less the
    (k+1)-th probability) in both serves beside the call's least and
    median margin in ``want``; the largest of those tokens' margins in
    ``want``, or None where no call reroutes)."""
    for i, ((gp, gi), (wp, wi)) in enumerate(zip(got, want)):
        if gi.shape != wi.shape:
            raise SystemExit(f"router call {i} has another shape")
        differ = (gi != wi).any(-1)
        if differ.any():
            k = gi.shape[-1]
            gm = (gp[..., k - 1] - gp[..., k])[differ]
            wm = wp[..., k - 1] - wp[..., k]
            margin = wm[differ].max().item()
            return (f"first rerouted at router call {i} of {len(want)} "
                    f"({tuple(gi.shape[:-1])} tokens): "
                    f"{int(differ.sum())} tokens, top-k margins "
                    f"{margin:.3e} at most in the second serve (tol "
                    f"{MOE_ROUTE_MARGIN:.3e}), {gm.max().item():.3e} in "
                    f"the first; the call's least margin "
                    f"{wm.min().item():.3e}, median "
                    f"{wm.median().item():.3e}", margin)
    return f"no router call of {len(want)} reroutes", None


#: (g)'s MoE layers alone in bf16: the inputs, (B, S) a prefill chunk
#: and a decode batch, drawn from these seeds on every rank
MOE_LAYER_INPUTS = (((1, 256), 11), ((4, 1), 12))
#: the router's top-k may differ from the whole layer's only where the
#: whole layer's k-th and (k+1)-th probabilities lie within this (2^-7,
#: bf16's epsilon; the two compute the router's fp32 logits over other
#: column blocks, so they differ by fp32 roundings, far below it)
MOE_ROUTE_MARGIN = 2.0 ** -7


def _moe_layer_inputs(cfg, dev) -> list:
    """MOE_LAYER_INPUTS' bf16 inputs of a MoE layer (the same on every
    rank)."""
    out = []
    for (b, s), seed in MOE_LAYER_INPUTS:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        out.append(torch.randn(b, s, cfg.d_model, generator=g, device=dev)
                   .to(torch.bfloat16))
    return out


def _moe_layers(cfg, params, dev, specs=None) -> list:
    """Each MoE layer of ``params`` on ``_moe_layer_inputs``: (probs,
    top-k ids, y) on the host, in bf16 compute; ``specs``: the layers'
    serving specs (``params`` the rank's blocks, under a mesh)."""
    from repro_torch import tree
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.rules import active_mesh, splits

    ls = None if specs is None else tf._unstack(specs["layers"][0])["moe"]
    split = splits(ls and ls["router"], -1, active_mesh())
    out = []
    for j in range(cfg.n_periods):
        lp = tree.map(lambda t: t[j], params["layers"][0]["moe"])
        for x in _moe_layer_inputs(cfg, dev):
            _, probs, _, topi = moe_mod.route(lp["router"], x, cfg.top_k,
                                              split)
            y, _ = moe_mod.moe_forward(lp, cfg, x, aux=False, specs=ls)
            out.append((probs.cpu(), topi.cpu(), y.float().cpu()))
    return out


def _moe_layer_gate(phase, got, want, rank) -> None:
    """(g)'s MoE layers alone in bf16, the rank's blocks against the
    whole layer with no mesh on the same inputs: the top-k ids equal
    wherever the whole layer's k-th and (k+1)-th probabilities are more
    than MOE_ROUTE_MARGIN apart, and each output row within ROW_TOL of
    the whole layer's in every routing group whose ids are all equal
    (a rerouted token moves its group's capacity)."""
    flips, near, worst, rows = 0, float("inf"), 0.0, 0
    for (_, topi, y), (probs, want_i, want_y) in zip(got, want):
        k = want_i.shape[-1]
        top = torch.sort(probs, dim=-1, descending=True).values
        margin = top[..., k - 1] - top[..., k]
        differ = (torch.sort(topi, -1).values
                  != torch.sort(want_i, -1).values).any(-1)
        if differ.any():
            flips += int(differ.sum())
            near = min(near, float(margin[differ].min()))
            if float(margin[differ].max()) > MOE_ROUTE_MARGIN:
                raise SystemExit(f"mesh {phase}: rank {rank} routes a token "
                                 "with a top-k margin of "
                                 f"{float(margin[differ].max()):.3e} "
                                 "otherwise than the whole layer")
        same = ~differ.any(-1)                 # groups: the batch rows
        if same.any():
            worst = max(worst, row_err(y[same], want_y[same]))
            rows += int(same.sum()) * y.shape[1]
    log(f"  [rank {rank}] {phase} bf16 MoE layers alone "
        f"({len(got) // len(MOE_LAYER_INPUTS)} layers, a chunk of 256 and "
        f"a decode batch of 4): against the whole layer "
        f"with no mesh, {flips} tokens rerouted (margin tol "
        f"{MOE_ROUTE_MARGIN:.3e}; the least rerouted margin "
        f"{near:.3e}), {rows} rows per row worst {worst:.3e} (tol "
        f"{ROW_TOL})")
    if worst > ROW_TOL or not rows:
        raise SystemExit(f"mesh {phase}: rank {rank}'s MoE layers in bf16 "
                         "off the whole layer's")


def _mesh_gate32(phase, two, one, rank, against: str = "1 rank") -> None:
    """In fp32 compute: the mesh of 2 ranks against ``one`` (the mesh of
    1 rank, or ``against``), tokens equal and every step's logits within
    MESH_TOL of the largest."""
    if two["tokens"] != one["tokens"]:
        raise SystemExit(f"mesh {phase}: the tokens of 2 ranks differ "
                         f"from {against}'s: {two['tokens']} "
                         f"{one['tokens']}")
    worst = max((two["logits"][key] - want).abs().max().item()
                / want.abs().max().item()
                for key, want in one["logits"].items())
    log(f"  [rank {rank}] {phase} fp32: 2 ranks against {against}, tokens "
        f"equal, logits of {len(one['logits'])} steps worst {worst:.3e} of "
        f"the largest (tol {MESH_TOL})")
    if worst > MESH_TOL:
        raise SystemExit(f"mesh {phase}: 2 ranks disagree with {against} "
                         "in fp32")


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _mesh_sub(name, rank, stats, fn, *a, **kw):
    """``fn(*a, **kw)`` timed, with this rank's peak memory, into
    ``stats``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    stats[name] = (time.perf_counter() - t0, _peak_gb())
    log(f"  [rank {rank}] mesh ({name}): {stats[name][0]:.1f}s, peak "
        f"{stats[name][1]:.2f} GB")
    return out


#: #11's per-head gate: a head row's error over the larger of its own
#: largest |value| and this share of its token row's (every head's):
#: on a served model's inputs a bf16 head row can cancel to a small
#: fraction of its terms, where both versions' roundings reach 4e-2 of
#: it (jamba's period on an H100), while a wrong head of any size above
#: the floor still fails
HEAD_FLOOR = 0.1


def head_err(got, want) -> float:
    """(..., H, W) rows, W a head's values: the largest, over the head
    rows, of a row's max |got - want| over the larger of its max |want|
    and HEAD_FLOOR times the max |want| over its H heads."""
    got, want = got.float(), want.float()
    head = want.abs().amax(-1)
    scale = torch.maximum(head, HEAD_FLOOR * head.amax(-1, keepdim=True))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return ((got - want).abs().amax(-1) / scale).max().item()


@contextlib.contextmanager
def _kernel_rows(rows, dropped):
    """Each ``ops`` call of a sharded serve that launches #1, #2 or #11
    (``build.LAUNCHES`` before and after) also runs its plain version on
    the same inputs: (name, heads, rows, error) appended to ``rows``,
    the error per row for #1 and #2 (:func:`row_err`) and per head row
    of y and of the final state for #11 (:func:`head_err`).  The first
    launch of #1 or #2 with a row past 64 keys also runs the plain
    version with that row's last 64 keys dropped, the first of #11 with
    a nonzero incoming state runs it without the state, and
    ``dropped[name]`` gets that result's error, which the gate must
    reject.  The plain versions launch nothing, so the counts are the
    run's."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    orig = ops.attention, ops.qproj_attention, ops.ssd

    def masked(name, fn, plain_fn, heads, n, **extra):
        def call(*a, **kw):
            before = build.LAUNCHES[name]
            out = fn(*a, **kw)
            if build.LAUNCHES[name] > before:
                lengths = kw["lengths"].to(torch.int32)

                def plain(ln):
                    return plain_fn(*a, ln, causal=kw.get("causal", True),
                                    scale=kw.get("scale"),
                                    **{k: kw.get(k) for k in extra})
                rows.append((name, heads(*a), n(*a),
                             row_err(out, plain(lengths))))
                past = lengths > 64
                if name not in dropped and bool(past.any()):
                    cut = torch.where(past, lengths - 64, lengths)
                    dropped[name] = row_err(out[past], plain(cut)[past])
            return out
        return call

    def ssd(x, dt, a, b, c, d=None, **kw):
        before = build.LAUNCHES["ssd_scan"]
        out = orig[2](x, dt, a, b, c, d, **kw)
        if build.LAUNCHES["ssd_scan"] > before:
            h0 = kw.get("h0")

            def plain(state):
                return ssd_mod.ssd_scan_plain(
                    x, dt, a, b, c, d, chunk=kw["chunk"], h0=state,
                    return_final_state=True)
            got = out if isinstance(out, tuple) else (out,)
            # y (B, L, H, P) and the final state (B, H, P, S) as
            # (..., H, W) head rows
            views = (lambda t: t, lambda t: t.flatten(-2).unsqueeze(1))
            rows.append(("ssd_scan", x.shape[2], x.shape[1], max(
                head_err(v(g_), v(w_))
                for v, g_, w_ in zip(views, got, plain(h0)))))
            if "ssd_scan" not in dropped and h0 is not None \
                    and bool(h0.abs().max() > 0):
                dropped["ssd_scan"] = head_err(got[0], plain(None)[0])
        return out

    ops.attention = masked("fused_attention_masked", orig[0],
                           ops.fused_attention_masked_plain,
                           lambda q, *_: q.shape[1],
                           lambda q, *_: q.shape[2])
    ops.qproj_attention = masked("fused_qproj_attention_masked", orig[1],
                                 ops.fused_qproj_attention_masked_plain,
                                 lambda x, wq, *_: wq.shape[1],
                                 lambda x, *_: x.shape[1], rope_theta=True)
    ops.ssd = ssd
    try:
        yield rows
    finally:
        ops.attention, ops.qproj_attention, ops.ssd = orig


def _rows_gate(phase, rank, rows, dropped, want) -> None:
    """Every launch of the kernels ``want`` in a sharded serve within
    ROW_TOL of its plain version (:func:`_kernel_rows`' rows), each
    launched, and each dropped-input plain result rejected by the same
    gate."""
    by = collections.defaultdict(list)
    for name, heads, n, err in rows:
        by[(name, heads)].append(err)
    for (name, heads), errs in sorted(by.items()):
        log(f"  [rank {rank}] {phase}: {name} over {heads} heads, "
            f"{len(errs)} launches, worst {max(errs):.3e} (tol {ROW_TOL}); "
            f"against the plain version with "
            f"{'h0' if name == 'ssd_scan' else 'a key tile'} dropped "
            f"{dropped.get(name, float('nan')):.3e} (must exceed it)")
    names = {k[0] for k in by}
    if set(want) - names or any(e > ROW_TOL for *_, e in rows) \
            or any(not dropped.get(n, 0.0) > ROW_TOL for n in want):
        raise SystemExit(f"mesh {phase}: rank {rank}'s {list(want)} "
                         "launches missing, off their plain versions, or "
                         "the gate passes a dropped input")


def _draw(cfg, dev, layout=None):
    """Seed 0's weights of ``cfg``: whole, or this rank's blocks on
    ``layout``, the ranks in turn (a draw holds one whole leaf in fp32
    for a moment, deepseek-v3's experts 15 GB, which two at once
    overflow)."""
    import torch.distributed as dist

    from repro_torch.models.weights import init_params

    def draw():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return init_params(cfg, g, dev) if layout is None \
            else layout.init(cfg, g, dev)
    if layout is None:
        return draw()
    for turn in range(MESH_RANKS):
        if dist.get_rank() == turn:
            blocks = draw()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return blocks


def _sharded_serves(rank, dev, stats, base, runs, want, *, chunk=256,
                    bf16_gate=True, fp32=()) -> dict:
    """``base`` (a config at full width) served on 2 ranks with the
    sharded serving state, B=4, max_len 1024, prefill chunk ``chunk``:
    each ``(tag, sub, flags)`` of ``runs`` on the blocks of seed 0's
    draws (:func:`_draw`), held to the dry-run's per-device bytes, every
    launch of #1, #2 and #11 to its plain version and the kernels
    ``want`` launched (:func:`_rows_gate`).  Rank 0 first serves the mix
    with the whole weights on the mesh-less engine and on a mesh of 1
    rank (the replicated figure), and the 2-rank bf16 serves are gated
    against both (an MoE config as :func:`_moe_mesh_report` says, with
    its MoE layers alone; else :func:`_mesh_gate`; ``bf16_gate`` false:
    reported).  Then in fp32 compute the 2 ranks against 1 rank (an MoE
    config also against the mesh-less engine) on ``base`` with the
    replacements ``fp32`` (a cut to what fits the card in fp32 beside
    its whole state; None: no fp32 run).  The head-parallel runs take
    ``lower_to_mesh``'s context where the config has a serving plan.
    Returns this rank's launches of the 2-rank serves."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch import lower
    from repro_torch.core import accelerator as acc
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.mesh_lowering import lower_to_mesh, \
        mesh_for_cores
    from repro_torch.sharding import set_rules_for_mesh
    from repro_torch.serve.layout import serving_layout

    args = serve.parser().parse_args([
        "--arch", base.name, "--batch", "4", "--requests",
        str(MESH_REQUESTS), "--max-len", "1024", "--max-new",
        str(MESH_MAX_NEW), "--prefill-chunk", str(chunk), "--device",
        "cuda"])
    cfgs = {tag: dc.replace(base, **flags) for tag, _, flags in runs}
    mesh = mesh_for_cores(2, device=dev)
    alone = Mesh(("data", "model"), (1, 1), device=dev)
    lowered, plan = None, None
    if any(t.startswith("hp") for t in cfgs):
        plan = lower.serving_plan(base, args.max_len, device=dev)
    if plan is not None:
        rr = tuple(h % 2 for h in range(base.n_heads))
        lowered = lower_to_mesh(plan.decode_dispatch(args.max_len).plan,
                                acc.multi_core_array(2), rr, mesh=mesh)
        if rank == 0:
            log("  " + lowered.describe().replace("\n", "\n  "))

    def ctx(tag, m):
        return lowered.activate() if lowered is not None \
            and tag.startswith("hp") and m is mesh \
            else set_rules_for_mesh(m)

    subs = "/".join(sub for _, sub, _ in runs)
    refs, replicated = {}, {}
    if rank == 0:
        # the references first, with the whole weights (the blocks are
        # not drawn yet, so the 1-rank peak is the replicated state's)
        whole = _draw(base, dev)
        if base.moe:
            # the MoE layers alone, whole and with no mesh
            layer_refs = _moe_layers(base, whole, dev)
        refs["alone"] = _mesh_sub(f"{subs}: mesh-less", rank, stats,
                                  _mesh_serve, base, whole, args, dev,
                                  contextlib.nullcontext())
        for tag, sub, _ in runs:
            refs[tag] = _mesh_sub(f"{sub}: {tag} 1 rank", rank, stats,
                                  _mesh_serve, cfgs[tag], whole, args, dev,
                                  ctx(tag, alone))
            replicated[tag] = (stats[f"{sub}: {tag} 1 rank"][1],
                               refs[tag]["held"])
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    layout = serving_layout(cfgs[runs[0][0]], mesh)
    blocks = _draw(base, dev, layout)
    launches = collections.Counter()
    for tag, sub, _ in runs:
        rows, dropped = [], {}
        with _kernel_rows(rows, dropped):
            run = _mesh_sub(f"{sub}: {tag} 2 ranks", rank, stats,
                            _mesh_serve, cfgs[tag], blocks, args, dev,
                            ctx(tag, mesh))
        launches.update(run["launches"])
        log(f"  [rank {rank}] ({sub}) {tag}: {len(run['tokens'])} requests "
            f"in {run['seconds']:.2f}s, launches {run['launches']}, "
            f"calls {run['calls']}; ledger "
            f"{run['plan'].plans()[-1].notes[-1:] if run['plan'] else None}")
        _rows_gate(f"({sub}) {tag}", rank, rows, dropped, want)
        cell = dryrun.run_cell(
            base.name, "decode_32k", cfg=cfgs[tag],
            mesh=Mesh(("data", "model"), (1, 2)), batch=args.batch,
            max_len=args.max_len, costs=False)["per_device_bytes"]
        held = run["held"]
        log(f"  [rank {rank}] ({sub}) {tag}: holds params {held['params']} "
            f"B, caches {held['caches']} B; dry-run per device (1, 2) "
            f"B={args.batch} max_len {args.max_len}: params "
            f"{cell['params']}, caches {cell['caches']}; peak "
            f"{stats[f'{sub}: {tag} 2 ranks'][1]:.2f} GB a rank")
        if (held["params"], held["caches"]) != (cell["params"],
                                                cell["caches"]):
            raise SystemExit(f"mesh ({sub}): rank {rank} holds other bytes "
                             "than the dry-run's blocks")
        if rank == 0:
            peak, whole_held = replicated[tag]
            log(f"  [rank 0] ({sub}) {tag}: the replicated state on a mesh "
                f"of 1 rank in this call: params {whole_held['params']} B, "
                f"caches {whole_held['caches']} B, peak {peak:.2f} GB")
            if not bf16_gate:
                differ, _, _ = _prefix_logits(run, refs[tag])
                log(f"  [rank 0] ({sub}) {tag} bf16: {differ} of "
                    f"{len(run['tokens'])} requests differ from 1 rank's "
                    "(reported; gated in fp32)")
            else:
                gate = _moe_mesh_report if base.moe else _mesh_gate
                gate(f"({sub}) {tag}", run, refs[tag], refs["alone"], rank)
        if base.moe:
            with ctx(tag, mesh):
                got = _moe_layers(cfgs[tag], blocks, dev, layout.specs)
            if rank == 0:
                _moe_layer_gate(f"({sub}) {tag}", got, layer_refs, rank)
    del refs
    if fp32 is None:
        del blocks
    else:
        # the same in fp32 compute, where the 2-rank sums' order shows
        # at fp32 rounding, not at bf16's
        c32 = dc.replace(base, compute_dtype="float32", **dict(fp32))
        if fp32:
            del blocks
            gc.collect()
            torch.cuda.empty_cache()
            blocks = _draw(c32, dev, serving_layout(
                dc.replace(c32, **runs[0][2]), mesh))
        _upcast(blocks)
        twos = {}
        for tag, sub, flags in runs:
            twos[tag] = _mesh_sub(f"{sub}: {tag} 2 ranks fp32", rank, stats,
                                  _mesh_serve, dc.replace(c32, **flags),
                                  blocks, args, dev, ctx(tag, mesh))
            launches.update(twos[tag]["launches"])
        del blocks
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            whole = _draw(c32, dev)
            _upcast(whole)
            if c32.moe:
                alone32 = _mesh_sub(f"{subs}: mesh-less fp32", rank, stats,
                                    _mesh_serve, c32, whole, args, dev,
                                    contextlib.nullcontext())
            for tag, sub, flags in runs:
                one = _mesh_sub(f"{sub}: {tag} 1 rank fp32", rank, stats,
                                _mesh_serve, dc.replace(c32, **flags),
                                whole, args, dev, ctx(tag, alone))
                _mesh_gate32(f"({sub}) {tag}", twos[tag], one, rank)
                if c32.moe:
                    _mesh_gate32(f"({sub}) {tag}", twos[tag], alone32, rank,
                                 against="the mesh-less engine")
            del whole
    dist.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches)


def _mesh_decode(rank, dev, stats) -> dict:
    """(a) head-parallel and (b) sequence-sharded decode of starcoder2-7b
    at full width, MESH_LAYERS layers, on 2 ranks, each holding only its
    blocks of the serving state.  Returns this rank's launches."""
    import dataclasses as dc

    from repro_torch import configs
    return _sharded_serves(
        rank, dev, stats,
        dc.replace(configs.get_config("starcoder2-7b"), n_layers=MESH_LAYERS),
        [("hp", "a", {"head_parallel_decode": True}),
         ("dist", "b", {"distributed_decode": True})], DENSE_KERNELS[:2])


def _moe_serve_mesh(rank, dev, stats) -> dict:
    """(g) phi3.5-moe at full width, MESH_MOE_LAYERS layers, served
    head-parallel with expert parallelism (``moe_shard_map_ep``) on 2
    ranks, each holding 8 of the 16 experts of every layer and its
    blocks of the rest.  Returns this rank's launches."""
    import dataclasses as dc

    from repro_torch import configs
    return _sharded_serves(
        rank, dev, stats,
        dc.replace(configs.get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS),
        [("hp+ep", "g", {"head_parallel_decode": True,
                         "moe_shard_map_ep": True})], DENSE_KERNELS[:2])


#: (h)-(j): MLA's latent, Mamba-2's conv tail and SSM state and jamba's
#: hybrid on the sharded serving state, each (arch, its depth or None
#: for the whole stack, its decode flag, the kernels it must launch,
#: ``_sharded_serves``' options).  (h)'s chunk is 640, not 256, because
#: MLA's shape-only plan sends chunks of at most 512 rows to the
#: reference (the MLA phase's regime (ii)), so at 256 no chunk would
#: launch #1; its fp32 gate runs the 3 dense layers (a dense stack of
#: the prefix's widths), since the MoE layer's 256 experts in fp32 beside
#: the whole state overflow the card.  (i)'s bf16 streams part from the
#: 1 rank's over 24 recurrent layers, so they are reported and its fp32
#: streams gated.  (j)'s period is too large for fp32 beside its whole
#: state: its bf16 streams are gated.
MESH_STATES = {
    "h": ("deepseek-v3-671b", 4, "distributed_decode",
          ("fused_attention_masked",),
          dict(chunk=640, fp32=dict(n_layers=3, first_dense_layers=0,
                                    moe=False))),
    "i": ("mamba2-130m", None, "head_parallel_decode", ("ssd_scan",),
          dict(bf16_gate=False)),
    "j": (JAMBA_ARCH, JAMBA_LAYERS, "distributed_decode",
          ("fused_attention_masked", "ssd_scan"), dict(fp32=None))}


def _state_serves(rank, dev, stats) -> dict:
    """(h)-(j) (MESH_STATES), each through :func:`_sharded_serves` and
    timed.  Returns this rank's launches."""
    import dataclasses as dc

    from repro_torch import configs

    launches = collections.Counter()
    for sub, (arch, layers, flag, want, kw) in MESH_STATES.items():
        base = jamba_cfg() if arch == JAMBA_ARCH else configs.get_config(arch)
        if layers is not None:
            base = dc.replace(base, n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tag = "hp" if flag == "head_parallel_decode" else "dist"
        launches.update(_sharded_serves(rank, dev, stats, base,
                                        [(tag, sub, {flag: True})], want,
                                        **kw))
        log(f"  [rank {rank}] ({sub}) sub-phase: "
            f"{time.perf_counter() - t0:.1f}s")
    return dict(launches)


def _moe_mesh(rank, dev, stats) -> None:
    """(c) phi3.5-moe's MoE layer at full width on 2 ranks: the global
    path, moe_shard_map_ep and moe_local_dispatch (capacity factor E/k:
    nothing dropped), outputs and the gradients of sum(y**2) by the
    expert weights per row within ROW_TOL of the global path's."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.launch.mesh import mesh_over_ranks
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_local
    from repro_torch.models.weights import init_params
    from repro_torch.sharding import set_rules_for_mesh

    full = configs.get_config(MOE_ARCH)
    cfg = dc.replace(full, n_layers=1,
                     capacity_factor=full.n_experts / full.top_k)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = {k: v[0] for k, v in
              init_params(cfg, g, dev)["layers"][0]["moe"].items()}
    x = torch.randn(MOE_MESH["B"], MOE_MESH["S"], cfg.d_model, generator=g,
                    device=dev).to(cfg.torch_dtype())
    mesh = mesh_over_ranks((1, MESH_RANKS), ("data", "model"), device=dev)

    def run(c, ctx):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with ctx:
            y, aux = moe_mod.moe_forward(leaves, c, x)
            (y.float() ** 2).sum().backward()
        return y.detach(), {k: leaves[k].grad for k in
                            ("w_gate", "w_up", "w_down")}, aux

    want = run(cfg, contextlib.nullcontext())
    for flag in ("moe_shard_map_ep", "moe_local_dispatch"):
        got = _mesh_sub(f"c: {flag}", rank, stats, run,
                        dc.replace(cfg, **{flag: True}),
                        set_rules_for_mesh(mesh))
        errs = {"y": row_err(got[0], want[0])}
        errs.update({k: row_err(got[1][k], want[1][k]) for k in want[1]})
        log(f"  [rank {rank}] (c) {flag}: per row "
            + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
            + f" (tol {ROW_TOL}); aux "
            + " ".join(f"{k}={float(v.detach()):.4e}"
                       for k, v in got[2].items())
            + (f"; the JAX package's fallback to the global path "
               f"{'taken' if moe_local._FALLBACK_LOGGED else 'not taken'}"
               if flag == "moe_local_dispatch" else ""))
        if max(errs.values()) > ROW_TOL:
            raise SystemExit(f"mesh (c) {flag}: disagrees with the global "
                             "path")
    del params, want, got


def _fsdp_run(rank, dev, stats, sub, per_rank, steps) -> tuple:
    """``MESH_ARCHS[sub]`` at full width, ``MESH_DEPTH[sub]`` layers,
    through launch/train.train_loop with FSDP on MESH_RANKS ranks, B =
    ``per_rank`` a rank, then (rank 0) the single-rank run of the global
    batch: #7-#9 launched on each rank, the losses within MESH_TRAIN_REL
    of the single rank's (MoE: step 0's load-balance loss within
    MESH_LB_REL), the bytes each rank holds against the dry-run's
    per-device figure for the same mesh.  Returns (the state of blocks,
    the config, the mesh, this rank's launches of the FSDP run, rank 0's
    single-rank losses: None on the other ranks)."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.launch.mesh_ranks import fsdp_train

    arch = MESH_ARCHS[sub]
    cfg = dc.replace(configs.get_config(arch), n_layers=MESH_DEPTH[sub])
    lb = {"FSDP": [], "1 rank": []}
    want = None
    kw = dict(steps=steps, batch=per_rank * MESH_RANKS, seq=MESH_TRAIN_SEQ,
              lr=TRAIN_LR, moment_dtype="bfloat16", log_every=steps)
    mesh = make_host_mesh(data=MESH_RANKS, device=dev)
    build.reset_launches()
    state, losses, held = _mesh_sub(
        f"{sub}: FSDP", rank, stats, fsdp_train, cfg, mesh, dev,
        on_step=lambda s, m, t: lb["FSDP"].append(float(m["moe_lb_loss"])),
        **kw)
    launches = dict(build.LAUNCHES)
    per_step = {n: launches.get(n, 0) / steps for n in TRAIN_KERNELS[:3]}
    log(f"  [rank {rank}] ({sub}) FSDP losses {losses}, launches a step "
        f"{per_step}, {stats[f'{sub}: FSDP'][0] / steps:.2f}s a step")
    missing = [n for n, c in per_step.items() if c == 0]
    if missing:
        raise SystemExit(f"mesh ({sub}): rank {rank} never launched "
                         f"{missing}")
    cell = dryrun.run_cell(arch, "train_4k", cfg=cfg,
                           mesh=Mesh(("data", "model"), (MESH_RANKS, 1)),
                           moment_dtype="bfloat16",
                           costs=False)["per_device_bytes"]
    params = tree.leaves(dryrun.abstract_params(cfg)[0])
    whole = sum(x.numel() * x.element_size() for x in params)
    moments = 2 * 2 * sum(x.numel() for x in params)
    gb = {k: v / 1e9 for k, v in held.items()}
    log(f"  [rank {rank}] ({sub}) holds params {gb['params']:.3f} GB, "
        f"gradients {gb['grads']:.3f}, AdamW {gb['optimizer']:.3f}: "
        f"{sum(gb.values()):.3f} GB (dry-run per device: params "
        f"{cell['params'] / 1e9:.3f}, optimizer {cell['optimizer'] / 1e9:.3f}"
        f"); the whole state, which each rank would hold replicated: "
        f"{(2 * whole + moments) / 1e9:.3f} GB; peak "
        f"{stats[f'{sub}: FSDP'][1]:.2f} GB a rank")
    if (held["params"], held["optimizer"]) != (cell["params"],
                                               cell["optimizer"]):
        raise SystemExit(f"mesh ({sub}): rank {rank} holds other bytes "
                         "than the dry-run's blocks")
    if rank == 0:
        _, want = _mesh_sub(
            f"{sub}: 1 rank B={per_rank * MESH_RANKS}", rank, stats,
            train.train_loop, cfg, device=dev,
            on_step=lambda s, m, t: lb["1 rank"].append(
                float(m["moe_lb_loss"])), **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        log(f"  [rank 0] ({sub}) single-rank B={per_rank * MESH_RANKS} "
            f"losses {want}: worst rel {rel:.3e} (tol {MESH_TRAIN_REL})")
        if rel > MESH_TRAIN_REL:
            raise SystemExit(f"mesh ({sub}): FSDP losses disagree with the "
                             "single rank's")
        if cfg.moe:
            a, b = lb["FSDP"][0], lb["1 rank"][0]
            lb_rel = abs(a - b) / abs(b)
            log(f"  [rank 0] ({sub}) moe_lb_loss FSDP {lb['FSDP']}, single "
                f"rank {lb['1 rank']}: step 0 rel {lb_rel:.3e} (tol "
                f"{MESH_LB_REL})")
            if not lb_rel <= MESH_LB_REL:
                raise SystemExit(f"mesh ({sub}): the load-balance loss is "
                                 "not the global batch's")
    dist.barrier()
    torch.cuda.empty_cache()
    return state, cfg, mesh, launches, want


#: (l)'s fp32 gradient step's sequence: shorter than MESH_TRAIN_SEQ, to
#: bound each rank's memory (2.44 G parameters whole in fp32 with their
#: gradients on both ranks of the one card, beside the blocks' gradients)
MESH_MLA_GRAD_SEQ = 256


def _tp_blocks(params) -> dict:
    """The model-axis widths a rank of (k)-(m) holds in its first layer:
    the GQA stack's query and KV heads, MLA's heads, or Mamba-2's SSM
    heads, ``in_proj`` columns, conv channels and ``inner``; each leaf
    stacked with a leading period axis."""
    layer = params["layers"][0]
    if "attn" in layer:
        attn = layer["attn"]
        keys = ("wq_b", "wk_b", "wv_b", "wo") if "wq_b" in attn \
            else ("wq", "wk", "wv", "wo")
        return {k: attn[k].shape[2 if k != "wo" else 1] for k in keys}
    m = layer["mamba"]
    return {"ssm_heads": m["a_log"].shape[-1],
            "in_proj": m["in_proj"].shape[-1],
            "conv": m["conv_w"].shape[-1], "inner": m["out_proj"].shape[1]}


@contextlib.contextmanager
def _stream_rows(rows: list):
    """Append the sequence rows of each layer's output (the residual
    stream a rank holds between the layers) to ``rows`` while the
    enclosed code runs."""
    from repro_torch.models import transformer as tf

    layer = tf._layer_forward

    def recorded(*a, **kw):
        out = layer(*a, **kw)
        rows.append(out[0].shape[1])
        return out

    tf._layer_forward = recorded
    try:
        yield rows
    finally:
        tf._layer_forward = layer


def _bytes_line(counter) -> str:
    """A collective count's bytes by kind, in MB."""
    coll = counter.result()["collective_bytes"]
    return ", ".join(f"{k} {v / 1e6:.1f}" for k, v in coll.items() if v)


def _tp_train(rank, dev, stats, sub, want=None) -> dict:
    """Tensor-parallel training on a (1, MESH_RANKS) mesh through
    launch/train.train_loop at full width, global B=4, seq
    MESH_TRAIN_SEQ, MESH_TRAIN_STEPS steps, bf16 moments (every rank the
    same rows): (k) ``MESH_ARCHS["d"]`` at (d)'s depth, (l) deepseek-v3's
    MLA training config (``mla_train_cfg``, no MoE, no dense prefix) or
    (m) mamba2-130m through the plain scan, each at ``MESH_DEPTH[sub]``
    layers.  Gates: each rank holds its model-axis blocks (query and KV
    heads; MLA's heads; Mamba-2's SSM heads, ``in_proj`` columns, conv
    channels and ``inner``), its bytes the dry-run's per-device figure
    for the mesh; the losses within MESH_TRAIN_REL of one rank's run of
    the same config and batch (``want``: (k) takes (d)'s, else rank 0
    runs it); #7-#9 launched on each rank and held against their plain
    versions at its head counts (``attention_train_records``, with its
    dropped-tile control; (l) at 64 heads, D 192 / Dv 128); one fp32
    step's gradient blocks within MESH_TOL of each leaf's largest
    against the same blocks of one rank's whole gradients, which every
    rank computes (no gather of the fp32 blocks through the host); each
    layer's output in the run its rank's S / MESH_RANKS rows of the
    residual stream (JAX's ``seq_stream``).  (k) also runs one bf16
    step under the default rules and one under
    ``dict(DEFAULT_RULES, seq_stream=None)`` (the stream whole, its sums
    all-reduces), each timed with its peak and collective bytes, and
    the fp32 step under the latter, its gradient blocks within MESH_TOL
    of each leaf's largest against the default run's.  Returns this
    rank's launches of the training run."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.cost_analysis import count_collectives
    from repro_torch.launch.mesh import Mesh, mesh_over_ranks
    from repro_torch.launch.mesh_ranks import fsdp_train
    from repro_torch.models.weights import init_params
    from repro_torch.sharding import rules as shrules
    from repro_torch.sharding import set_rules_for_mesh
    from repro_torch.sharding.rules import local_slice
    from repro_torch.train import step as step_mod

    key = "d" if sub == "k" else sub        # (k) trains (d)'s config
    arch = MESH_ARCHS[key]
    cfg = dc.replace(mla_train_cfg() if sub == "l"
                     else configs.get_config(arch), n_layers=MESH_DEPTH[key])
    name = f"{sub}: tensor-parallel"
    shape = (1, MESH_RANKS)
    mesh = mesh_over_ranks(shape, ("data", "model"), device=dev)
    steps, b, s = MESH_TRAIN_STEPS, 2 * MESH_RANKS, MESH_TRAIN_SEQ
    kw = dict(steps=steps, batch=b, seq=s, lr=TRAIN_LR,
              moment_dtype="bfloat16", log_every=steps)
    build.reset_launches()
    with _stream_rows([]) as rows, count_collectives() as moved:
        state, losses, held = _mesh_sub(name, rank, stats, fsdp_train, cfg,
                                        mesh, dev, **kw)
    launches = dict(build.LAUNCHES)
    log(f"  [rank {rank}] ({sub}) residual stream a rank: {len(rows)} "
        f"layer outputs of {sorted(set(rows))} rows of {s}; collective "
        f"MB over the {steps} steps: {_bytes_line(moved)}")
    if not rows or set(rows) != {s // MESH_RANKS}:
        raise SystemExit(f"mesh ({sub}): rank {rank}'s residual stream is "
                         "not its sequence block")
    blocks = _tp_blocks(state.params)
    whole = _tp_blocks(init_params(cfg, None, "meta"))
    attention = "wo" in blocks
    per_step = {n: launches.get(n, 0) / steps for n in TRAIN_KERNELS[:3]}
    log(f"  [rank {rank}] ({sub}) {cfg.name} tensor-parallel on {shape}: "
        + ", ".join(f"{k} {v} of {whole[k]}" for k, v in blocks.items())
        + f"; losses {losses}, launches a step {per_step}, "
        f"{stats[name][0] / steps:.2f}s a step, peak {stats[name][1]:.2f} "
        "GB a rank")
    if any(v * MESH_RANKS != whole[k] for k, v in blocks.items()):
        raise SystemExit(f"mesh ({sub}): the rank does not hold its "
                         "model-axis blocks")
    missing = [n for n, c in per_step.items() if c == 0]
    if attention and missing:
        raise SystemExit(f"mesh ({sub}): rank {rank} never launched "
                         f"{missing}")
    cell = dryrun.run_cell(arch, "train_4k", cfg=cfg,
                           mesh=Mesh(("data", "model"), shape),
                           moment_dtype="bfloat16",
                           costs=False)["per_device_bytes"]
    log(f"  [rank {rank}] ({sub}) holds params {held['params'] / 1e9:.3f} "
        f"GB, gradients {held['grads'] / 1e9:.3f}, AdamW "
        f"{held['optimizer'] / 1e9:.3f} (dry-run per device: params "
        f"{cell['params'] / 1e9:.3f}, optimizer {cell['optimizer'] / 1e9:.3f})")
    if (held["params"], held["optimizer"]) != (cell["params"],
                                               cell["optimizer"]):
        raise SystemExit(f"mesh ({sub}): rank {rank} holds other bytes "
                         "than the dry-run's blocks")
    whole_stream = dict(shrules.DEFAULT_RULES, seq_stream=None)
    if sub == "k":
        # one more step under each rule set, in turn on the trained blocks
        g = torch.Generator(device=dev)
        g.manual_seed(13)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                         generator=g, device=dev)}
        for label, rules in (("seq_stream", None),
                             ("seq_stream=None", whole_stream)):
            with count_collectives() as moved, \
                    set_rules_for_mesh(mesh, rules):
                state, m = _mesh_sub(f"{sub}: one step, {label}", rank,
                                     stats, step_mod.train_step, state,
                                     batch, cfg, lr=TRAIN_LR)
            sec, peak = stats[f"{sub}: one step, {label}"]
            log(f"  [rank {rank}] ({sub}) one bf16 step under {label}: "
                f"{sec:.3f}s, peak {peak:.2f} GB, loss "
                f"{float(m['loss']):.6f}, collective MB "
                f"{_bytes_line(moved)}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        if want is None:
            want = _mesh_sub(f"{sub}: 1 rank B={b}", rank, stats,
                             train.train_loop, cfg, device=dev, **kw)[1]
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, want))
        log(f"  [rank 0] ({sub}) single-rank B={b} losses {want}: worst "
            f"rel {rel:.3e} (tol {MESH_TRAIN_REL})")
        if rel > MESH_TRAIN_REL:
            raise SystemExit(f"mesh ({sub}): tensor-parallel losses "
                             "disagree with the single rank's")
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    g = torch.Generator(device=dev)
    if attention:
        # the rank's #7-#9 at its head counts, against their plain versions
        g.manual_seed(7 + rank)
        if sub == "l":
            hq = hkv = blocks["wq_b"]
            d, d_v = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, \
                cfg.v_head_dim
        else:
            hq, hkv, d, d_v = blocks["wq"], blocks["wk"], cfg.head_dim, \
                cfg.head_dim
        bf = torch.bfloat16
        q = torch.randn(b, hq, s, d, generator=g, device=dev, dtype=bf)
        k = torch.randn(b, hkv, s, d, generator=g, device=dev, dtype=bf)
        v = torch.randn(b, hkv, s, d_v, generator=g, device=dev, dtype=bf)
        do = torch.randn(b, hq, s, d_v, generator=g, device=dev, dtype=bf)
        records = attention_train_records(q, k, v, do, True,
                                          f"{sub} rank {rank}")
        log(f"  [rank {rank}] ({sub}) #7-#9 at B={b}, {hq} over {hkv} "
            f"heads, D {d} / Dv {d_v}, S={s}: "
            + "; ".join(f"{n} err {r['max_abs_err']:.3e} {r['ms']:.3f} ms"
                        for n, r in records.items()))
        del q, k, v, do

    # one fp32 step's gradient blocks, each rank's against the same
    # blocks of one rank's whole gradients
    f32 = dc.replace(cfg, param_dtype="float32", compute_dtype="float32")
    s_g = MESH_MLA_GRAD_SEQ if sub == "l" else s
    g.manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s_g + 1),
                                     generator=g, device=dev)}
    fsdp = step_mod.fsdp_layout(f32, mesh)

    def mesh_grads(rules=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = fsdp.init(f32, gen, dev)
        with set_rules_for_mesh(mesh, rules):
            (_, m), grads = step_mod.value_and_grad(params, f32, batch,
                                                    fsdp=fsdp)
        return float(m["loss"]), grads

    with count_collectives() as moved:
        loss, got = _mesh_sub(f"{sub}: fp32 gradients", rank, stats,
                              mesh_grads)
    log(f"  [rank {rank}] ({sub}) fp32 step: collective MB "
        f"{_bytes_line(moved)}")
    gc.collect()
    torch.cuda.empty_cache()
    if sub == "k":
        with count_collectives() as moved:
            loss_w, whole = _mesh_sub(f"{sub}: fp32 gradients, "
                                      "seq_stream=None", rank, stats,
                                      mesh_grads, whole_stream)
        errs = [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                for x, y in zip(tree.leaves(whole), tree.leaves(got))]
        log(f"  [rank {rank}] ({sub}) fp32 step under seq_stream=None: "
            f"loss {loss_w:.6f} ({loss:.6f} under seq_stream), collective "
            f"MB {_bytes_line(moved)}; its gradient blocks against "
            f"seq_stream's, worst over a leaf's largest {max(errs):.2e} "
            f"(tol {MESH_TOL})")
        if max(errs) > MESH_TOL:
            raise SystemExit(f"mesh ({sub}): the whole stream's gradients "
                             "disagree with the sequence blocks'")
        del whole
        gc.collect()
        torch.cuda.empty_cache()

    def whole_grads():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        (_, m), grads = step_mod.value_and_grad(init_params(f32, gen, dev),
                                                f32, batch)
        return float(m["loss"]), grads

    loss_1, want_g = _mesh_sub(f"{sub}: fp32 gradients, 1 rank", rank,
                               stats, whole_grads)
    specs = tree.leaves(fsdp.param_specs, is_leaf=shrules.is_axes)
    errs = {path: float((x - local_slice(y, spec, mesh)).abs().max()
                        / y.abs().max().clamp_min(1e-30))
            for (path, y), x, spec in zip(dryrun._paths(want_g),
                                          tree.leaves(got), specs)}
    log(f"  [rank {rank}] ({sub}) fp32 loss {loss:.6f} (1 rank "
        f"{loss_1:.6f}) at S={s_g}; each leaf's gradient block against "
        f"one rank's, over the leaf's largest (tol {MESH_TOL}): "
        + " ".join(f"{p}={e:.2e}" for p, e in errs.items()))
    if max(errs.values()) > MESH_TOL:
        raise SystemExit(f"mesh ({sub}): fp32 gradients disagree with the "
                         "single rank's")
    del got, want_g
    dist.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _train_mesh(rank, dev, stats) -> dict:
    """(d) FSDP training of starcoder2-7b at full width, 1 layer, B=2 a
    rank, seq 1024, against rank 0's single-rank B=4 run; (e)
    remesh_state of the trained blocks from the 2 ranks to each rank
    alone, every leaf bit-equal to the blocks gathered; (f) FSDP
    training of phi3.5-moe at full width, 1 layer, B=1 a rank, against
    rank 0's single-rank B=2 run, its load-balance loss among the
    gates; (k) starcoder2-7b's tensor-parallel training on (1, 2)
    against (d)'s single-rank run, (l) deepseek-v3's MLA and (m)
    mamba2-130m's (:func:`_tp_train`).  Returns this rank's launches of
    the training runs."""
    from repro_torch import tree
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.weights import param_axes
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.runtime import remesh_state
    from repro_torch.train.step import TrainState, fsdp_layout, whole_state

    state, cfg, mesh, launches, want = _fsdp_run(rank, dev, stats, "d", 2,
                                                 MESH_TRAIN_STEPS)
    launches = collections.Counter(launches)

    axes = param_axes(cfg)
    state_axes = TrainState(params=axes, opt=AdamWState(step=(), mu=axes,
                                                        nu=axes))
    alone = Mesh(("data", "model"), (1, 1), device=dev)
    moved = _mesh_sub("e: remesh 2 -> 1", rank, stats, remesh_state, state,
                      state_axes, alone, None, mesh=mesh)
    whole = whole_state(state, fsdp_layout(cfg, mesh))
    del state
    pairs = list(zip(tree.leaves(moved), tree.leaves(whole)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    log(f"  [rank {rank}] (e) remesh_state: {len(pairs)} leaves, "
        f"{sum(b.numel() for _, b in pairs) / 1e9:.3f} G elements, "
        f"{differ} differ from the blocks gathered")
    if differ:
        raise SystemExit("mesh (e): remesh_state changed a leaf")
    del moved, whole, pairs
    gc.collect()
    torch.cuda.empty_cache()

    state, _, _, more, _ = _fsdp_run(rank, dev, stats, "f", 1,
                                     MESH_MOE_STEPS)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(more)
    t0 = time.perf_counter()
    for sub in ("k", "l", "m"):
        launches.update(_tp_train(rank, dev, stats, sub,
                                  want if sub == "k" else None))
    log(f"  [rank {rank}] (k), (l) and (m): {time.perf_counter() - t0:.1f}s")
    return dict(launches)


def mesh_rank(rank, dev):
    """One rank of the mesh phase: (a)-(m).  Returns (launches,
    {sub-phase: (seconds, peak GB)})."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stats = {}
    launches = collections.Counter(_mesh_decode(rank, dev, stats))
    gc.collect()
    torch.cuda.empty_cache()
    _moe_mesh(rank, dev, stats)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(_train_mesh(rank, dev, stats))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(_moe_serve_mesh(rank, dev, stats))
    launches.update(_state_serves(rank, dev, stats))
    return dict(launches), stats


def mesh_phase(dev):
    """The multi-device slice on one card: MESH_RANKS gloo ranks share
    cuda:0 (launch.mesh.spawn, one spawn for every sub-phase): (a)
    head-parallel serve under lower_to_mesh, (b) sequence-sharded decode,
    both on the sharded serving state, (c) phi3.5-moe's expert-parallel
    and local dispatch, (d) FSDP training, (e) remesh_state, (f)
    phi3.5-moe's FSDP training, (k) starcoder2-7b's, (l) deepseek-v3's
    MLA and (m) mamba2-130m's tensor-parallel training, (g) phi3.5-moe
    served head-parallel with expert parallelism on the sharded serving
    state, then (h) deepseek-v3's
    MLA, (i) mamba2-130m and (j) jamba's period on the sharded serving
    state (``MESH_STATES``).  Returns the launches of both ranks."""
    from repro_torch.launch.mesh import spawn

    gc.collect()
    torch.cuda.empty_cache()
    log(f"mesh: {MESH_RANKS} gloo ranks share one card ({card_line()}); "
        "their collectives are staged through host memory over gloo, so "
        "the times below say nothing of an NVLink's")
    init = ROOT / "build" / "mesh_init"
    init.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = spawn(MESH_RANKS, mesh_rank, backend="gloo",
                devices=["cuda:0"] * MESH_RANKS, init_file=str(init),
                timeout=600, threads=2)
    launches = collections.Counter()
    for rank, (lc, stats) in enumerate(out):
        launches.update(lc)
        log(f"mesh: rank {rank} " + "; ".join(
            f"{k} {s:.1f}s peak {m:.2f} GB" for k, (s, m) in stats.items()))
    log(f"mesh: {time.perf_counter() - t0:.1f}s with the ranks' start-up; "
        f"launches of both ranks {dict(launches)}")
    return launches


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
    usage = tensor_core_usage()

    roofline = start_roofline()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    log("kernels:")
    results = kernel_phase(dev, g)
    results.update(train_kernel_phase(dev, g, check_kernel))
    results.update(ssd_kernel_phase(dev, g))
    frontend = frontend_kernel_phase(dev, g)
    for name, shapes in moe_kernel_phase(dev, g).items():
        frontend.setdefault(name, {}).update(shapes)
    for name, shapes in mla_train_kernel_phase(dev, g).items():
        frontend.setdefault(name, {}).update(shapes)
    for name, shapes in jamba_kernel_phase(dev, g).items():
        frontend.setdefault(name, {}).update(shapes)
    log("kernels: " + ", ".join(f"{n} ok" for n in results))
    log(f"phase kernels: done at {time.time() - t0:.1f}s")

    def timed(name, fn, *a):
        """``fn(*a)``, its seconds and the run's so far logged."""
        t = time.time()
        out = fn(*a)
        log(f"phase {name}: {time.time() - t:.1f}s (done at "
            f"{time.time() - t0:.1f}s)")
        return out

    timed("plan", plan_phase, dev)
    launches = timed("serve", serve_phase, dev, roofline)
    launches.update(timed("new dense", new_dense_phase, dev))
    launches.update(timed("qwen", qwen_phase, dev))
    launches.update(timed("mamba forward", mamba_forward_phase, dev))
    launches.update(timed("mamba serve", mamba_serve_phase, dev))
    launches.update(timed("qproj train", qproj_train_phase, dev, g))
    launches.update(timed("train parity", train_parity_phase, dev))
    launches.update(timed("train", train_phase, dev))
    launches.update(timed("frontends", frontends_phase, dev))
    launches.update(timed("moe", moe_phase, dev))
    mla_launches, mla_records = timed("mla", mla_phase, dev, g)
    launches.update(mla_launches)
    for name, shapes in mla_records.items():
        frontend.setdefault(name, {}).update(shapes)
    launches.update(timed("mla train", mla_train_phase, dev))
    launches.update(timed("mamba train", mamba_train_phase, dev))
    launches.update(timed("jamba serve", jamba_serve_phase, dev))
    launches.update(timed("mesh", mesh_phase, dev))
    missing = [n for n in build.KERNELS if launches[n] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on any path: {missing}")

    for name, ms in RECORDED_FMA_MS.items():
        log(f"{name}: {results[name]['ms']:.4f} ms in this run; "
            f"{ms:.4f} ms on the FMA body, as PERF.md records it (not "
            f"measured in this run)")
    # registers and spill of the instantiation each kernel's timed call
    # ran: #4's table shape (decode) runs the split-KV body, not its
    # tensor-core one, so it has none here
    for name, (symbol, regs, spill) in usage.items():
        if name != "fused_attention_paged":
            results[name].update(instantiation=symbol, registers=regs,
                                 spill_bytes=spill)
    # the frontends', phi3.5-moe's and deepseek-v3's (MLA) shapes of #1,
    # #3 and #7-#9 ride with their rows
    for name, shapes in frontend.items():
        results[name].update(shapes)
    record = [dict(name=n, route="cuda", launches=launches[n], **r)
              for n, r in results.items()]
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

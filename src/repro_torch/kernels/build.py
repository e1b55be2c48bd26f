"""Build the port's CUDA kernels and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/repro_torch/<name>-<hash>.so`` under the repository root; the
hash covers the sources and the flags, so an edited kernel never loads
a stale library.  A source may hold several kernels (a masked kernel,
its paged twin and its training forward share one body; the two
backward kernels share one source) and is built once for all of them.
Nothing is built while a module is imported: the first launch of a
kernel builds it, and :func:`build_all` builds every kernel at once,
one ``nvcc`` process per source, all started together.

The launch counts live here too: ``LAUNCHES[name]`` goes up by one each
time a wrapper launches kernel ``name`` on the card, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> its source, the C entry point and that entry point's
#: argument types (pointers and the stream as c_void_p, strides as
#: c_longlong, so ctypes never cuts them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
KERNELS = {
    "fused_attention_masked": (
        "fused_attention.cu", "fused_attention_masked_launch",
        [_P] * 7 + [_I] * 9 + [_F, _I, _P]),
    "fused_qproj_attention_masked": (
        "fused_qproj_attention.cu", "fused_qproj_attention_masked_launch",
        [_P] * 6 + [_I] * 9 + [_F, _F, _I, _I, _P]),
    "fused_decode_block": (
        "fused_decode_block.cu", "fused_decode_block_launch",
        [_P] * 9 + [_LL] + [_I] * 7 + [_F, _F] + [_I] * 4 + [_P, _P]),
    "fused_attention_paged": (
        "fused_attention.cu", "fused_attention_paged_launch",
        [_P] * 8 + [_I] * 10 + [_F, _I, _P]),
    "fused_qproj_attention_paged": (
        "fused_qproj_attention.cu", "fused_qproj_attention_paged_launch",
        [_P] * 7 + [_I] * 10 + [_F, _F, _I, _I, _P]),
    "fused_decode_block_paged": (
        "fused_decode_block.cu", "fused_decode_block_paged_launch",
        [_P] * 10 + [_LL] + [_I] * 8 + [_F, _F] + [_I] * 4 + [_P, _P]),
    "fused_attention_fwd": (
        "fused_attention.cu", "fused_attention_fwd_launch",
        [_P] * 5 + [_I] * 9 + [_F, _I, _P]),
    "fused_attention_bwd_dq": (
        "fused_attention_bwd.cu", "fused_attention_bwd_dq_launch",
        [_P] * 7 + [_I] * 9 + [_F, _I, _P]),
    "fused_attention_bwd_dkv": (
        "fused_attention_bwd.cu", "fused_attention_bwd_dkv_launch",
        [_P] * 8 + [_I] * 9 + [_F, _I, _P]),
    "fused_qproj_attention_fwd": (
        "fused_qproj_attention.cu", "fused_qproj_attention_fwd_launch",
        [_P] * 6 + [_I] * 10 + [_F, _F, _I, _I, _P]),
    "ssd_scan": (
        "ssd_scan.cu", "ssd_scan_launch",
        [_P] * 9 + [_I] * 7 + [_LL] * 8 + [_I, _I, _P, _LL, _LL, _LL, _I,
                                           _I, _P, _P]),
}

#: kernel name -> the kernels of its bf16 tensor-core body (C linkage,
#: so the names are the source's own): the D = Dv = 128 instantiation
#: that the serve and training paths run, then the one for any even
#: width, and for the training attention's three kernels (#7-#9) the one
#: for D in (128, 192], Dv <= 128 that MLA's training runs.  The masked
#: and paged kernels' bf16 bodies serve their one-pass shapes (the
#: split-KV body, fp32 FMAs, serves decode shapes);
#: fused_qproj_attention_fwd is fused_qproj_attention_masked's kernel
#: without lengths; the decode megakernels' bodies are cooperative
#: launches of one block per SM; the SSD scan's, a P slice of 64 (the
#: whole head of mamba2-130m) and one of any width.
TENSOR_CORE_BODIES = {
    "fused_attention_masked": ("masked_mma_kernel_d128",
                               "masked_mma_kernel_any"),
    "fused_qproj_attention_masked": ("qproj_mma_kernel_d128",
                                     "qproj_mma_kernel_any"),
    "fused_attention_paged": ("paged_mma_kernel_d128",
                              "paged_mma_kernel_any"),
    "fused_qproj_attention_paged": ("qproj_paged_mma_kernel_d128",
                                    "qproj_paged_mma_kernel_any"),
    "fused_attention_fwd": ("fwd_mma_kernel_d128", "fwd_mma_kernel_any",
                            "fwd_mma_kernel_d192"),
    "fused_attention_bwd_dq": ("dq_mma_kernel_d128", "dq_mma_kernel_any",
                               "dq_mma_kernel_d192"),
    "fused_attention_bwd_dkv": ("dkv_mma_kernel_d128", "dkv_mma_kernel_any",
                                "dkv_mma_kernel_d192"),
    "fused_qproj_attention_fwd": ("qproj_mma_kernel_d128",
                                  "qproj_mma_kernel_any"),
    "fused_decode_block": ("decode_mma_kernel_d128",
                           "decode_mma_kernel_any"),
    "fused_decode_block_paged": ("paged_decode_mma_kernel_d128",
                                 "paged_decode_mma_kernel_any"),
    "ssd_scan": ("ssd_mma_kernel_p64", "ssd_mma_kernel_any")}

#: kernel name -> the kernels of its wide body (C linkage), which it
#: runs past head width 128 (MLA's latent heads, D 576, Dv 512;
#: csrc/masked_wide.cuh): bf16 on the tensor cores, then fp32 on FMAs.
#: Launched through the kernel's own entry point and counted as its
#: launches.
WIDE_BODIES = {"fused_attention_masked": ("masked_wide_mma_kernel",
                                          "masked_wide_fma_kernel")}

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: collections.Counter = collections.Counter()

_loaded: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _tool(name: str, purpose: str) -> str:
    """A CUDA toolkit program: $CUDA_HOME/bin (default /usr/local/cuda),
    else PATH; raises if neither has it."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / name, shutil.which(name)):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(f"{name} not found (looked in $CUDA_HOME/bin, "
                       f"/usr/local/cuda/bin and PATH): {purpose}")


def _nvcc() -> str:
    return _tool("nvcc", "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile the sources of every kernel in ``names`` (default: all)
    whose library is missing, one nvcc per source, in parallel.  Returns
    {source: ptxas report}, and keeps each report beside its library
    (:func:`ptxas_report`); raises with the compiler's output on
    failure."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = KERNELS[name][0], library_path(name)
        if out.exists() or src in procs:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[src] = log
        if proc.returncode:
            failed.append(f"{src}:\n{log}")
            continue
        out.with_suffix(".ptxas").write_text(log)
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def ptxas_report(name: str) -> str:
    """The ptxas report of kernel ``name``'s library, kept by the
    build_all that built it."""
    return library_path(name).with_suffix(".ptxas").read_text()


def ptxas_usage(report: str, function: str) -> tuple[int, int]:
    """(registers, spill bytes stored + loaded) of kernel ``function``,
    by its exact symbol, in a ptxas report; raises if the report does
    not give both."""
    cur, regs, spill = None, None, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = m.group(1)
        elif cur == function:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = int(m.group(1))
    if regs is None or spill is None:
        raise ValueError(f"the ptxas report gives no registers and spill "
                         f"of {function}")
    return regs, spill


def sass_hmma(name: str, function: str) -> int:
    """The HMMA (tensor-core) instructions in the SASS of kernel
    ``function`` (its exact symbol) in kernel ``name``'s built library,
    from ``cuobjdump -sass``; raises if cuobjdump or the function is
    missing."""
    exe = _tool("cuobjdump", "the SASS cannot be read")
    out = subprocess.run([exe, "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    for part in out.split("Function : ")[1:]:
        fn, _, sass = part.partition("\n")
        if fn.strip() == function:
            return sass.count("HMMA")
    raise ValueError(f"{library_path(name)} has no function {function}")


def kernel(name: str):
    """The bound C entry point of kernel ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream; raise if the
    launch was refused.  Counts the launch."""
    err = kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def dtype_code(t: torch.Tensor) -> int:
    return DTYPE_CODES[t.dtype]

"""The port's boundaries: no file under src/repro_torch/, and no
script at the repo's root (chip_smoke.py, validate_costmodel_torch.py,
the time_*.py scripts and any later one), imports JAX or anything of
the JAX package; the entry points default to the card and raise
without one;
each kernel source names the TPU kernel it replaces (#11, ssd_scan, by
file and line) and defines the tensor-core kernels build names; the
ptxas report is read per kernel."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ROOT_SCRIPTS = sorted(ROOT.glob("*.py"))
FILES = sorted(PORT.rglob("*.py")) + ROOT_SCRIPTS
FORBIDDEN = {"jax", "jaxlib", "repro", "flax"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("name", ["chip_smoke.py",
                                  "validate_costmodel_torch.py",
                                  "time_decode.py", "time_ssd_scan.py"])
def test_root_scripts_are_checked(name):
    """The no-JAX check reads every root script by glob, so a script
    added later is held to it without being named."""
    assert ROOT / name in ROOT_SCRIPTS and ROOT / name in FILES


def test_every_port_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)


#: the training slice's modules: the import check above covers each
TRAINING_MODULES = ["optim/adamw.py", "optim/compression.py",
                    "train/step.py", "data/pipeline.py",
                    "checkpoint/manager.py", "runtime/elastic.py",
                    "launch/train.py", "tree.py",
                    "kernels/csrc/fused_attention_bwd.cu"]


#: the Mamba slice's modules
MAMBA_MODULES = ["configs/mamba2_130m.py", "kernels/ssd_scan.py",
                 "models/mamba.py", "kernels/csrc/ssd_scan.cu"]


#: the fault-tolerance slice's modules
FAULT_MODULES = ["serve/faults.py", "serve/audit.py", "serve/snapshot.py",
                 "serve/supervisor.py"]


#: the DSE core and lowering slice's modules
DSE_MODULES = [f"core/{m}.py" for m in (
    "workload", "nodes", "dependencies", "interconnect", "accelerator",
    "costmodel", "engine", "scheduler", "spacegen", "analytical",
    "fusion", "validation", "codesign")] + [
    "lower/lowering.py", "lower/plan.py", "lower/cache.py",
    "lower/runtime.py", "configs/qwen3_14b.py", "configs/starcoder2_15b.py"]


#: the modality-frontend slice's modules (remat="dots" lives in
#: models/transformer.py, checked with every port module above)
FRONTEND_MODULES = ["configs/hubert_xlarge.py", "configs/internvl2_2b.py"]


#: the hybrid slice's modules (Mamba-2 training lives in kernels/ops.py
#: and kernels/ssd_scan.py, checked above) and the GA allocator's
HYBRID_MODULES = ["configs/jamba_15_large.py", "core/allocation.py",
                  "configs/gap8_cct.py"]


#: the multi-device slice's modules
MESH_MODULES = ["sharding/__init__.py", "sharding/rules.py",
                "sharding/collectives.py", "launch/mesh.py",
                "launch/mesh_lowering.py", "launch/mesh_ranks.py",
                "launch/dryrun.py", "serve/distributed_decode.py",
                "models/moe_local.py", "sharding/fsdp.py",
                "serve/layout.py"]


#: the dry-run roofline's modules: the kernels' closed forms and the
#: cost counter
ROOFLINE_MODULES = ["kernels/cost.py", "launch/cost_analysis.py"]


@pytest.mark.parametrize("rel", TRAINING_MODULES + MAMBA_MODULES
                         + FAULT_MODULES + DSE_MODULES + FRONTEND_MODULES
                         + HYBRID_MODULES + MESH_MODULES + ROOFLINE_MODULES)
def test_training_modules_are_checked(rel):
    path = PORT / rel
    assert path.exists()
    if path.suffix == ".py":
        assert path in FILES
        assert not _imported_roots(path) & FORBIDDEN


def _entry_points():
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.lower import serving_plan
    from repro_torch.models.weights import (adamw_state_from_numpy,
                                            init_params, params_from_numpy)
    from repro_torch.train.step import init_train_state
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine,
                                          init_decode_state,
                                          init_paged_decode_state,
                                          make_serving_plan,
                                          prefill_request)
    cfg = configs.get_config("starcoder2-7b", smoke=True)
    ssm = configs.get_config("mamba2-130m", smoke=True)
    audio = configs.get_config("hubert-xlarge", smoke=True)
    vlm = configs.get_config("internvl2-2b", smoke=True)
    hybrid = configs.get_config("jamba-1.5-large-398b", smoke=True)
    return [
        lambda: serving_plan(cfg, 64),
        lambda: make_serving_plan(cfg, 64),
        lambda: init_params(cfg, torch.Generator()),
        lambda: params_from_numpy({}, cfg),
        lambda: init_decode_state(cfg, 1, 64),
        lambda: prefill_request(None, cfg, [1, 2], max_len=64),
        lambda: ContinuousBatchingEngine(None, cfg, batch_size=1,
                                         max_len=64),
        lambda: make_serving_plan(cfg, 64, paged=True, page_size=16),
        lambda: init_paged_decode_state(cfg, 1, 64, num_pages=4,
                                        page_size=16),
        lambda: PagedContinuousBatchingEngine(None, cfg, batch_size=1,
                                              max_len=64, page_size=16,
                                              num_pages=4),
        lambda: init_train_state(None, cfg),
        lambda: train.build(cfg, batch=2, seq=8, lr=1e-3, steps=1),
        lambda: train.train_loop(cfg, steps=1, batch=2, seq=8, lr=1e-3),
        lambda: adamw_state_from_numpy(0, {}, {}, cfg),
        lambda: serving_plan(ssm, 64),
        lambda: init_params(ssm, torch.Generator()),
        lambda: ContinuousBatchingEngine(None, ssm, batch_size=1,
                                         max_len=64),
        lambda: init_train_state(None, audio),
        lambda: init_decode_state(vlm, 1, 64),
        lambda: init_params(hybrid, torch.Generator()),
        lambda: ContinuousBatchingEngine(None, hybrid, batch_size=1,
                                         max_len=64),
    ]


@pytest.mark.parametrize("i", range(21))
def test_default_device_is_cuda_and_raises_without_it(i):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[i]()


def test_serve_main_defaults_to_cuda():
    from repro_torch.launch import serve
    assert serve.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--smoke"])


def test_train_main_defaults_to_cuda():
    from repro_torch.launch import train
    assert train.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--smoke", "--steps", "1"])


def test_train_mesh_defaults_to_cuda():
    """``--mesh`` counts the card's devices: without a card it raises
    before it starts a rank."""
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--smoke", "--steps", "1", "--mesh"])


def test_kernel_sources_name_what_they_replace():
    from repro_torch.kernels import build
    for name, (src, entry, argtypes) in build.KERNELS.items():
        text = (PORT / "kernels" / "csrc" / src).read_text()
        assert "Replaces the TPU kernel" in text and name in text
        assert "Bound on an H100" in text and "Design:" in text
        assert f'extern "C" int {entry}(' in text
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch"
    ssd = (PORT / "kernels" / "csrc" / "ssd_scan.cu").read_text()
    assert "src/repro/kernels/ssd_scan.py" in ssd and "at :102" in ssd


def test_tensor_core_kernels_are_defined_by_their_sources():
    from repro_torch.kernels import build
    for name, symbols in build.TENSOR_CORE_BODIES.items():
        text = (PORT / "kernels" / "csrc" / build.KERNELS[name][0]) \
            .read_text()
        assert 'extern "C" __global__' in text
        # the main-width instantiation, the one for any width, and the
        # training bodies' MLA widths (mma.cuh Width, where the body is
        # templated on it)
        for symbol, args in zip(symbols, (("true", "kD128"),
                                          ("false", "kAny"), ("kD192",))):
            assert any(f"_MMA_KERNEL({symbol}, {a}" in text for a in args)
    for name, symbols in build.WIDE_BODIES.items():
        text = (PORT / "kernels" / "csrc" / build.KERNELS[name][0]) \
            .read_text()
        for symbol in symbols:
            assert f"    {symbol}(" in text


REPORT = """\
ptxas info    : Compiling entry function 'fwd_mma_kernel_d128' for 'sm_90a'
ptxas info    : Function properties for fwd_mma_kernel_d128
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function 'fwd_mma_kernel_any' for 'sm_90a'
ptxas info    : Function properties for fwd_mma_kernel_any
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers
"""


def test_ptxas_usage_reads_one_kernel():
    from repro_torch.kernels import build
    assert build.ptxas_usage(REPORT, "fwd_mma_kernel_d128") == (168, 24)
    assert build.ptxas_usage(REPORT, "fwd_mma_kernel_any") == (160, 0)
    with pytest.raises(ValueError, match="fwd_mma_kernel"):
        build.ptxas_usage(REPORT, "fwd_mma_kernel")

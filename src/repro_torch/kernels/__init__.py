"""The port's kernels: three CUDA kernels written for Hopper, each
beside its plain PyTorch version, and the dispatch in ``ops``."""

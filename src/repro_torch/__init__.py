"""PyTorch/CUDA port of the layer-fused serving runtime.

A second package beside the JAX reference ``repro``: the same configs,
decision rule, model and continuous-batching engine in PyTorch, with the
TPU's Pallas kernels rewritten as CUDA kernels for the H100.  It imports
nothing of JAX or of ``repro``.  Entry points take ``device`` and
default to ``"cuda"``; ``device="cpu"`` runs the kernels' plain
PyTorch versions.
"""

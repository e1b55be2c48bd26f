"""The paper's own validation workload (Sec. III): CCT-like MHSA on
GAP8 -- an analytical-engine config, not a model.  8 heads, 32
embedding channels, projection space 32, seq 81 / 128.  The port's copy
of ``repro/configs/gap8_cct.py``, built on the port's DSE core."""

from repro_torch.core import accelerator, workload

SEQ_LENS = (81, 128)
N_HEADS = 8
D_MODEL = 32
D_HEAD = 32


def make_accelerator():
    return accelerator.gap8()


def make_workload(seq_len: int):
    return workload.cct_mhsa(seq_len, n_heads=N_HEADS, d_model=D_MODEL,
                             d_head=D_HEAD)

"""``python -m repro_torch.launch.train`` against ``python -m
repro.launch.train`` with the same arguments, fp32 on the CPU: the port's
``--arch`` takes every arch, as JAX's takes ``configs.list_archs()``.

Each launcher draws its own weights from seed 0 (the two packages'
generators differ), so the port's ``build`` is handed the JAX launcher's
(``init_train_state(PRNGKey(0))``, through ``params_from_numpy``); the
data, schedule and optimizer are each launcher's own.  The losses of
every step agree within 1e-5 relative, on deepseek-v3 (MLA, a dense
prefix, MoE), mamba2 (the plain SSD scan under autograd) and jamba (the
hybrid)."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import train as jax_train
from repro.train import step as jax_step

from repro_torch import configs
from repro_torch.launch import train as port_train
from repro_torch.models.weights import params_from_numpy

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_cli_losses_match_the_jax_launcher(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    want = []
    loop = jax_train.train_loop

    def recorded(*a, **kw):
        out = loop(*a, **kw)
        want.extend(out[1])
        return out

    monkeypatch.setattr(jax_train, "train_loop", recorded)
    jax_train.main(argv)

    jcfg = jax_configs.get_config(arch, smoke=True)
    jstate, _ = jax_step.init_train_state(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                               configs.get_config(arch, smoke=True),
                               device="cpu")
    build = port_train.build
    monkeypatch.setattr(port_train, "build",
                        lambda cfg, **kw: build(cfg, params=params, **kw))
    got = port_train.main(argv + ["--device", "cpu"])
    assert "done: 2 steps" in capsys.readouterr().out
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert arch in port_train.parser().format_help()

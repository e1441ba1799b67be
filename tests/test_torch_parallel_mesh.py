"""(e) of ``test_torch_parallel.py``: the port's training step on 2
spawned gloo ranks against JAX's training step in its data-parallel layout
(``Trainer.set_mesh``: the image tensors' rows sharded over a 2-device CPU
mesh, the state replicated), on ``test_torch_step.py``'s inputs and at its
tolerances (those of its single-device comparison: every info loss 1e-4
relative, the summed gradient 1e-3 x max|g| per leaf, the template 1e-6,
the parameters after Adam); the two ranks bitwise equal.  A file of its
own, so that the parallel tests spread over two workers.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_step as TS
import torch_dp_workers as W
from test_torch_parallel import assert_bitwise, load_ranks, spawn


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    yield
    torch.set_num_threads(n)


def test_trainer_step_dp2_matches_jax_mesh_step(tmp_path):
    """(e)"""
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    r = TS.jax_step(str(tmp_path / "scene"), mesh=mesh)
    inp = r["port_in"]
    spawn(W.port_step_rank, 2, inp, str(tmp_path))
    r0, r1 = load_ranks(str(tmp_path), 2)
    assert_bitwise(r0, r1, "the step")
    nets = W.avatar_nets(inp["state_dict"], inp["kwargs"])
    bank = {k: torch.tensor(v, requires_grad=True)
            for k, v in inp["bank"].items()}
    leaves = {**{f"nets.{k}": p for k, p in nets.named_parameters()},
              **{f"bank.{k}": p for k, p in bank.items()}}
    assert leaves.keys() == r0["values"].keys()
    with torch.no_grad():
        for k, p in leaves.items():
            p.copy_(r0["values"][k])
            p.grad = r0["grads"].get(k)
    r.update(info=r0["info"], nets=nets, bank=bank,
             tmp=SimpleNamespace(**r0["tmp"]))
    TS.assert_losses_match(r)
    TS.assert_template_matches(r)
    TS.assert_gradients_match(r)
    TS.assert_params_match(r)

"""`--remat` in the port: each encoder block rematerialized in the backward
(`torch.utils.checkpoint`, non-reentrant), on the CPU.

A remat pre-training step equals the plain step bit for bit in fp32 with
drop-path 0.1 drawn from one `torch.Generator` (the recompute must draw the
forward's masks), leaves the generator in the same state and calls the
forward kernels' wrappers again for the recompute; and both equal
`dig_tpu`'s step at ``remat=True`` (drop-path 0: the two packages' random
streams cannot match), within the bounds of
tests/test_torch_port_pretrain.py (`check_against_jax`).  Model and step:
tests/_torch_port_pretrain_step.py."""

import pytest
import torch

from _torch_port_pretrain_step import CFG, check_against_jax, jax_step, port_step
from dig_tpu_torch.models import vit as tvit
from dig_tpu_torch.models.rec_model import init_weights


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_remat():
    return jax_step(remat=True)


def _calls(depth, remat):
    """Wrapper calls of a step: the student's and the momentum branch's
    forwards, the student's backward and, under remat, the student's
    forwards once more (the momentum branch runs without gradients)."""
    fwd = (3 if remat else 2) * depth
    return dict(attention_lse_fwd=fwd, attention_lse_bwd=depth, layer_norm_fwd=2 * fwd,
                layer_norm_bwd=2 * depth)


def test_remat_step_equals_the_plain_step_bit_for_bit(jax_remat):
    runs = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(5)
        runs[remat] = port_step(jax_remat, gen, remat=remat, drop_path_rate=0.1)
        runs[remat]["gen_state"] = gen.get_state()
        assert runs[remat]["calls"] == _calls(CFG["encoder_depth"], remat)
    plain, remat = runs[False], runs[True]
    assert plain["metrics"] == remat["metrics"]
    assert sorted(plain["grads"]) == sorted(remat["grads"])
    for name, g in plain["grads"].items():
        assert torch.equal(g, remat["grads"][name]), name
    for name, p in plain["params"].items():
        assert torch.equal(p, remat["params"][name]), name
    assert torch.equal(plain["gen_state"], remat["gen_state"])
    # drop-path drew from the generator: another seed gives another step
    other = port_step(jax_remat, torch.Generator().manual_seed(6), remat=True,
                      drop_path_rate=0.1)
    assert other["metrics"]["loss"] != remat["metrics"]["loss"]


@pytest.mark.parametrize("remat", [False, True])
def test_remat_step_matches_jax_remat(jax_remat, remat):
    check_against_jax(jax_remat, port_step(jax_remat, remat=remat))


def test_remat_vision_transformer_matches_plain():
    """The fine-tuning encoder's `remat` (the JAX module's field, reached by
    no config): output and input gradient equal with dropout, attention
    dropout and drop-path drawn from a generator."""
    outs = {}
    for remat in (False, True):
        enc = tvit.VisionTransformer(embed_dim=64, depth=2, num_heads=1, drop_rate=0.1,
                                     attn_drop_rate=0.1, drop_path_rate=0.1, remat=remat)
        init_weights(enc, torch.Generator().manual_seed(0))
        x = torch.linspace(-1, 1, 2 * 32 * 128 * 3).reshape(2, 32, 128, 3).requires_grad_()
        y = enc(x, torch.Generator().manual_seed(1))
        y.square().sum().backward()
        outs[remat] = (y.detach(), x.grad, [p.grad for p in enc.parameters()])
    assert torch.equal(outs[False][0], outs[True][0])
    assert torch.equal(outs[False][1], outs[True][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[False][2], outs[True][2]))

"""The port's checkpoints: resume equivalence, the commit marker, fallback,
pruning, and the payload's way into the JAX package.

The semantics are those of `dig_tpu/utils/checkpoint.py` (and of
tests/test_resume_equivalence.py for the bit-equal resume); the payload is
the port's own `checkpoint.pth` in the reference `MoCo_ViT` layout.
Everything runs on the CPU in fp32 at the micro width.
"""

import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.models.registry import create_model as j_create_model
from dig_tpu.utils.checkpoint import convert_torch_moco, load_torch_checkpoint
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
from dig_tpu_torch.utils import checkpoint as ckpt
from dig_tpu_torch.utils.convert import load_pth
from dig_tpu_torch.utils.rng import step_generator
from dig_tpu_torch.utils.schedules import (
    contrast_weight_schedule,
    cosine_schedule,
    moco_momentum_schedule,
)

NAME = "pretrain_simmim_moco_ori_vit_micro_patch4_32x128"
MODEL_KW = dict(mlp_dim=32, dim=16, num_windows=4)
STEPS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(seed=0, drop_path_rate=0.1):
    """A fresh state and its step: seeded weights, AdamW with a warm-up and
    clipping, drop-path on so that the per-step generators matter."""
    model = build_pretrain_model(NAME, seed=seed, device="cpu", drop_path_rate=drop_path_rate,
                                 **MODEL_KW)
    opt = create_optimizer("adamw", model.named_parameters(),
                           cosine_schedule(1e-3, 1e-5, 1, STEPS, warmup_steps=1),
                           cosine_schedule(0.05, 0.05, 1, STEPS), clip_grad=3.0)
    step = make_pretrain_step(model, moco_momentum_schedule(0.99, 1, STEPS),
                              contrast_weight_schedule(0.1, 1, STEPS, warmup_steps=1))
    return init_pretrain_state(model, opt), step


def _batches():
    rng = np.random.default_rng(0)
    return [{"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": rng.random((4, 2, 256)) < 0.7} for _ in range(STEPS)]


def _run(state, step, batches, first):
    for i, batch in enumerate(batches, start=first):
        state, _ = step(state, batch, step_generator(1, 0, i))
    return state


def _assert_states_bitequal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb) and any(k.startswith("momentum_encoder.") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.inner.state_dict(), b.optimizer.inner.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and len(oa["state"]) > 0
    for i, moments in oa["state"].items():
        assert sorted(moments) == ["exp_avg", "exp_avg_sq", "step"]
        for name, t in moments.items():
            assert torch.equal(t, ob["state"][i][name]), (i, name)
    assert a.step == b.step and a.optimizer.count == b.optimizer.count


def test_pretrain_resume_bitequal(tmp_path):
    """save -> fresh state -> auto_resume -> continue equals the
    uninterrupted run bit for bit: parameters, momentum modules, AdamW
    moments and step tensors, the schedule index and the step counter."""
    batches = _batches()
    straight = _run(*_fresh(), batches, 0)

    state, step = _fresh()
    state = _run(state, step, batches[:2], 0)
    path = ckpt.save_checkpoint(str(tmp_path), 0, state, extra={"epoch": 0})
    assert sorted(os.listdir(path)) == ["checkpoint.pth", "meta.json"]
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == {"step": 2, "extra": {"epoch": 0}}

    # another seed: every restored tensor must come from the file
    resumed, step = _fresh(seed=5)
    resumed, extra = ckpt.auto_resume(str(tmp_path), resumed)
    assert extra == {"epoch": 0}
    assert resumed.step == 2 and resumed.optimizer.count == 2
    resumed = _run(resumed, step, batches[2:], 2)

    _assert_states_bitequal(straight, resumed)
    assert straight.step == STEPS
    # the momentum branch is its own tensors, not the student's, after the restore
    sd = resumed.model.state_dict()
    assert not torch.equal(sd["encoder.blocks.0.attn.qkv.weight"],
                           sd["momentum_encoder.blocks.0.attn.qkv.weight"])


def test_restore_keeps_the_runs_own_hyper_parameters(tmp_path):
    """The file gives AdamW's moments; betas, eps and the groups' scales
    stay those of the optimizer that resumes (the JAX package's optimizer
    state holds no hyper-parameter either)."""
    state, step = _fresh()
    state = _run(state, step, _batches()[:1], 0)
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    model = build_pretrain_model(NAME, seed=0, device="cpu", **MODEL_KW)
    opt = create_optimizer("adamw", model.named_parameters(), [1e-3], [0.05], eps=1e-3,
                           betas=(0.8, 0.9))
    resumed, _ = ckpt.auto_resume(str(tmp_path), init_pretrain_state(model, opt))
    for group in resumed.optimizer.inner.param_groups:
        assert group["eps"] == 1e-3 and group["betas"] == (0.8, 0.9)
    moments = resumed.optimizer.inner.state_dict()["state"]
    assert len(moments) > 0 and all(float(m["step"]) == 1.0 for m in moments.values())
    # another grouping of the parameters is refused, not mis-assigned
    other = create_optimizer("adamw", model.named_parameters(), [1e-3], [0.05], layer_decay=0.5,
                             num_layers=2)
    with pytest.raises(ValueError, match="groups its parameters differently"):
        ckpt.auto_resume(str(tmp_path), init_pretrain_state(model, other))


def test_restoring_before_init_would_lose_the_momentum_branch(tmp_path):
    """`init_pretrain_state` resets the momentum branch to the student, so
    the restore has to come after it."""
    state, step = _fresh()
    state = _run(state, step, _batches()[:2], 0)
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    payload = ckpt.restore_checkpoint(os.path.join(str(tmp_path), "checkpoint-0"))
    assert "extra" not in payload and payload["step"] == 2
    other, _ = _fresh(seed=5)
    ckpt.load_into_state(other, payload)
    key = "momentum_encoder.blocks.0.attn.qkv.weight"
    saved = other.model.state_dict()[key].clone()
    init_pretrain_state(other.model, other.optimizer)
    assert not torch.equal(other.model.state_dict()[key], saved)


def test_directory_without_meta_is_invisible(tmp_path):
    state, _ = _fresh()
    ckpt.save_checkpoint(str(tmp_path), 0, state, extra={"epoch": 0})
    ckpt.save_checkpoint(str(tmp_path), 1, state, extra={"epoch": 1})
    os.remove(tmp_path / "checkpoint-1" / "meta.json")  # a save killed before its commit
    assert ckpt.numeric_checkpoints(str(tmp_path)) == [str(tmp_path / "checkpoint-0")]
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-0")
    _, extra = ckpt.auto_resume(str(tmp_path), state)
    assert extra == {"epoch": 0}
    assert ckpt.latest_checkpoint(str(tmp_path / "nowhere")) is None
    fresh, _ = _fresh()
    assert ckpt.auto_resume(str(tmp_path / "nowhere"), fresh) == (fresh, None)


def test_corrupt_newest_falls_back_to_the_one_before(tmp_path, capsys):
    state, step = _fresh()
    ckpt.save_checkpoint(str(tmp_path), 0, state, extra={"epoch": 0})
    state = _run(state, step, _batches()[:1], 0)
    ckpt.save_checkpoint(str(tmp_path), 1, state, extra={"epoch": 1})
    with open(tmp_path / "checkpoint-1" / "checkpoint.pth", "wb") as f:
        f.write(b"truncated")
    resumed, _ = _fresh(seed=5)
    resumed, extra = ckpt.auto_resume(str(tmp_path), resumed)
    assert extra == {"epoch": 0} and resumed.step == 0
    out = capsys.readouterr().out
    assert "auto-resume failed" in out and "checkpoint-1" in out and "auto-resumed from" in out


def test_prune_keeps_newest_and_non_numeric_tags(tmp_path):
    state, _ = _fresh()
    for tag in (0, 1, 2, 3, "best", "2_100"):
        ckpt.save_checkpoint(str(tmp_path), tag, state)
    assert ckpt.prune_checkpoints(str(tmp_path), 0) == []
    assert ckpt.prune_checkpoints(str(tmp_path), 2) == ["checkpoint-0", "checkpoint-1"]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-2_100", "checkpoint-3",
                                            "checkpoint-best"]
    assert ckpt.prune_checkpoints(str(tmp_path), 5) == []
    assert [os.path.basename(p) for p in ckpt.numeric_checkpoints(str(tmp_path))] == \
        ["checkpoint-3", "checkpoint-2"]


def test_save_leaves_no_temporary_file_and_overwrites(tmp_path):
    state, step = _fresh()
    ckpt.save_checkpoint(str(tmp_path), 0, state, extra={"epoch": -1})
    state = _run(state, step, _batches()[:1], 0)
    path = ckpt.save_checkpoint(str(tmp_path), 0, state, extra={"epoch": 0})
    assert sorted(os.listdir(path)) == ["checkpoint.pth", "meta.json"]
    payload = ckpt.restore_checkpoint(path)
    assert payload["step"] == 1 and payload["extra"] == {"epoch": 0}
    assert sorted(payload) == ["extra", "model", "optimizer", "step"]
    assert payload["optimizer"]["count"] == 1


def test_unreadable_checkpoints_are_refused(tmp_path, monkeypatch):
    """Remote URIs and native directories are read now
    (tests/test_torch_port_remote_native.py); what stays unreadable is
    refused with a message: a remote URI where fsspec cannot be imported
    (the message names the package, and the error comes before any
    filesystem is touched), and a native directory whose pickle is not a
    JAX treedef or whose leaves do not match it."""
    state, _ = _fresh()
    monkeypatch.setitem(sys.modules, "fsspec", None)  # import fsspec -> ImportError
    for call in (lambda: ckpt.save_checkpoint("memory://bucket/run", 0, state),
                 lambda: ckpt.restore_checkpoint("memory://bucket/run/checkpoint-0"),
                 lambda: ckpt.auto_resume("memory://bucket/run", state),
                 lambda: ckpt.prune_checkpoints("memory://bucket/run", 1)):
        with pytest.raises(ImportError, match="fsspec"):
            call()
    native = tmp_path / "checkpoint-7"
    native.mkdir()
    np.savez(native / "arrays.npz", leaf_0=np.zeros(2))
    (native / "treedef.pkl").write_bytes(pickle.dumps({"not": "a treedef"}))
    (native / "meta.json").write_text('{"step": 1}')
    with pytest.raises(ValueError, match="PyTreeDef"):
        ckpt.restore_checkpoint(str(native))
    (native / "treedef.pkl").write_bytes(pickle.dumps(print))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        ckpt.restore_checkpoint(str(native))


def test_payload_loads_with_weights_only(tmp_path):
    """The payload holds tensors, numbers and containers of them: torch's
    restricted unpickler reads it, and refuses a pickle that is more."""
    state, _ = _fresh()
    path = ckpt.save_checkpoint(str(tmp_path), 0, state)
    torch.load(os.path.join(path, "checkpoint.pth"), weights_only=True)
    torch.save({"model": {}, "optimizer": {"inner": {}, "count": 0}, "step": 0, "fn": print},
               os.path.join(path, "checkpoint.pth"))
    with pytest.raises(Exception, match="(?i)weights_only|unsupported|unpickl"):
        ckpt.restore_checkpoint(path)


def test_checkpoint_pth_enters_the_jax_package(tmp_path):
    """`checkpoint.pth` through the JAX package's `.pth` loader and
    `convert_torch_moco` into its model: the same forward, student and
    momentum branch; and through the port's own `load_pth`."""
    state, step = _fresh(drop_path_rate=0.0)
    state = _run(state, step, _batches()[:2], 0)  # the momentum branch has left the student
    path = os.path.join(ckpt.save_checkpoint(str(tmp_path), 0, state), "checkpoint.pth")

    sd = load_pth(path)
    want = state.model.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k].float()) for k in want)

    trees = convert_torch_moco(load_torch_checkpoint(path))
    jm = j_create_model(NAME, **MODEL_KW)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (4, 32, 128, 3)).astype(np.float32)
    mask = rng.random((4, 256)) < 0.7
    jout = jm.apply({"params": trees["student"]}, jnp.asarray(x), jnp.asarray(mask), True,
                    method=jm.forward_student)
    jk = jm.apply({"params": trees["ema"]}, jnp.asarray(x), jnp.asarray(mask), True,
                  method=jm.forward_key)
    model = state.model.eval()
    with torch.no_grad():
        tout = model.forward_student(torch.from_numpy(x), torch.from_numpy(mask))
    tk = model.forward_key(torch.from_numpy(x), torch.from_numpy(mask))
    # fp32, two blocks of width 64 and batch normalisations over 8-16 rows:
    # within 1e-5 of each output's largest value
    pairs = [(tout[n], jout[n]) for n in ("q1", "q2", "pix_pred")] + list(zip(tk, jk))
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = float(np.abs(got.numpy() - ref).max())
        assert got.shape == ref.shape and err <= 1e-5 * float(np.abs(ref).max()), err

"""Remote checkpoint URIs and native `dig_tpu` checkpoint directories in the
port, on the CPU.

Remote: a save / list / prune / auto-resume / restore round trip on
fsspec's in-memory filesystem (``memory://``), a partial save (no
``meta.json``) skipped; and, in a fresh interpreter where fsspec cannot be
imported, the port imports and checkpoints a local run.  Native:
directories written by `dig_tpu.utils.checkpoint.save_checkpoint` (a
pre-training state and a recognizer's) read by the port in a fresh
interpreter that never lets ``jax`` into `sys.modules`, every leaf equal to
`dig_tpu`'s own restore carried by the converters; `run_predict --resume
<native>` writes `dig_tpu`'s TSV; other optimizer states and malformed
trees are refused with a message."""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.models import moco as jmoco
from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.train.finetune import init_finetune_state as j_init_finetune_state
from dig_tpu.train.pretrain import init_pretrain_state as j_init_pretrain_state
from dig_tpu.utils.checkpoint import restore_checkpoint as j_restore_checkpoint
from dig_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils import checkpoint as ckpt
from dig_tpu_torch.utils import native_ckpt
from dig_tpu_torch.utils.convert import moco_params_from_jax, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "pretrain_simmim_moco_ori_vit_micro_patch4_32x128"
KW = dict(mlp_dim=32, dim=16, num_windows=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _state(seed=0):
    model = build_pretrain_model(NAME, seed=seed, device="cpu", **KW)
    return TrainState(model=model, optimizer=create_optimizer(
        "lamb", model.named_parameters(), [1e-3], [0.05]), step=0)


def _states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["inner"]["state"], b.optimizer.state_dict()["inner"]["state"]
    assert all(torch.equal(x, y) for k in oa for x, y in zip(oa[k], ob[k]))


def test_remote_round_trip_on_memory_filesystem(tmp_path):
    """Save three checkpoints to ``memory://``, one left partial; list, prune
    to two, auto-resume the newest complete one, restore bit for bit."""
    import fsspec

    url = f"memory://remote-ckpt-{os.getpid()}/run"
    state = _state()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.25)
    state.optimizer.count, state.step = 3, 3
    paths = [ckpt.save_checkpoint(url, n, state, extra={"epoch": n}) for n in (0, 1, 2)]
    assert paths[2] == f"{url}/checkpoint-2"
    fs, root = fsspec.core.url_to_fs(url)
    fs.rm(f"{root}/checkpoint-2/meta.json")  # a save killed before its commit marker
    assert ckpt.numeric_checkpoints(url) == [f"{url}/checkpoint-1", f"{url}/checkpoint-0"]
    assert ckpt.latest_checkpoint(url) == f"{url}/checkpoint-1"
    fs.makedirs(f"{root}/checkpoint-best", exist_ok=True)
    fs.pipe(f"{root}/checkpoint-best/meta.json", b"{}")
    assert ckpt.prune_checkpoints(url, 2) == ["checkpoint-0"]
    assert sorted(p.rsplit("/", 1)[-1] for p in fs.ls(root, detail=False)) == [
        "checkpoint-1", "checkpoint-2", "checkpoint-best"]
    resumed, extra = ckpt.auto_resume(url, _state(seed=1))
    assert extra == {"epoch": 1} and resumed.step == 3 and resumed.optimizer.count == 3
    _states_equal(resumed, state)
    payload = ckpt.restore_checkpoint(f"{url}/checkpoint-1")
    assert payload["step"] == 3 and payload["extra"] == {"epoch": 1}
    # a remote .pth for --finetune
    pth = f"memory://remote-ckpt-{os.getpid()}/w.pth"
    with fs.open(pth.split("://")[1], "wb") as f:
        torch.save({"model": state.model.state_dict()}, f)
    sd = ckpt.load_torch_checkpoint(pth)
    assert all(torch.equal(sd[k], v) for k, v in state.model.state_dict().items())
    assert ckpt.auto_resume(f"memory://remote-ckpt-{os.getpid()}/none", _state())[1] is None


def _run(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_a_local_run_needs_no_fsspec(tmp_path):
    """fsspec made unimportable before the port is imported: every module
    imports, and a local save / auto-resume runs; a remote path raises a
    message that names the package."""
    _run(f"""
import sys, importlib, pkgutil
sys.modules["fsspec"] = None
import dig_tpu_torch
for m in pkgutil.walk_packages(dig_tpu_torch.__path__, "dig_tpu_torch."):
    importlib.import_module(m.name)
import torch
from dig_tpu_torch.models.moco import build_pretrain_model
from dig_tpu_torch.optim import create_optimizer
from dig_tpu_torch.train.state import TrainState
from dig_tpu_torch.utils import checkpoint as ckpt
m = build_pretrain_model({NAME!r}, device="cpu", mlp_dim=32, dim=16, num_windows=4)
st = TrainState(model=m, optimizer=create_optimizer("adamw", m.named_parameters(), [1e-3]))
ckpt.save_checkpoint({str(tmp_path)!r}, 0, st)
assert ckpt.auto_resume({str(tmp_path)!r}, st)[0].step == 0
try:
    ckpt.restore_checkpoint("memory://x/checkpoint-0")
except ImportError as e:
    assert "fsspec" in str(e), e
else:
    raise AssertionError("a remote path without fsspec did not raise")
assert sys.modules["fsspec"] is None
""")
    assert os.path.exists(tmp_path / "checkpoint-0" / "meta.json")


def _jax_pretrain_native(root, opt="adamw"):
    jm = jmoco.DiGPretrainModel(img_size=(32, 128), patch_size=4, encoder_embed_dim=64,
                                encoder_depth=2, encoder_num_heads=2, **KW)
    tx = j_create_optimizer(opt, np.full(4, 1e-3, np.float32), np.full(4, 0.05, np.float32))
    state = j_init_pretrain_state(jm, tx, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    perturb = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.normal(size=np.shape(x))
                              .astype(np.asarray(x).dtype)), t)
    state = state.replace(params=perturb(state.params), ema_params=perturb(state.ema_params),
                          opt_state=perturb(state.opt_state), step=jnp.asarray(3, jnp.int32))
    return j_save_checkpoint(str(root), 3, state, extra={"epoch": 0})


def _jax_rec_native(root):
    jm = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder")
    tx = j_create_optimizer("adamw", np.full(4, 1e-3, np.float32))
    state = j_init_finetune_state(jm, tx, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.normal(size=np.shape(x))
                              .astype(np.float32)), state.params))
    return j_save_checkpoint(str(root), 1, state)


@pytest.fixture(scope="module")
def natives(tmp_path_factory):
    root = tmp_path_factory.mktemp("natives")
    return {"pretrain": _jax_pretrain_native(root / "pre"), "rec": _jax_rec_native(root / "rec")}


def test_native_directories_are_read_without_jax(natives, tmp_path):
    """The port, in an interpreter where ``jax`` is made unimportable, reads
    both directories: every tensor equal to `dig_tpu`'s restore carried by
    `moco_params_from_jax` / `params_from_jax`, and AdamW's moments."""
    out = tmp_path / "read.pt"
    _run(f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "dig_tpu"):
    sys.modules[name] = None
import torch
from dig_tpu_torch.utils import checkpoint as ckpt, native_ckpt
res = {{}}
for kind, path in (("pretrain", {natives["pretrain"]!r}), ("rec", {natives["rec"]!r})):
    p = ckpt.restore_checkpoint(path)
    trees = p["native"]
    inner = trees["opt_state"]["inner"]
    res[kind] = dict(model=native_ckpt.model_state_dict(trees, kind == "pretrain"),
                     step=p["step"], extra=p.get("extra"), inner=inner.qualname,
                     mu=native_ckpt.model_state_dict(dict(params=inner.field("mu")), False)
                     if kind == "rec" else None)
assert all(sys.modules.get(n) is None for n in ("jax", "jaxlib", "flax", "optax"))
torch.save(res, {str(out)!r})
""")
    got = torch.load(out, weights_only=False)
    jp = j_restore_checkpoint(natives["pretrain"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = moco_params_from_jax(as_np(jp["params"]), as_np(jp["ema_params"]))
    assert sorted(got["pretrain"]["model"]) == sorted(want)
    assert all(torch.equal(got["pretrain"]["model"][k], want[k]) for k in want)
    assert got["pretrain"]["step"] == 3 and got["pretrain"]["extra"] == {"epoch": 0}
    assert got["pretrain"]["inner"] == "optax._src.transform.ScaleByAdamState"
    jr = j_restore_checkpoint(natives["rec"])
    want = params_from_jax(as_np(jr["params"]))
    assert all(torch.equal(got["rec"]["model"][k], want[k]) for k in want)
    mu = params_from_jax(as_np(jr["opt_state"]["inner"].mu))
    assert all(torch.equal(got["rec"]["mu"][k], mu[k]) for k in mu)


def test_native_pretrain_state_loads_into_the_port(natives):
    """`load_into_state`: parameters, momentum branch, AdamW's moments
    (mu -> exp_avg, nu -> exp_avg_sq), its step tensors, the count and the
    step, each equal to `dig_tpu`'s restore carried by the converters."""
    model = build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128", device="cpu",
                                 **KW)
    state = TrainState(model=model, optimizer=create_optimizer(
        "adamw", model.named_parameters(), [1e-3]))
    ckpt.load_into_state(state, ckpt.restore_checkpoint(natives["pretrain"]))
    jp = j_restore_checkpoint(natives["pretrain"])
    inner = jp["opt_state"]["inner"]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    mu, nu = moco_params_from_jax(as_np(inner.mu), {}), moco_params_from_jax(as_np(inner.nu), {})
    opt = state.optimizer
    assert state.step == 3 and opt.count == int(jp["opt_state"]["count"])
    for name, p in zip(opt.names, opt.params):
        st = opt.inner.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == float(inner.count)
    want = moco_params_from_jax(as_np(jp["params"]), as_np(jp["ema_params"]))
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_other_native_optimizer_states_are_refused(tmp_path):
    """A native directory saved with `--opt sgd`: its state is read, and
    resuming the port's optimizer from it is refused naming its class."""
    path = _jax_pretrain_native(tmp_path, opt="sgd")
    model = build_pretrain_model(NAME, device="cpu", **KW)
    state = TrainState(model=model, optimizer=create_optimizer(
        "adamw", model.named_parameters(), [1e-3]))
    with pytest.raises(ValueError, match="TraceState"):
        ckpt.load_into_state(state, ckpt.restore_checkpoint(path))


def test_malformed_native_trees_are_refused(natives, tmp_path):
    """An unknown node kind, a custom node the port cannot read, and a leaf
    count that differs from ``arrays.npz`` raise with a message."""
    with pytest.raises(ValueError, match="unknown kind 9"):
        native_ckpt._unflatten([(9, 0, None, None, 0, 1)], [])
    custom = native_ckpt._Global("flax.struct", "PyTreeNode")
    with pytest.raises(ValueError, match="custom node flax.struct.PyTreeNode"):
        native_ckpt._unflatten([(0, 0, None, None, 1, 1), (6, 1, None, custom, 1, 2)],
                               [np.zeros(1)])
    bad = tmp_path / "checkpoint-1"
    bad.mkdir()
    src = natives["rec"]
    for name in ("treedef.pkl", "meta.json"):
        (bad / name).write_bytes(open(os.path.join(src, name), "rb").read())
    with np.load(os.path.join(src, "arrays.npz")) as z:
        leaves = {k: z[k] for k in z.files}
    leaves.pop(f"leaf_{len(leaves) - 1}")
    np.savez(bad / "arrays.npz", **leaves)
    with pytest.raises(ValueError, match="leaves, arrays.npz"):
        ckpt.restore_checkpoint(str(bad))


def test_predict_resume_native_writes_the_jax_tsv(natives, tmp_path):
    """`run_predict --resume <native>` in both packages on 6 PNGs: the same
    names and texts, confidences to their printed 4 decimals (one unit of
    slack), as tests/test_torch_port_predict.py holds the `.pth` route."""
    from dig_tpu.cli.run_predict import main as j_main
    from dig_tpu.config import PredictConfig as JPredictConfig
    from dig_tpu_torch.cli.run_predict import main as t_main
    from dig_tpu_torch.config import PredictConfig

    rng = np.random.default_rng(5)
    (tmp_path / "imgs").mkdir()
    for i in range(6):
        img = rng.integers(0, 256, (32, 80 + 8 * i, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "imgs" / f"{i}.png"), img)
    common = dict(model="vit_micro_patch4_32x128", decoder_name="small_tf_decoder",
                  batch_size=4, dtype="float32", images=[str(tmp_path / "imgs")],
                  resume=natives["rec"], exact_gelu=False, num_workers=2)
    assert j_main(JPredictConfig(output=str(tmp_path / "jax.tsv"), **common)) == 6
    assert t_main(PredictConfig(output=str(tmp_path / "port.tsv"), **common), device="cpu") == 6
    jl = (tmp_path / "jax.tsv").read_text().splitlines()
    tl = (tmp_path / "port.tsv").read_text().splitlines()
    assert len(jl) == len(tl) == 6
    for a, b in zip(jl, tl):
        (na, ta, ca), (nb, tb, cb) = a.split("\t"), b.split("\t")
        assert (na, ta) == (nb, tb)
        assert abs(float(ca) - float(cb)) <= 1e-4

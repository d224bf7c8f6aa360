"""Where the pre-training step's fp32 gradients part between the packages
at a ReLU's kink (not collected: a probe, run by hand on the CPU).

    JAX_PLATFORMS=cpu python tests/_torch_port_relu_kink.py [--seed 21] [--conv]
    JAX_PLATFORMS=cpu python tests/_torch_port_relu_kink.py --search 800 [--conv]

The step of tests/_torch_port_pretrain_step.py (batch 2, or the conv
extractor's batch 6 with ``--conv``) on the draw of perturbation seed
``--seed``, its margin precondition not asserted.  Every affine
`BatchStatsNorm` output of `dig_tpu`'s jitted step (each feeds a ReLU) is
captured by `jax.debug.callback`, which leaves the step's gradients
unchanged; the port's ReLU inputs by hooks.  For each ReLU of the
student's heads it prints: the smallest |x| on each side and how many
elements differ in sign, the largest cross-package difference and the
port's own fp32 rounding (against the model built in fp64), all in fp32
ulps of the tensor's largest |x|, and the margin `assert_relu_margin`
asks.  Then the gradient leaves over their `check_against_jax` bounds and,
if some element differs in sign, the same with `dig_tpu`'s mask forced on
those ReLUs of the port.  ``--search N`` instead counts, over the seeds
below N, the draws that meet `assert_relu_margin` and those that would
meet a margin of all of the port's rounding, and names the seeds with the
most room."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_port_pretrain_step as H  # noqa: E402
from dig_tpu.models import moco as jmoco  # noqa: E402
from dig_tpu_torch.models import moco as tmoco  # noqa: E402
from dig_tpu_torch.utils.convert import moco_params_from_jax  # noqa: E402

# dig_tpu's BatchStatsNorm (by scope path) -> the port's ReLU that takes its output
RELU_OF = {"pix_projector/bn_0": "pix_projector.2", "pix_projector/bn_1": "pix_projector.5",
           "projection/bn_0": "encoder_projection_layer.2",
           "projection/bn_1": "encoder_projection_layer.5", "predictor/bn_0": "predictor.2",
           "patch_extractor/c0_bn": "patch_extractor.conv_layers.0.2",
           "patch_extractor/c1_bn": "patch_extractor.conv_layers.2.2",
           "patch_extractor/c2_bn": "patch_extractor.conv_layers.4.2",
           "patch_extractor/c3_bn": "patch_extractor.conv_layers.6.2",
           "patch_extractor/p2g_bn0": "patch_extractor.patches2global.2"}


def jax_step_captured(b, seed, **kw):
    """`H.jax_step` on seed `seed`, and every affine BN output of its step
    by scope path (the student's and the momentum branch's)."""
    caps, real = [], jmoco.BatchStatsNorm.__call__

    def call(self, x):
        y = real(self, x)
        if self.affine:
            path = "/".join(self.scope.path)
            jax.debug.callback(lambda v, p=path: caps.append((p, np.asarray(v))), y)
        return y

    jmoco.BatchStatsNorm.__call__ = call
    saved = H.SEEDS, H.check_relu_margin
    H.SEEDS = dict.fromkeys(H.SEEDS, seed)
    H.check_relu_margin = lambda *a, **k: None
    try:
        run = H.jax_step(b, **kw)
    finally:
        jmoco.BatchStatsNorm.__call__ = real
        H.SEEDS, H.check_relu_margin = saved
    out = {}
    for path, v in caps:
        out.setdefault(path, []).append(v)
    return run, out


class MaskedReLU(torch.nn.Module):
    def __init__(self, mask):
        super().__init__()
        self.mask = torch.from_numpy(mask)

    def forward(self, x):
        return x * self.mask.to(x.dtype)


def over_bounds(jax_run, port_run):
    """Gradient leaves over `check_against_jax`'s bound, by err / bound."""
    floor = 1e-6 * max(float(g.abs().max()) for g in jax_run["grads"].values())
    ratio = {n: float((port_run["grads"][n].double() - g.double()).abs().max())
             / (1e-4 * float(g.abs().max()) + floor) for n, g in jax_run["grads"].items()}
    return sorted(((r, n) for n, r in ratio.items()), reverse=True)


def search(n, b, **kw):
    """Port-side only: each seed's room, the least of closest |x| / margin
    over the student's ReLU inputs, under the check's margin and under all
    of the rounding."""
    jm = jmoco.DiGPretrainModel(**H.CFG, **kw)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((2 * b, 32, 128, 3)),
                   jnp.zeros((2 * b, 256), bool), True)["params"]
    model = tmoco.DiGPretrainModel(**H.CFG, **kw)
    model64 = tmoco.DiGPretrainModel(**H.CFG, **kw, dtype=torch.float64).double()
    forward = H.pretrain_forward(H.batch(b))
    room = {}
    for seed in range(n):
        params = H.perturb(init, seed)
        state = moco_params_from_jax(params, H.perturb({k: params[k]
                                                        for k in jm.ema_submodules()}, 22))
        model.load_state_dict(state)
        model64.load_state_dict(state)
        x32 = H.student_relu_inputs(model, forward)
        x64 = H.student_relu_inputs(model64, forward)
        share, full = [], []
        for name, x in x32.items():
            ulp = float(np.spacing(np.float32(x.abs().max())))
            rounding = float((x.double() - x64[name]).abs().max())
            closest = float(x.abs().min())
            share.append(closest / max(H.RELU_MARGIN_ULPS * ulp, H.ROUNDING_SHARE * rounding))
            full.append(closest / max(H.RELU_MARGIN_ULPS * ulp, rounding))
        room[seed] = (min(share), min(full))
    best = sorted(room, key=lambda s: -room[s][0])[:5]
    print(f"batch {b}{' conv' if kw else ''}, seeds 0-{n - 1}: "
          f"{sum(r[0] >= 1 for r in room.values())} meet the check's margin, "
          f"{sum(r[1] >= 1 for r in room.values())} all of the rounding; most room: "
          + ", ".join(f"{s} ({room[s][0]:.2f}x)" for s in best))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--conv", action="store_true")
    ap.add_argument("--search", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    b, kw = (6, dict(patchnet_name="conv")) if args.conv else (H.B, {})
    if args.search:
        return search(args.search, b, **kw)
    jax_run, caps = jax_step_captured(b, args.seed, **kw)
    state = moco_params_from_jax(jax_run["params"], jax_run["ema"])
    model = tmoco.DiGPretrainModel(**H.CFG, **kw)
    model.load_state_dict(state)
    model64 = tmoco.DiGPretrainModel(**H.CFG, **kw, dtype=torch.float64).double()
    model64.load_state_dict(state)
    forward = H.pretrain_forward(jax_run["batch"])
    x32 = H.student_relu_inputs(model, forward)
    x64 = H.student_relu_inputs(model64, forward)
    print(f"seed {args.seed}, batch {b}{' conv' if args.conv else ''}: ulps of each tensor's "
          f"largest |x|")
    masks = {}
    for path, relu in RELU_OF.items():
        if relu not in x32:
            continue
        t = x32[relu].numpy()
        # the student's capture: the one nearest the port's student input
        j = min(caps[path], key=lambda v: float(np.abs(v.reshape(t.shape) - t).max()))
        j = j.reshape(t.shape)
        ulp = float(np.spacing(np.float32(np.abs(t).max())))
        rounding = float((x32[relu].double() - x64[relu]).abs().max()) / ulp
        flips = (j > 0) != (t > 0)
        print(f"  {relu:34s} {t.size:7d} inputs: closest port {np.abs(t).min() / ulp:.2f} / "
              f"dig_tpu {np.abs(j).min() / ulp:.2f}; sign differs at {int(flips.sum())}"
              f"{' (port ' + str(t[flips]) + ', dig_tpu ' + str(j[flips]) + ')' if flips.any() else ''}; "
              f"packages part by <= {np.abs(j - t).max() / ulp:.1f}; port fp32 vs fp64 "
              f"{rounding:.1f}; margin {max(H.RELU_MARGIN_ULPS, H.ROUNDING_SHARE * rounding):.1f}")
        if flips.any():
            masks[relu] = j > 0
    port_run = H.port_step(jax_run, **kw)
    over = over_bounds(jax_run, port_run)
    print(f"leaves over their bound: {sum(r > 1 for r, _ in over)}; worst "
          + ", ".join(f"{n} {r:.2f}x" for r, n in over[:4]))
    if masks:
        real_init = tmoco.DiGPretrainModel.__init__

        def init(self, *a, **k):
            real_init(self, *a, **k)
            mods = dict(self.named_modules())
            for relu, mask in masks.items():
                parent, idx = relu.rsplit(".", 1)
                setattr(mods[parent], idx, MaskedReLU(mask))

        tmoco.DiGPretrainModel.__init__ = init
        try:
            forced = H.port_step(jax_run, **kw)
        finally:
            tmoco.DiGPretrainModel.__init__ = real_init
        over = over_bounds(jax_run, forced)
        print(f"with dig_tpu's mask on {sorted(masks)}: leaves over their bound: "
              f"{sum(r > 1 for r, _ in over)}; worst "
              + ", ".join(f"{n} {r:.2f}x" for r, n in over[:4]))
        H.check_against_jax(jax_run, forced)
        print("check_against_jax passes with dig_tpu's mask")


if __name__ == "__main__":
    main()

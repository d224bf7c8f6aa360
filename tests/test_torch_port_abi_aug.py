"""The port's on-device ABINet augmentation (`device_abi_augment`) against
the JAX package's, on the CPU, through the port's seams.

torch's Philox and JAX's threefry draw different numbers, so the test
repeats the JAX package's own draws (the key splits and calls of
`dig_tpu/data/device_aug.py:123-384`; `bernoulli` and `beta` are called
themselves) and hands them to the port as `params`.

Everything is fp32.  The pieces, given the same matrices and draws, agree
within 1e-5 absolute (values in [-1, 1]): the warps' source coordinates are
summed in the order of the JAX package's fp32 matrix product.  So does the
whole view given JAX's homographies and JAX's cos and sin (`_jax_trig`).
The matrices from the draws agree only to rounding (cos, sin and tan differ
by an ulp or two between libms, and the perspective's 8 x 8 solve is
another LU than XLA's), to what `test_geometry_matrices_from_the_jax_draws`
accepts; a view made with the port's own matrices and trigonometry is held
to the bound that their difference, checked against that tolerance, carries
through the warps (`_own_trig_atol`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.data import device_aug as jaug
from dig_tpu_torch.data import device_aug as taug


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


PIECE_ATOL = 1e-5
# what test_geometry_matrices_from_the_jax_draws accepts of an entry
# (relative; absolute at a hundredth of it): rotation and affine matrices,
# whose trigonometry is also what cos and sin are held to here, and the
# perspective's solve
TRIG_RTOL, PERSP_RTOL = 1e-5, 1e-4
B, H, W = 12, 32, 128


def _images(seed, b=B, smooth=True):
    rng = np.random.default_rng(seed)
    if smooth:  # low-pass content, as a word image has
        x = rng.uniform(-1, 1, (b, H // 4, W // 4, 3))
        x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)
    else:
        x = rng.uniform(-1, 1, (b, H, W, 3))
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= atol, f"max abs err {err:.3e} > {atol}"
    return err


def _jax_params(key, b, h=H, w=W, c=3, p_geom=0.5, p_deter=0.25, p_jitter=0.25):
    """The JAX package's draws of one `device_abi_augment(key, ...)` call,
    under the port's names."""
    a = lambda x: np.asarray(x, np.float32).reshape(b, *np.shape(x)[1:]) if np.ndim(x) else x
    flat = lambda x: np.asarray(x).reshape(b)
    keys = jax.random.split(key, 14)
    uni = lambda k, shape, lo, hi: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    k_rot = jax.random.split(keys[0], 4)
    k_aff = jax.random.split(keys[1], 4)
    kh, kw = jax.random.split(keys[2])
    op_keys = jax.random.split(keys[5], 3)
    kv, kn = jax.random.split(op_keys[0])
    kb1, kb2 = jax.random.split(op_keys[1])
    k_hue, k_gate = jax.random.split(keys[13])
    return {
        "rot_angle": uni(k_rot[0], (b,), -45.0, 45.0),
        "aff_angle": uni(k_aff[0], (b,), -45.0, 45.0),
        "aff_scale": uni(k_aff[1], (b,), 0.5, 2.0),
        "aff_shear_x": uni(k_aff[2], (b,), -45.0, 45.0),
        "aff_shear_y": uni(k_aff[3], (b,), -15.0, 15.0),
        "persp_noise_h": a(jax.random.normal(kh, (b, 4))),
        "persp_noise_w": a(jax.random.normal(kw, (b, 4))),
        "geom_choice": flat(uni(keys[3], (b, 1, 1), 0.0, 1.0)),
        "geom_gate": flat(jax.random.bernoulli(keys[4], p_geom, (b, 1, 1, 1))),
        "noise_beta": flat(jax.random.beta(kv, 1.0, 4.0, (b, 1, 1, 1))),
        "noise": a(jax.random.normal(kn, (b, h, w, c))),
        "blur_angle": uni(kb1, (b,), -jnp.pi / 2, jnp.pi / 2),
        "blur_beta": np.asarray(jax.random.beta(kb2, 1.0, 4.0, (b,))),
        "rescale_f": flat(uni(op_keys[2], (b, 1, 1, 1), 0.0, 4.0)),
        "deter_order": int(jax.random.randint(keys[6], (), 0, 6)),
        "deter_gate": flat(jax.random.bernoulli(keys[9], p_deter, (b, 1, 1, 1))),
        "brightness": flat(uni(keys[10], (b, 1, 1, 1), 0.5, 1.5)),
        "contrast": flat(uni(keys[11], (b, 1, 1, 1), 0.5, 1.5)),
        "saturation": flat(uni(keys[12], (b, 1, 1, 1), 0.5, 1.5)),
        "hue": np.asarray(jax.random.uniform(k_hue, (b,), minval=-0.1, maxval=0.1) * 2 * jnp.pi),
        "jitter_gate": flat(jax.random.bernoulli(k_gate, p_jitter, (b, 1, 1, 1))),
    }


def _as_port(params):
    return {k: v if isinstance(v, int) else _t(v) for k, v in params.items()}


def _jax_trig(monkeypatch):
    """Route torch's cos and sin through XLA's for the rest of the test:
    two libms may differ in the last bit of each."""
    for name in ("cos", "sin"):
        f = getattr(jnp, name)
        monkeypatch.setattr(torch, name,
                            lambda t, f=f: torch.from_numpy(np.array(f(jnp.asarray(t.numpy())))))


def _jax_homographies(key, b=B, h=H, w=W):
    """The homography `jaug.device_abi_augment(key, ...)` warps each sample
    with, and the draw that chose it."""
    keys = jax.random.split(key, 14)
    rot = jaug._center_to_corner(jaug._affine_to_h(
        jaug._rand_abi_affine_mats(keys[0], b, h, w, rotation_only=True)), h, w)
    aff = jaug._center_to_corner(jaug._affine_to_h(jaug._rand_abi_affine_mats(keys[1], b, h, w)),
                                 h, w)
    per = jaug._rand_perspective_h(keys[2], b, h, w)
    t = jax.random.uniform(keys[3], (b, 1, 1))
    return np.asarray(jnp.where(t < 1 / 3, rot, jnp.where(t < 2 / 3, aff, per))), np.asarray(t)


def _step(x):
    """The image's largest difference between neighbours."""
    return max(float(np.abs(np.diff(x, axis=1)).max()), float(np.abs(np.diff(x, axis=2)).max()))


def _trig_difference(angles):
    """The largest difference between torch's and XLA's cos and sin of
    `angles` (radians), after checking it is what the matrix test accepts."""
    got = np.stack([torch.cos(_t(angles)).numpy(), torch.sin(_t(angles)).numpy()])
    want = np.stack([np.asarray(jnp.cos(angles)), np.asarray(jnp.sin(angles))])
    np.testing.assert_allclose(got, want, rtol=TRIG_RTOL, atol=TRIG_RTOL * 1e-2)
    return float(np.abs(got.astype(np.float64) - want).max())


def _blur_coordinate_slack(angles):
    """How far a motion-blur tap (offset t * (cos, sin), |t| <= 3) moves
    when cos and sin differ as they do for `angles`, plus the coordinate's
    last bit."""
    return 3 * _trig_difference(angles) + float(np.spacing(np.float32(W - 1)))


def _port_homographies(params):
    """The homography the port warps each sample with, from the draws."""
    t = _as_port(params)
    one, zero = torch.ones(B), torch.zeros(B)
    rot = taug._center_to_corner(taug._affine_to_h(
        taug.abi_affine_mats(t["rot_angle"], one, zero, zero)), H, W)
    aff = taug._center_to_corner(taug._affine_to_h(taug.abi_affine_mats(
        t["aff_angle"], t["aff_scale"], t["aff_shear_x"], t["aff_shear_y"])), H, W)
    per = taug.perspective_h(t["persp_noise_h"], t["persp_noise_w"], H, W)
    c = t["geom_choice"][:, None, None]
    return torch.where(c < 1 / 3, rot, torch.where(c < 2 / 3, aff, per)).numpy()


def _homography_slack(got, want, choice):
    """The most a source coordinate (n / z of a pixel) moves between the
    port's homographies and JAX's, after checking that every entry is
    within what the matrix test accepts, plus the coordinate's last bit."""
    rtol = np.where(choice.reshape(-1) >= 2 / 3, PERSP_RTOL, TRIG_RTOL)[:, None, None]
    assert (np.abs(got - want) <= rtol * (np.abs(want) + 1e-2)).all()
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    g = np.stack([gx.ravel(), gy.ravel(), np.ones(H * W)])  # [3, HW]
    want = want.astype(np.float64)
    n, dn = want @ g, np.abs(got.astype(np.float64) - want) @ g  # [B, 3, HW]
    z, dz = np.abs(n[:, 2]), dn[:, 2]
    assert (z > dz).all()
    moved = (dn[:, :2] + np.abs(n[:, :2] / n[:, 2:3]) * dz[:, None]) / (z - dz)[:, None]
    return float(moved.sum(1).max()) + 2 * float(np.spacing(np.float32(W - 1)))


def _jitter_gain():
    """The most the colour jitter grows a difference between two views:
    [-1, 1] -> [0, 1] and brightness (0.5 * 1.5), contrast and saturation
    (each c + |1 - c| <= 2 for c in [0.5, 1.5]), the hue rotation's largest
    row sum over its range of angles, back to [-1, 1] (2)."""
    hue = max(np.abs(taug._TO_RGB.astype(np.float64)
                     @ np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
                     @ taug._TO_YIQ).sum(1).max()
              for a in np.linspace(-0.2 * np.pi, 0.2 * np.pi, 401))
    return 0.75 * 2 * 2 * hue * 2


def _own_trig_atol(x, params, hm, choice):
    """The bound on a view made with the port's own matrices and
    trigonometry: each source coordinate moves by its slack
    (`_homography_slack` for the geometry, `_blur_coordinate_slack` for a
    tap of the motion blur), a bilinear sample by the image's largest
    neighbour step for each pixel its two coordinates move (the blur's
    input: the image's range plus the noise at its largest), and the
    jitter grows that by `_jitter_gain`; the hue rotation's own cos and sin
    add their difference times the largest chroma."""
    geom = _step(x) * _homography_slack(_port_homographies(params), hm, choice)
    noise = float(np.abs(params["noise"]).max()) * np.sqrt(20.0) / 127.5
    blur = (float(x.max() - x.min()) + 2 * noise) * 2 * _blur_coordinate_slack(params["blur_angle"])
    chroma = np.abs(taug._TO_YIQ[1:].astype(np.float64)).sum(1).sum()
    hue = 2 * np.abs(taug._TO_RGB.astype(np.float64)).sum(1).max() * 2 * chroma * \
        _trig_difference(params["hue"])
    return PIECE_ATOL + _jitter_gain() * (geom + blur) + hue


# ---------------------------------------------------------------------------
# the pieces, given the same matrices and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("smooth", [False, True])
def test_projective_warp_given_the_matrices(seed, smooth):
    rng = np.random.default_rng(seed)
    x = _images(10 + seed, smooth=smooth)
    hm = np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))
    hm += rng.normal(size=hm.shape).astype(np.float32) * np.array(
        [[0.1, 0.1, 5.0], [0.1, 0.1, 3.0], [1e-3, 1e-3, 0.05]], np.float32)
    want = jaug.batched_projective_warp(jnp.asarray(x), jnp.asarray(hm))
    _close(taug.batched_projective_warp(_t(x), _t(hm)).numpy(), want, PIECE_ATOL)


def test_projective_warp_identity_is_exact():
    x = _images(3, 2, smooth=False)
    eye = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    np.testing.assert_array_equal(taug.batched_projective_warp(_t(x), _t(eye)).numpy(), x)


@pytest.mark.parametrize("seed", [0, 5])
def test_geometry_matrices_from_the_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    p = _jax_params(key, B)
    keys = jax.random.split(key, 14)
    rot = jaug._center_to_corner(jaug._affine_to_h(
        jaug._rand_abi_affine_mats(keys[0], B, H, W, rotation_only=True)), H, W)
    aff = jaug._center_to_corner(jaug._affine_to_h(
        jaug._rand_abi_affine_mats(keys[1], B, H, W)), H, W)
    per = jaug._rand_perspective_h(keys[2], B, H, W)
    one, zero = torch.ones(B), torch.zeros(B)
    t = _as_port(p)
    got_rot = taug._center_to_corner(taug._affine_to_h(
        taug.abi_affine_mats(t["rot_angle"], one, zero, zero)), H, W)
    got_aff = taug._center_to_corner(taug._affine_to_h(taug.abi_affine_mats(
        t["aff_angle"], t["aff_scale"], t["aff_shear_x"], t["aff_shear_y"])), H, W)
    got_per = taug.perspective_h(t["persp_noise_h"], t["persp_noise_w"], H, W)
    # relative to each matrix entry's size: trigonometry and products in
    # fp32 (the translations reach ~2e2), and another LU for the perspective
    for got, want, rtol in ((got_rot, rot, TRIG_RTOL), (got_aff, aff, TRIG_RTOL),
                            (got_per, per, PERSP_RTOL)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 1e-2)


@pytest.mark.parametrize("factor", [2, 4])
def test_down_up_matches_jax(factor):
    x = _images(4, smooth=False)
    _close(taug._down_up(_t(x), factor).numpy(), jaug._down_up(jnp.asarray(x), factor), PIECE_ATOL)


def test_linear_resize_matches_jax_image_resize_both_ways():
    x = _images(5, 3, smooth=False)
    for shape in ((16, 64), (8, 32), (32, 128)):
        want = jax.image.resize(jnp.asarray(x), (3, *shape, 3), "linear")
        _close(taug._resize_linear(_t(x), *shape).numpy(), want, PIECE_ATOL)
    small = x[:, ::4, ::4]
    want = jax.image.resize(jnp.asarray(small), (3, H, W, 3), "linear")
    _close(taug._resize_linear(_t(small), H, W).numpy(), want, PIECE_ATOL)


def _motion_blur_case(seed):
    key = jax.random.PRNGKey(seed)
    x = _images(6 + seed, smooth=False)
    k1, k2 = jax.random.split(key)
    ang = np.asarray(jax.random.uniform(k1, (B,), minval=-jnp.pi / 2, maxval=jnp.pi / 2))
    length = np.maximum(np.floor(np.asarray(jax.random.beta(k2, 1.0, 4.0, (B,))) * 6.0), 1.0)
    assert (length > 1).any()  # some samples blur
    want = jaug._motion_blur(jnp.asarray(x), key)
    return x, want, lambda: taug._motion_blur(_t(x), _t(ang), _t(length.astype(np.float32))), ang


@pytest.mark.parametrize("seed", [0, 3])
def test_motion_blur_from_the_jax_draws(seed, monkeypatch):
    """JAX's draws and JAX's cos and sin: within PIECE_ATOL on any host."""
    x, want, blur, _ = _motion_blur_case(seed)
    _jax_trig(monkeypatch)
    _close(blur().numpy(), want, PIECE_ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_motion_blur_with_its_own_trigonometry_within_its_bound(seed):
    x, want, blur, ang = _motion_blur_case(seed)
    _close(blur().numpy(), want, PIECE_ATOL + _step(x) * 2 * _blur_coordinate_slack(ang))


def test_hue_rotation_matches_jax():
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    angle = rng.uniform(-0.2 * math.pi, 0.2 * math.pi, B).astype(np.float32)
    want = jaug._rgb_hue_rotate(jnp.asarray(u), jnp.asarray(angle))
    _close(taug._rgb_hue_rotate(_t(u), _t(angle)).numpy(), want, PIECE_ATOL)


# ---------------------------------------------------------------------------
# the whole view, and the port's own draws
# ---------------------------------------------------------------------------

def _view_case(seed, p):
    key = jax.random.PRNGKey(seed)
    x = _images(20 + seed)
    probs = {} if p is None else dict(p_geom=p, p_deter=p, p_jitter=p)
    want = np.asarray(jaug.device_abi_augment(key, jnp.asarray(x), **probs))
    return key, x, want, _jax_params(key, B, **probs)


VIEW_CASES = [(0, None), (1, None), (2, 1.0), (3, 1.0)]


@pytest.mark.parametrize("seed,p", VIEW_CASES)
def test_whole_view_from_the_jax_draws(seed, p, monkeypatch):
    """Every JAX draw, JAX's homographies and JAX's cos and sin: the port's
    warp, deterioration and jitter, in its order, within PIECE_ATOL on any
    host.  At p = 1 every sample is warped, deteriorated and jittered."""
    key, x, want, params = _view_case(seed, p)
    hm, _ = _jax_homographies(key)
    warp = taug.batched_projective_warp
    monkeypatch.setattr(taug, "batched_projective_warp", lambda xx, h_mats: warp(xx, _t(hm)))
    _jax_trig(monkeypatch)
    got = taug.device_abi_augment(None, _t(x), _as_port(params)).numpy()
    assert got.dtype == np.float32 and float(np.abs(got).max()) <= 1.0
    _close(got, want, PIECE_ATOL)
    changed = (np.abs(got - x).reshape(B, -1).max(1) > 1e-3).sum()
    if p == 1.0:
        assert changed == B


@pytest.mark.parametrize("seed,p", VIEW_CASES)
def test_whole_view_with_its_own_matrices_within_their_bound(seed, p):
    """The whole path, the port's matrices and trigonometry included, within
    the bound that the matrix test's tolerances carry through the view."""
    key, x, want, params = _view_case(seed, p)
    got = taug.device_abi_augment(None, _t(x), _as_port(params)).numpy()
    hm, choice = _jax_homographies(key)
    _close(got, want, _own_trig_atol(x, params, hm, choice))


def test_draws_have_their_ranges():
    b = 4096
    params = taug.draw_abi_augment_params(torch.Generator().manual_seed(3), b, H, W)
    ranges = {"rot_angle": (-45, 45), "aff_angle": (-45, 45), "aff_scale": (0.5, 2.0),
              "aff_shear_x": (-45, 45), "aff_shear_y": (-15, 15), "geom_choice": (0, 1),
              "noise_beta": (0, 1), "blur_beta": (0, 1), "blur_angle": (-math.pi / 2, math.pi / 2),
              "rescale_f": (0, 4), "brightness": (0.5, 1.5), "contrast": (0.5, 1.5),
              "saturation": (0.5, 1.5), "hue": (-0.2 * math.pi, 0.2 * math.pi)}
    for name, (lo, hi) in ranges.items():
        v = params[name]
        assert v.shape == (b,) and v.dtype == torch.float32, name
        assert float(v.min()) >= lo and float(v.max()) <= hi, name
        if not name.endswith("_beta"):  # the whole range is used (a Beta(1, 4) rarely nears 1)
            assert float(v.max()) - float(v.min()) > 0.9 * (hi - lo), name
    # Beta(1, 4): mean 1/5, P(X < 0.1) = 1 - 0.9^4
    for name in ("noise_beta", "blur_beta"):
        v = params[name].double()
        assert abs(float(v.mean()) - 0.2) < 0.01
        assert abs(float((v < 0.1).double().mean()) - (1 - 0.9**4)) < 0.03
    for name, prob in (("geom_gate", 0.5), ("deter_gate", 0.25), ("jitter_gate", 0.25)):
        g = params[name]
        assert g.dtype == torch.bool and abs(float(g.double().mean()) - prob) < 0.03, name
    assert params["persp_noise_h"].shape == params["persp_noise_w"].shape == (b, 4)
    assert params["noise"].shape == (b, H, W, 3)
    assert abs(float(params["noise"].std()) - 1.0) < 0.01
    assert isinstance(params["deter_order"], int) and 0 <= params["deter_order"] < 6


def test_draws_follow_the_generator_and_the_order_its_seed():
    draw = lambda seed: taug.draw_abi_augment_params(torch.Generator().manual_seed(seed), 8, H, W)
    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)
    assert not torch.equal(a["rot_angle"], c["rot_angle"])
    orders = {draw(s)["deter_order"] for s in range(40)}
    assert orders == set(range(6))  # every order is drawn


def test_device_abi_augment_draws_from_its_generator():
    x = _t(_images(9, 4))
    a = taug.device_abi_augment(torch.Generator().manual_seed(5), x)
    b = taug.device_abi_augment(torch.Generator().manual_seed(5), x)
    assert torch.equal(a, b) and a.shape == x.shape
    with torch.random.fork_rng():
        before = torch.random.get_rng_state()
        taug.device_abi_augment(torch.Generator().manual_seed(6), x)
        assert torch.equal(torch.random.get_rng_state(), before)

"""The port's on-device view generator against the JAX package's, on the CPU.

torch's Philox and JAX's threefry draw different numbers from the same
key, so the two packages are compared through the port's seams: the test
repeats the JAX package's own draws (`jax.random.split(key, 12)` and the
calls of `dig_tpu/data/device_aug.py:396-429`; `bernoulli(k, p)` is
`uniform(k) < p`, taken here by calling `bernoulli` itself) and hands them
to the port as `params`, or as the uniforms of the mask ranking.

Everything is fp32.  Images are compared within 1e-5 absolute (values in
[-1, 1]) wherever both packages warp with the same matrices: the port sums
the warp's source coordinates in the order of the JAX package's fp32 matrix
product, so they agree to the bit and what is left is the rounding of the
bilinear and photometric arithmetic.  The matrices the port builds from the
JAX draws agree with JAX's only to what
`test_affine_matrix_algebra_from_the_jax_draws` accepts (cos, sin and tan
differ by an ulp or two between libms), so the whole view with the port's
own matrices is held to the bound that their difference, checked against
that tolerance, carries through the warp (`_own_matrix_atol`).  Masks from the same uniforms must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.data import device_aug as jaug
from dig_tpu.data import masking as jmask
from dig_tpu.train.pretrain import make_device_view_fn as j_make_device_view_fn
from dig_tpu_torch.data import device_aug as taug
from dig_tpu_torch.data import masking as tmask
from dig_tpu_torch.train.pretrain import make_device_view_fn
from dig_tpu_torch.utils.rng import step_generator


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


ATOL = 1e-5
# what test_affine_matrix_algebra_from_the_jax_draws accepts of an entry
MAT_RTOL = MAT_ATOL = 1e-5
# the most the colour jitter can grow a difference between two images:
# contrast c in [0.6, 1.4] and saturation s in [0.8, 1.2] each mix a pixel
# with a mean, at a gain of at most c + |1 - c| and s + |1 - s|
JITTER_GAIN = (1.4 + 0.4) * (1.2 + 0.2)
B, H, W = 6, 32, 128


def _images(seed, b=B, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # low-pass content, as a word image has: neighbours differ by little
        x = rng.uniform(-1, 1, (b, H // 4, W // 4, 3))
        x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)
    else:
        x = rng.uniform(-1, 1, (b, H, W, 3))
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= atol, f"max abs err {err:.3e} > {atol}"


# ---------------------------------------------------------------------------
# the warp
# ---------------------------------------------------------------------------

def test_affine_warp_identity_is_exact():
    x = _images(0, 2)
    eye = np.tile(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)[None], (2, 1, 1))
    got = taug.batched_affine_warp(_t(x), _t(eye)).numpy()
    np.testing.assert_array_equal(got, x)
    _close(got, jaug.batched_affine_warp(jnp.asarray(x), jnp.asarray(eye)))


def test_affine_warp_translation_and_edge_clamp():
    x = np.zeros((1, 8, 8, 1), np.float32)
    x[:, 2, 2] = 1.0
    x[:, :, 7] = 0.5  # the right edge column, replicated beyond the image
    m = np.array([[[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]], np.float32)  # sample 1 to the right
    got = taug.batched_affine_warp(_t(x), _t(m)).numpy()
    assert got[0, 2, 1, 0] == 1.0 and got[0, 2, 2, 0] == 0.0
    assert (got[0, :, 6, 0] == 0.5).all() and (got[0, :, 7, 0] == 0.5).all()
    _close(got, jaug.batched_affine_warp(jnp.asarray(x), jnp.asarray(m)))
    # half a pixel: the mean of two neighbours
    m[0, 0, 2] = 0.5
    got = taug.batched_affine_warp(_t(x), _t(m)).numpy()
    assert got[0, 2, 1, 0] == 0.5 and got[0, 2, 2, 0] == 0.5
    _close(got, jaug.batched_affine_warp(jnp.asarray(x), jnp.asarray(m)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_warp_random_matrices_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = _images(10 + seed)
    mats = np.tile(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)[None], (B, 1, 1))
    mats += rng.normal(size=mats.shape).astype(np.float32) * np.array([0.2, 0.2, 9.0], np.float32)
    want = jaug.batched_affine_warp(jnp.asarray(x), jnp.asarray(mats))
    _close(taug.batched_affine_warp(_t(x), _t(mats)).numpy(), want)


def test_affine_warp_is_not_grid_sample_with_zero_padding():
    """Samples beyond the image take the edge pixel, not zero."""
    x = np.ones((1, 4, 4, 1), np.float32)
    far = np.array([[[1.0, 0.0, 100.0], [0.0, 1.0, -100.0]]], np.float32)
    np.testing.assert_array_equal(taug.batched_affine_warp(_t(x), _t(far)).numpy(), x)


# ---------------------------------------------------------------------------
# matrices, blur, masks
# ---------------------------------------------------------------------------

def _jax_affine_draws(key, b, degrees=10.0, scale=(0.8, 1.25), shear=15.0, translate=0.1):
    """The five draws of `_rand_affine_mats`, before its arithmetic."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(k, (b,), minval=lo, maxval=hi))
    return dict(angle=u(k1, -degrees, degrees), scale=u(k2, scale[0], scale[1]),
                shear=u(k3, -shear, shear), tx=u(k4, -translate, translate),
                ty=u(k5, -translate, translate))


@pytest.mark.parametrize("seed", [0, 7])
def test_affine_matrix_algebra_from_the_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug._rand_affine_mats(key, B, h=H, w=W))
    draws = {k: _t(v) for k, v in _jax_affine_draws(key, B).items()}
    got = taug.affine_mats(**draws, h=H, w=W).numpy()
    assert got.shape == (B, 2, 3)
    # cos, sin, tan and a 2 x 2 inverse in fp32: a few ulp of entries up to ~20
    np.testing.assert_allclose(got, want, rtol=MAT_RTOL, atol=MAT_ATOL)


def test_rand_affine_mats_draws_within_its_ranges():
    g = torch.Generator().manual_seed(0)
    p = taug._draw_affine(g, 4096)
    for name, lo, hi in (("angle", -10, 10), ("scale", 0.8, 1.25), ("shear", -15, 15),
                         ("tx", -0.1, 0.1), ("ty", -0.1, 0.1)):
        v = p[name]
        assert v.shape == (4096,) and lo <= float(v.min()) and float(v.max()) <= hi
        assert float(v.max()) - float(v.min()) > 0.95 * (hi - lo)
    mats = taug._rand_affine_mats(torch.Generator().manual_seed(0), 4096, h=H, w=W)
    assert torch.equal(mats, taug.affine_mats(**p, h=H, w=W))


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_blur_matches_jax(seed):
    x = _images(20 + seed)
    sigma = np.random.default_rng(seed).uniform(0.3, 1.0, B).astype(np.float32)
    want = jaug._gaussian_blur(jnp.asarray(x), jnp.asarray(sigma))
    got = taug._gaussian_blur(_t(x), _t(sigma)).numpy()
    _close(got, want)
    # zero padding, not reflection: a constant image darkens at its border
    ones = taug._gaussian_blur(torch.ones(1, 8, 8, 1), torch.ones(1))
    assert float(ones[0, 4, 4, 0]) == 1.0 and float(ones[0, 0, 0, 0]) == pytest.approx((11 / 16) ** 2)


@pytest.mark.parametrize("num_view,num_mask", [(1, 179), (2, 179), (2, 1), (3, 255)])
def test_mask_from_the_jax_uniforms_is_equal(num_view, num_mask):
    key = jax.random.PRNGKey(num_view * 1000 + num_mask)
    want = np.asarray(jmask.random_mask_batch(key, 5, 256, num_mask, num_view))
    u = np.asarray(jax.random.uniform(key, (5, num_view, 256)))
    got = tmask.random_mask_from_uniforms(_t(u), num_mask).numpy()
    assert got.dtype == np.bool_ and (got.sum(-1) == num_mask).all()
    np.testing.assert_array_equal(got, want)


def test_mask_ties_keep_the_exact_count():
    u = torch.zeros(2, 2, 16)  # every uniform equal: ranked by position
    got = tmask.random_mask_from_uniforms(u, 5)
    assert (got.sum(-1) == 5).all() and got[..., :5].all()
    g = torch.Generator().manual_seed(1)
    drawn = tmask.random_mask_batch(g, 3, 256, 179, 2)
    assert drawn.shape == (3, 2, 256) and (drawn.sum(-1) == 179).all()
    assert not torch.equal(drawn[0, 0], drawn[0, 1])


# ---------------------------------------------------------------------------
# the whole augmentation under the JAX draws
# ---------------------------------------------------------------------------

def _jax_params(key, b, h, w, c=3, p_geom=0.5, p_blur=0.3, p_jitter=0.8, p_gray=0.2,
                p_noise=0.25):
    """Every draw of `jaug.device_augment(key, images)`, by the port's names."""
    keys = jax.random.split(key, 12)
    bern = lambda k, p, shape: np.asarray(jax.random.bernoulli(k, p, shape)).reshape(b)
    unif = lambda k, shape, lo, hi: np.asarray(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(b)
    four = (b, 1, 1, 1)
    return dict(
        **_jax_affine_draws(keys[0], b),
        geom_gate=bern(keys[1], p_geom, four),
        sigma=unif(keys[2], (b,), 0.3, 1.0),
        blur_gate=bern(keys[3], p_blur, (b,)),
        jitter_gate=bern(keys[4], p_jitter, four),
        brightness=unif(keys[5], four, -0.4, 0.4),
        contrast=unif(keys[6], four, 0.6, 1.4),
        saturation=unif(keys[7], four, 0.8, 1.2),
        gray_gate=bern(keys[8], p_gray, four),
        noise_gate=bern(keys[9], p_noise, four),
        noise=np.asarray(jax.random.normal(keys[10], (b, h, w, c))),
    )


def _augment_case(seed, b=16):
    """Images, the JAX view, the JAX draws as the port's params and the
    JAX package's own affine matrices (from `keys[0]`, as `device_augment`
    builds them) of one case."""
    x = _images(30 + seed, b, smooth=seed % 2 == 0)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.device_augment(key, jnp.asarray(x)))
    params = {k: _t(v) for k, v in _jax_params(key, b, H, W).items()}
    mats = np.asarray(jaug._rand_affine_mats(jax.random.split(key, 12)[0], b, h=H, w=W))
    return x, want, params, mats


def _own_matrix_atol(got, want, x):
    """The bound on the view when the port builds its own matrices `got`
    from the draws whose JAX matrices are `want`: every entry must be within
    what the matrix test accepts; their differences move a source coordinate
    by at most the sum of each times |x|, |y|, 1 at the far corner, plus the
    coordinate's own last bit; a bilinear sample moves by at most the
    image's largest neighbour step for each pixel the two coordinates move,
    and the jitter grows that by up to JITTER_GAIN."""
    np.testing.assert_allclose(got, want, rtol=MAT_RTOL, atol=MAT_ATOL)
    reach = np.array([(W - 1) / 2, (H - 1) / 2, 1.0])
    coord = float((np.abs(got.astype(np.float64) - want) @ reach).max()) \
        + float(np.spacing(np.float32(W - 1)))
    step = max(float(np.abs(np.diff(x, axis=1)).max()), float(np.abs(np.diff(x, axis=2)).max()))
    return ATOL + 2 * coord * step * JITTER_GAIN


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_augment_matches_jax_under_its_draws(seed, monkeypatch):
    """Every JAX draw and the JAX package's own matrices: the port's warp,
    blur, jitter, grey and noise, in its order, within ATOL on any host."""
    b = 16
    x, want, params, mats = _augment_case(seed, b)
    # the gates of 16 samples take both values, so every branch is compared
    if seed == 0:
        for gate in ("geom_gate", "blur_gate", "jitter_gate", "gray_gate", "noise_gate"):
            assert 0 < int(params[gate].sum()) < b, gate
    monkeypatch.setattr(taug, "affine_mats", lambda *a, **k: _t(mats))
    got = taug.device_augment(None, _t(x), params).numpy()
    _close(got, want)
    assert np.abs(got).max() <= 1.0 and not np.allclose(got, x, atol=1e-2)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_augment_with_its_own_matrices_within_their_bound(seed):
    """The whole path, the port's matrix arithmetic included, within the
    bound that the matrix test's tolerance carries through the warp."""
    x, want, params, mats = _augment_case(seed)
    got = taug.device_augment(None, _t(x), params).numpy()
    own = taug.affine_mats(*(params[k] for k in ("angle", "scale", "shear", "tx", "ty")), H, W)
    _close(got, want, _own_matrix_atol(own.numpy(), mats, x))


def test_draw_augment_params_names_shapes_and_rates():
    g = torch.Generator().manual_seed(3)
    p = taug.draw_augment_params(g, 2048, 4, 8)
    assert sorted(p) == sorted(["angle", "scale", "shear", "tx", "ty", "geom_gate", "sigma",
                                "blur_gate", "jitter_gate", "brightness", "contrast",
                                "saturation", "gray_gate", "noise_gate", "noise"])
    assert p["noise"].shape == (2048, 4, 8, 3) and abs(float(p["noise"].std()) - 1) < 0.02
    for gate, rate in (("geom_gate", 0.5), ("blur_gate", 0.3), ("jitter_gate", 0.8),
                       ("gray_gate", 0.2), ("noise_gate", 0.25)):
        assert p[gate].dtype == torch.bool and p[gate].shape == (2048,)
        assert abs(float(p[gate].float().mean()) - rate) < 0.04, gate
    for name, lo, hi in (("sigma", 0.3, 1.0), ("brightness", -0.4, 0.4), ("contrast", 0.6, 1.4),
                         ("saturation", 0.8, 1.2)):
        assert lo <= float(p[name].min()) and float(p[name].max()) <= hi
    # drawing inside device_augment takes the same draws in the same order
    x = _t(_images(5, 4))
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert torch.equal(taug.device_augment(ga, x),
                       taug.device_augment(None, x, taug.draw_augment_params(gb, 4, H, W)))


def test_device_augment_keeps_dtype_and_range_in_bf16():
    x = _t(_images(6, 4)).to(torch.bfloat16)
    y = taug.device_augment(torch.Generator().manual_seed(0), x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and float(y.abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# the view generator
# ---------------------------------------------------------------------------

def test_device_view_fn_keys_shapes_dtypes_counts():
    u8 = np.random.default_rng(7).integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    view_fn = make_device_view_fn(256, 0.7, 2)
    out = view_fn(step_generator(1, 1, 0), _t(u8))
    assert sorted(out) == ["aug_images", "images", "mask"]
    assert out["images"].shape == out["aug_images"].shape == (5, H, W, 3)
    assert out["images"].dtype == out["aug_images"].dtype == torch.float32
    assert out["mask"].shape == (5, 2, 256) and out["mask"].dtype == torch.bool
    # int(0.7 * 256) = 179, as the JAX package counts (not round(179.2) up)
    assert (out["mask"].sum(-1) == 179).all()
    np.testing.assert_array_equal(out["images"].numpy(),
                                  ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5)
    assert float(out["aug_images"].abs().max()) <= 1.0
    assert not torch.equal(out["images"], out["aug_images"])
    # the JAX generator's outputs have the same keys, shapes and mask counts
    jout = j_make_device_view_fn(256, 0.7, 2)(jax.random.PRNGKey(0), jnp.asarray(u8))
    assert sorted(jout) == sorted(out)
    for k in out:
        assert tuple(jout[k].shape) == tuple(out[k].shape)
    assert (np.asarray(jout["mask"]).sum(-1) == 179).all()
    np.testing.assert_allclose(out["images"].numpy(), np.asarray(jout["images"]), atol=1e-6)


def test_device_view_fn_is_a_function_of_seed_stream_step():
    u8 = _t(np.random.default_rng(8).integers(0, 256, (4, H, W, 3), dtype=np.uint8))
    view_fn = make_device_view_fn(256, 0.7, 2)
    a = view_fn(step_generator(5, 1, 12), u8)
    b = view_fn(step_generator(5, 1, 12), u8)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for other in ((5, 1, 13), (6, 1, 12), (5, 0, 12)):
        c = view_fn(step_generator(*other), u8)
        assert not torch.equal(a["aug_images"], c["aug_images"])
        assert not torch.equal(a["mask"], c["mask"])


def test_device_view_fn_takes_given_params_and_still_draws_masks():
    u8 = _t(np.random.default_rng(9).integers(0, 256, (4, H, W, 3), dtype=np.uint8))
    view_fn = make_device_view_fn(256, 0.7, 2)
    params = taug.draw_augment_params(torch.Generator().manual_seed(2), 4, H, W)
    a = view_fn(torch.Generator().manual_seed(0), u8, params)
    b = view_fn(torch.Generator().manual_seed(1), u8, params)
    assert torch.equal(a["aug_images"], b["aug_images"])
    assert not torch.equal(a["mask"], b["mask"])

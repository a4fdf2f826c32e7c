"""The PyTorch port's diffusion process and building blocks against the JAX
package: the beta schedules, every GaussianDiffusion identity and path at
T = 10 (every mean and variance type, every loss type, the ancestral and
DDIM loops and calc_bpd_loop, each fed the normals JAX's keys draw), the
likelihood helpers, the timestep embedding, GroupNorm32 at skip-concat
widths, Downsample's stride-2 SAME alignment, average pooling and the
uniform timestep sampler.

CPU tests; inputs are made from seeds with numpy. Values are held at rtol
1e-5 / atol 1e-6."""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.diffusion import gaussian_diffusion as gd_jax
from thr3ed_atom_tpu.diffusion import losses as losses_jax
from thr3ed_atom_tpu.diffusion import nn as nn_jax
from thr3ed_atom_tpu.diffusion import timestep_sampler as ts_jax
from thr3ed_atom_tpu.diffusion import unet as unet_jax
from thr3ed_atom_tpu_torch.diffusion import gaussian_diffusion as gd
from thr3ed_atom_tpu_torch.diffusion import losses
from thr3ed_atom_tpu_torch.diffusion import nn as tnn
from thr3ed_atom_tpu_torch.diffusion import timestep_sampler as ts
from thr3ed_atom_tpu_torch.diffusion import unet as tunet

T = 10
SHAPE = (3, 4, 5, 2)  # [B, H, W, C], channels-last as the model sees it
TOL = dict(rtol=1e-5, atol=1e-6)
MEAN_TYPES = ["PREVIOUS_X", "START_X", "EPSILON"]
VAR_TYPES = ["LEARNED", "FIXED_SMALL", "FIXED_LARGE", "LEARNED_RANGE"]
LOSS_TYPES = ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL", "HUBER"]


def _pair(mean="EPSILON", var="FIXED_SMALL", loss="MSE", rescale=False, schedule="cosine"):
    betas = gd.get_named_beta_schedule(schedule, T)
    kw = dict(rescale_timesteps=rescale)
    jax_d = gd_jax.GaussianDiffusion(
        betas=betas, model_mean_type=gd_jax.ModelMeanType[mean],
        model_var_type=gd_jax.ModelVarType[var], loss_type=gd_jax.LossType[loss], **kw)
    port_d = gd.GaussianDiffusion(
        betas=betas, model_mean_type=gd.ModelMeanType[mean],
        model_var_type=gd.ModelVarType[var], loss_type=gd.LossType[loss], **kw)
    return jax_d, port_d


def _learned(var):
    return var in ("LEARNED", "LEARNED_RANGE")


def _models(var):
    """The same model function in both frameworks: an elementwise map of x
    and t (twice the channels for a learned variance, the variance half in
    [-1, 1])."""
    def jax_fn(x, t):
        tt = jnp.asarray(t, jnp.float32).reshape(-1, *([1] * (x.ndim - 1)))
        out = jnp.tanh(0.7 * x + 0.05 * tt) * 1.3
        return jnp.concatenate([out, jnp.tanh(0.3 * x - 0.02 * tt)], -1) if _learned(var) \
            else out

    def port_fn(x, t):
        tt = t.float().reshape(-1, *([1] * (x.dim() - 1)))
        out = torch.tanh(0.7 * x + 0.05 * tt) * 1.3
        return torch.cat([out, torch.tanh(0.3 * x - 0.02 * tt)], -1) if _learned(var) \
            else out

    return jax_fn, port_fn


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(size=SHAPE) * 0.6, -1, 1).astype(np.float32)
    xt = rng.normal(size=SHAPE).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([0, 4, T - 1])
    return x0, xt, noise, t


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(kw or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ schedules


@pytest.mark.parametrize("name", ["linear", "cosine"])
@pytest.mark.parametrize("steps", [10, 500, 1000])
def test_beta_schedules_equal_jax(name, steps):
    np.testing.assert_array_equal(gd.get_named_beta_schedule(name, steps),
                                  gd_jax.get_named_beta_schedule(name, steps))
    with pytest.raises(NotImplementedError):
        gd.get_named_beta_schedule("sigmoid", steps)


def test_schedule_tables_equal_jax():
    jax_d, port_d = _pair()
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(port_d, name), getattr(jax_d, name), name)
    assert port_d.num_timesteps == jax_d.num_timesteps == T
    assert gd.LossType.KL.is_vb() and not gd.LossType.HUBER.is_vb()


# ------------------------------------------------------------- forward process


def test_forward_process_identities_equal_jax():
    jax_d, port_d = _pair()
    x0, xt, noise, t = _inputs()
    for got, want in zip(port_d.q_mean_variance(_t(x0), _t(t)),
                         jax_d.q_mean_variance(x0, jnp.asarray(t))):
        _close(got, want)
    _close(port_d.q_sample(_t(x0), _t(t), _t(noise)), jax_d.q_sample(x0, jnp.asarray(t), noise))
    for got, want in zip(port_d.q_posterior_mean_variance(_t(x0), _t(xt), _t(t)),
                         jax_d.q_posterior_mean_variance(x0, xt, jnp.asarray(t))):
        _close(got, want)
    for name in ("_predict_xstart_from_eps", "_predict_xstart_from_xprev",
                 "_predict_eps_from_xstart"):
        _close(getattr(port_d, name)(_t(xt), _t(t), _t(noise)),
               getattr(jax_d, name)(xt, jnp.asarray(t), noise))
    _close(port_d._prior_bpd(_t(x0)), jax_d._prior_bpd(x0))


@pytest.mark.parametrize("rescale", [False, True])
def test_scale_timesteps_equal_jax(rescale):
    jax_d, port_d = _pair(rescale=rescale)
    t = np.array([0, 3, 9])
    _close(port_d._scale_timesteps(_t(t)), jax_d._scale_timesteps(jnp.asarray(t)))


# ------------------------------------------------------------- reverse process


@pytest.mark.parametrize("mean", MEAN_TYPES)
@pytest.mark.parametrize("var", VAR_TYPES)
def test_p_mean_variance_equal_jax(mean, var):
    jax_d, port_d = _pair(mean, var)
    jax_fn, port_fn = _models(var)
    _, xt, _, t = _inputs(1)
    for clip, denoise in ((True, False), (False, True)):
        want = jax_d.p_mean_variance(jax_fn, xt, jnp.asarray(t), clip,
                                     (lambda z: z * 0.9) if denoise else None)
        got = port_d.p_mean_variance(port_fn, _t(xt), _t(t), clip,
                                     (lambda z: z * 0.9) if denoise else None)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


@pytest.mark.parametrize("var", VAR_TYPES)
def test_p_sample_and_guidance_equal_jax(var):
    """One ancestral step with the normal JAX's key draws, with and without a
    classifier gradient; the DDIM step and its score conditioning; the
    deterministic DDIM reverse step."""
    jax_d, port_d = _pair("EPSILON", var)
    jax_fn, port_fn = _models(var)
    _, xt, _, t = _inputs(2)
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, xt.shape, jnp.float32))

    def jax_cond(x, tt):
        return 0.1 * jnp.sin(x)

    def port_cond(x, tt):
        return 0.1 * torch.sin(x)

    for jc, pc in ((None, None), (jax_cond, port_cond)):
        want = jax_d.p_sample(jax_fn, xt, jnp.asarray(t), key, cond_fn=jc)
        got = port_d.p_sample(port_fn, _t(xt), _t(t), cond_fn=pc, noise=_t(z))
        for g, w in zip(got, want):
            _close(g, w)
        want = jax_d.ddim_sample(jax_fn, xt, jnp.asarray(t), key, cond_fn=jc, eta=0.5)
        got = port_d.ddim_sample(port_fn, _t(xt), _t(t), cond_fn=pc, eta=0.5, noise=_t(z))
        for g, w in zip(got, want):
            _close(g, w)
    t_rev = np.array([0, 4, T - 2])
    for g, w in zip(port_d.ddim_reverse_sample(port_fn, _t(xt), _t(t_rev)),
                    jax_d.ddim_reverse_sample(jax_fn, xt, jnp.asarray(t_rev))):
        _close(g, w)
    with pytest.raises(ValueError):
        port_d.ddim_reverse_sample(port_fn, _t(xt), _t(t_rev), eta=0.1)


def _loop_noise(key, shape, steps):
    """The normals JAX's p_sample_loop / ddim_sample_loop draw from ``key``:
    x_T, then one a step."""
    key, init_key = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(init_key, shape))
    step_keys = jax.random.split(key, steps)
    return x_T, [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in step_keys]


@pytest.mark.parametrize("max_iter", [None, 4])
@pytest.mark.parametrize("var", ["FIXED_SMALL", "LEARNED_RANGE"])
def test_sample_loops_equal_jax(max_iter, var):
    jax_d, port_d = _pair("EPSILON", var)
    jax_fn, port_fn = _models(var)
    np.testing.assert_array_equal(port_d._timestep_sequence(max_iter),
                                  jax_d._timestep_sequence(max_iter))
    key = jax.random.PRNGKey(11)
    steps = len(jax_d._timestep_sequence(max_iter))
    x_T, step_noise = _loop_noise(key, SHAPE, steps)
    want = jax_d.p_sample_loop(jax_fn, SHAPE, key, max_iter=max_iter)
    got = port_d.p_sample_loop(port_fn, SHAPE, noise=_t(x_T),
                               step_noise=[_t(z) for z in step_noise], max_iter=max_iter)
    _close(got, want)
    want = jax_d.ddim_sample_loop(jax_fn, SHAPE, key, eta=0.3, max_iter=max_iter)
    got = port_d.ddim_sample_loop(port_fn, SHAPE, noise=_t(x_T), eta=0.3,
                                  step_noise=[_t(z) for z in step_noise], max_iter=max_iter)
    _close(got, want)


def test_sample_loops_draw_from_the_generator():
    """Without fed noise the loops draw x_T and every step from the
    generator: the same seed gives the same sample, eta 0 DDIM ignores the
    step draws."""
    _, port_d = _pair()
    _, port_fn = _models("FIXED_SMALL")
    a = port_d.p_sample_loop(port_fn, SHAPE, torch.Generator().manual_seed(5))
    b = port_d.p_sample_loop(port_fn, SHAPE, torch.Generator().manual_seed(5))
    c = port_d.p_sample_loop(port_fn, SHAPE, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and a.shape == SHAPE and not a.requires_grad
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    d1 = port_d.ddim_sample_loop(port_fn, SHAPE, torch.Generator().manual_seed(2), noise=x_T)
    d2 = port_d.ddim_sample_loop(port_fn, SHAPE, torch.Generator().manual_seed(3), noise=x_T)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


# --------------------------------------------------------------------- losses


@pytest.mark.parametrize("loss", LOSS_TYPES)
@pytest.mark.parametrize("mean", MEAN_TYPES)
@pytest.mark.parametrize("var", ["FIXED_SMALL", "LEARNED_RANGE"])
def test_training_losses_equal_jax(loss, mean, var):
    """Every loss type under every mean type, fixed and learned-range
    variance (the frozen-mean VLB term), with JAX's noise; and the loss's
    gradient with respect to the model's output."""
    jax_d, port_d = _pair(mean, var, loss)
    jax_fn, port_fn = _models(var)
    x0, _, _, t = _inputs(4)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    want = jax_d.training_losses(jax_fn, x0, jnp.asarray(t), key)
    got = port_d.training_losses(port_fn, _t(x0), _t(t), noise=_t(noise))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])

    # the loss's gradient with respect to the model's output: cosine > 0.99999
    out_shape = (*SHAPE[:-1], SHAPE[-1] * (2 if _learned(var) else 1))

    def jax_loss(delta):
        fn = lambda x, tt: jax_fn(x, tt) + delta  # noqa: E731
        return jax_d.training_losses(fn, x0, jnp.asarray(t), key)["loss"].mean()

    delta = torch.zeros(out_shape, requires_grad=True)
    port_d.training_losses(lambda x, tt: port_fn(x, tt) + delta, _t(x0), _t(t),
                           noise=_t(noise))["loss"].mean().backward()
    want_g = np.asarray(jax.grad(jax_loss)(jnp.zeros(out_shape))).ravel()
    got_g = delta.grad.numpy().ravel()
    assert got_g @ want_g / (np.linalg.norm(got_g) * np.linalg.norm(want_g)) > 0.99999


def test_training_losses_draw_from_the_generator():
    _, port_d = _pair()
    _, port_fn = _models("FIXED_SMALL")
    x0, _, _, t = _inputs(5)
    a = port_d.training_losses(port_fn, _t(x0), _t(t), torch.Generator().manual_seed(1))
    b = port_d.training_losses(port_fn, _t(x0), _t(t), torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["loss"], b["loss"], rtol=0, atol=0)
    assert a["loss"].shape == (SHAPE[0],)


@pytest.mark.parametrize("var", ["FIXED_LARGE", "LEARNED_RANGE"])
def test_calc_bpd_loop_equal_jax(var):
    jax_d, port_d = _pair("EPSILON", var, "KL")
    jax_fn, port_fn = _models(var)
    x0 = np.round(_inputs(6)[0] * 127.5) / 127.5  # 8-bit levels: the decoder term
    key = jax.random.PRNGKey(9)
    noise = [np.asarray(jax.random.normal(k, x0.shape, jnp.float32))
             for k in jax.random.split(key, T)]
    want = jax_d.calc_bpd_loop(jax_fn, jnp.asarray(x0, jnp.float32), key)
    got = port_d.calc_bpd_loop(port_fn, _t(x0.astype(np.float32)),
                               noise=[_t(z) for z in noise])
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_likelihood_helpers_equal_jax():
    rng = np.random.default_rng(8)
    m1, l1, m2, l2 = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(4))
    _close(losses.normal_kl(_t(m1), _t(l1), _t(m2), _t(l2)), losses_jax.normal_kl(m1, l1, m2, l2))
    _close(losses.normal_kl(_t(m1), _t(l1), 0.0, 0.0), losses_jax.normal_kl(m1, l1, 0.0, 0.0))
    x = np.concatenate([np.array([-1.0, -0.9995, 1.0, 0.9995], np.float32),
                        rng.uniform(-1, 1, 20).astype(np.float32)])
    _close(losses.approx_standard_normal_cdf(_t(x * 3)),
           losses_jax.approx_standard_normal_cdf(x * 3))
    means = rng.normal(size=x.shape).astype(np.float32) * 0.3
    log_scales = rng.uniform(-6, 0, x.shape).astype(np.float32)
    got = losses.discretized_gaussian_log_likelihood(_t(x), means=_t(means),
                                                     log_scales=_t(log_scales)).numpy()
    want = np.asarray(losses_jax.discretized_gaussian_log_likelihood(
        x, means=means, log_scales=log_scales))
    # each branch logs a difference of CDFs (1 - cdf at the top bin): a
    # one-ulp difference between the two packages' f32 tanh moves the log by
    # ulp(1) / (that difference), on top of the stated tolerance
    inv = np.exp(-log_scales.astype(np.float64))
    cdf = lambda v: 0.5 * (1 + np.tanh(np.sqrt(2 / np.pi) * (v + 0.044715 * v ** 3)))  # noqa: E731
    c_plus = cdf(inv * (x - means + 1 / 255))
    c_min = cdf(inv * (x - means - 1 / 255))
    arg = np.where(x < -0.999, c_plus, np.where(x > 0.999, 1 - c_min, c_plus - c_min))
    bound = 1e-6 + 1e-5 * np.abs(want) + 4 * np.spacing(np.float32(1)) / np.maximum(arg, 1e-12)
    assert (np.abs(got - want) <= bound).all()
    assert np.isfinite(got).all() and (got <= 0).all()


# ------------------------------------------------------------------ nn blocks


def test_timestep_embedding_equal_jax():
    """At the timesteps of a T = 10 diffusion the embeddings agree at the
    stated tolerance. Over a 500-step schedule XLA's f32 exp rounds some
    frequencies one ulp away from the correctly rounded value (10 of the 64
    at width 128), so each package is held against the float64 evaluation of
    the same f32 arguments' formula, within t x 2 ulp of the frequency."""
    t = np.arange(T)
    for dim in (8, 32, 33, 128):
        _close(tnn.timestep_embedding(_t(t), dim), nn_jax.timestep_embedding(jnp.asarray(t), dim))
    t = np.array([0, 1, 7, 250, 499])
    for dim in (32, 33, 128):
        half = dim // 2
        expo = (np.float32(-np.log(10000.0)) * np.arange(half, dtype=np.float32)
                / np.float32(half))
        freqs = np.exp(expo.astype(np.float64))
        args = t[:, None] * freqs[None]
        ref = np.concatenate([np.cos(args), np.sin(args)], -1)
        if dim % 2:
            ref = np.concatenate([ref, np.zeros_like(ref[:, :1])], -1)
        bound = t[:, None] * 2 * np.spacing(np.float32(1.0)) + 1e-6
        for emb in (tnn.timestep_embedding(_t(t), dim).numpy(),
                    np.asarray(nn_jax.timestep_embedding(jnp.asarray(t), dim))):
            assert emb.shape == (len(t), dim)
            assert (np.abs(emb - ref) <= bound).all()


@pytest.mark.parametrize("width", [8, 24, 40, 96])
def test_group_norm_equal_jax(width):
    """The largest group count <= 16 dividing the width, flax's epsilon 1e-6,
    statistics in f32."""
    rng = np.random.default_rng(width)
    x = (rng.normal(size=(2, 5, 4, 3, width)) + 0.5).astype(np.float32)
    scale = rng.normal(size=width).astype(np.float32)
    bias = rng.normal(size=width).astype(np.float32)
    want = nn_jax.GroupNorm32().apply(
        {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, x)
    gn = tnn.GroupNorm32(width)
    assert gn.groups == max(g for g in range(1, 17) if width % g == 0)
    tunet.load_flax_params(gn, {"GroupNorm_0": {"scale": scale, "bias": bias}})
    got = gn(_t(x).movedim(-1, 1)).movedim(1, -1)
    _close(got, want)
    # the epsilon is flax's: a constant group normalizes to bias
    flat = np.full((1, 4, width), 2.5, np.float32)
    _close(tnn.GroupNorm32(width)(_t(flat).movedim(-1, 1)), np.zeros((1, width, 4)))


@pytest.mark.parametrize("dims,size", [(1, 8), (1, 7), (2, 6), (3, 4), (3, 5)])
@pytest.mark.parametrize("use_conv", [True, False])
def test_downsample_alignment_equal_jax(dims, size, use_conv):
    """The stride-2 SAME conv pads (0, 1) on an even axis and (1, 1) on an
    odd one, as XLA does (Conv3d(padding=1) would shift the grid a voxel);
    without the conv it is 2x average pooling."""
    rng = np.random.default_rng(dims * 10 + size)
    x = rng.normal(size=(2, *(size,) * dims, 3)).astype(np.float32)
    flax_mod = unet_jax.Downsample(dims=dims, use_conv=use_conv)
    params = flax_mod.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), params)
    want = flax_mod.apply(params, x)
    mod = tunet.Downsample(3, dims, use_conv)
    tunet.load_flax_params(mod, params)
    got = mod(_t(x).movedim(-1, 1)).movedim(1, -1)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    assert tnn.same_padding(8, 3, 2) == (0, 1) and tnn.same_padding(7, 3, 2) == (1, 1)
    assert tnn.same_padding(8, 3, 1) == (1, 1) and tnn.same_padding(8, 1, 1) == (0, 0)


def test_pooling_and_parameter_helpers_equal_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 6, 5, 4, 3)).astype(np.float32)
    _close(tnn.avg_pool_nd(_t(x).movedim(-1, 1), 3).movedim(1, -1),
           nn_jax.avg_pool_nd(x, 3))
    _close(tnn.mean_flat(_t(x)), nn_jax.mean_flat(x))
    ema, new = {"w": rng.normal(size=4).astype(np.float32)}, {"w": rng.normal(size=4).astype(np.float32)}
    _close(tnn.update_ema({"w": _t(ema["w"])}, {"w": _t(new["w"])}, 0.9)["w"],
           nn_jax.update_ema(ema, new, 0.9)["w"])
    _close(tnn.scale_module_params({"w": _t(ema["w"])}, 0.25)["w"],
           nn_jax.scale_module_params(ema, 0.25)["w"])


def test_uniform_sampler_equal_jax():
    jax_d, port_d = _pair()
    sampler, jax_sampler = ts.UniformSampler(port_d), ts_jax.UniformSampler(jax_d)
    np.testing.assert_array_equal(sampler.weights(), jax_sampler.weights())
    t, w = sampler.sample(torch.Generator().manual_seed(0), 512)
    jt, jw = jax_sampler.sample(jax.random.PRNGKey(0), 512)
    assert t.shape == jt.shape == (512,) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < T and len(set(t.tolist())) == T
    _close(w, jw)  # uniform: unit weights in both
    # a non-uniform schedule: the importance weights 1 / (T p[t]) of each draw
    sampler._weights = np.arange(1, T + 1, dtype=np.float64)
    jax_sampler._weights = sampler._weights
    t, w = sampler.sample(torch.Generator().manual_seed(1), 256)
    p = np.arange(1, T + 1) / np.arange(1, T + 1).sum()
    _close(w, (1.0 / (T * p.astype(np.float32)[t.numpy()])).astype(np.float32))
    assert isinstance(jax_sampler.sample(jax.random.PRNGKey(1), 4)[0], jnp.ndarray)


def test_flax_conv_and_dense_layouts():
    """A flax Conv kernel [k..., in, out] and Dense kernel [in, out] carry
    into the port's layouts and back unchanged."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(1, 6, 6, 5)).astype(np.float32)
    conv = fnn.Conv(4, (3, 3), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), x)
    mod = tnn.conv_nd(2, 5, 4)
    tunet.load_flax_params(mod, params)
    _close(mod(_t(x).movedim(-1, 1)).movedim(1, -1), conv.apply(params, x))
    back = tunet.flax_params(mod)["params"]
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(back[k], np.asarray(params["params"][k]))
    dense = fnn.Dense(3)
    dparams = dense.init(jax.random.PRNGKey(1), x)
    dmod = tnn.Dense(5, 3)
    tunet.load_flax_params(dmod, dparams)
    _close(dmod(_t(x)), dense.apply(dparams, x))

"""The PyTorch port's UNet against the JAX package's flax UNet: the
parameter map both ways (with and without checkpointing), the full-width
parameter tree's names, shapes and leaf order (from jax.eval_shape, no
compute), the forward and the loss's parameter gradient for the test
suite's configurations with perturbed weights (the zero-initialised convs
would hide a path otherwise), and checkpointing on and off.

CPU tests at small widths; inputs are made from seeds with numpy. Forward:
rtol 1e-5 / atol 1e-5 on activations of order 1; gradients: cosine >
0.99999."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.diffusion.unet import AttentionPool2d as JaxPool
from thr3ed_atom_tpu.diffusion.unet import UNetModel as JaxUNet
from thr3ed_atom_tpu.diffusion.unet import count_flops_attn as jax_flops
from thr3ed_atom_tpu_torch.diffusion import unet as tunet

# tests/test_diffusion.py's tiny_unet, its 2-D case, and the paths it leaves out
CONFIGS = {
    "tiny": dict(in_channels=4, model_channels=8, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(), channel_mult=(1, 2), dims=3, num_heads=2,
                 use_scale_shift_norm=True, use_bottleneck_attn=True),
    "attn2d": dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
                   attention_resolutions=(2,), channel_mult=(1, 2), dims=2, num_heads=2),
    "updown": dict(in_channels=4, model_channels=8, out_channels=4, num_res_blocks=1,
                   channel_mult=(1, 2), dims=3, num_heads=2, use_scale_shift_norm=True,
                   resblock_updown=True),
    "classes": dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=2,
                    attention_resolutions=(1,), channel_mult=(1, 2), dims=2,
                    num_head_channels=4, num_classes=5),
    "no_scale_shift": dict(in_channels=4, model_channels=8, out_channels=4, num_res_blocks=1,
                           channel_mult=(1, 2, 2), dims=1, num_heads=2,
                           use_scale_shift_norm=False, use_bottleneck_attn=False,
                           conv_resample=False, dropout=0.1),
}
# the training CLI's UNet on a scene of SH degree 2 (28 channels)
APP = dict(in_channels=28, model_channels=32, out_channels=28, num_res_blocks=1,
           attention_resolutions=(), use_bottleneck_attn=True, channel_mult=(1, 2, 4, 8),
           dims=3, num_heads=4, use_scale_shift_norm=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


def _inputs(cfg, seed=1, size=None):
    """[2, size^dims, C] inputs: 8 a side, 32 for the 1-D model, whose three
    levels would otherwise leave two positions in each bottleneck group (the
    group statistics of two near-equal values are ill-conditioned in both
    packages: 1e-5 apart at 8, 1e-7 at 16 and 32)."""
    size = size or (32 if cfg["dims"] == 1 else 8)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *(size,) * cfg["dims"], cfg["in_channels"])).astype(np.float32)
    t = np.array([3, 7])
    y = np.array([1, 4]) if cfg.get("num_classes") else None
    return x, t, y


def _jax_model(cfg, x, t, y, seed=2):
    """The flax UNet and a perturbed parameter tree for it: the port's
    flax-style initialisation carried to flax's names and layouts, checked
    against the tree flax's init builds (jax.eval_shape: no compute)."""
    unet = JaxUNet(**cfg)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            None if y is None else jnp.asarray(y))
    params = tunet.flax_params(tunet.UNetModel(**cfg, generator=torch.Generator().manual_seed(seed)))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    return unet, _perturbed(params, seed)


def _grad_leaves(module):
    """The parameters' gradients as leaves of the module's flax tree."""
    tree = tunet._map_tree(module.flax_tree(),
                           lambda tensor, layout: tunet._to_flax(tensor.grad, layout))
    return tunet.flax_leaves(tree)


def _cosine(a, b):
    a = np.concatenate([np.ravel(v) for v in a])
    b = np.concatenate([np.ravel(np.asarray(v)) for v in b])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert np.shape(u) == np.shape(v)
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("use_checkpoint", [False, True])
@pytest.mark.parametrize("name", ["tiny", "classes"])
def test_parameter_map_both_ways(name, use_checkpoint):
    """flax -> port -> flax returns the same tree, and flax's forward on a
    tree the port wrote equals the port's forward."""
    cfg = dict(CONFIGS[name], use_checkpoint=use_checkpoint)
    x, t, y = _inputs(cfg)
    unet, params = _jax_model(cfg, x, t, y)
    mod = tunet.UNetModel(**cfg)
    tunet.load_flax_params(mod, params)
    _assert_same_tree(tunet.flax_params(mod), params)
    names = set(params["params"])
    block = "CheckpointResBlock_0" if use_checkpoint else "ResBlock_0"
    other = "ResBlock_0" if use_checkpoint else "CheckpointResBlock_0"
    assert block in names and other not in names

    fresh = tunet.UNetModel(**cfg, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.05)
    yt = None if y is None else torch.from_numpy(y)
    got = fresh(torch.from_numpy(x), torch.from_numpy(t), yt).detach().numpy()
    want = np.asarray(jax.jit(unet.apply)(tunet.flax_params(fresh), x, t, y))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a tree of the other naming does not load
    wrong = tunet.UNetModel(**dict(cfg, use_checkpoint=not use_checkpoint))
    with pytest.raises(ValueError, match="names"):
        tunet.load_flax_params(wrong, params)


def test_flax_initialisation_statistics():
    """Kernels lecun-normal (std sqrt(1 / fan_in), truncated at 2 std),
    biases zero, GroupNorm scales one, the output conv and the attention
    projection zero, as flax initialises them."""
    mod = tunet.UNetModel(**dict(CONFIGS["tiny"], model_channels=32),
                          generator=torch.Generator().manual_seed(0))
    tree = tunet.flax_params(mod)["params"]
    k = tree["ResBlock_1"]["Conv_0"]["kernel"]  # [3, 3, 3, 32, 64]
    std = np.sqrt(1.0 / (27 * 32))
    assert abs(k.std() / std - 1) < 0.02 and np.abs(k).max() <= 2 * std / 0.8796256 + 1e-6
    assert not tree["ResBlock_1"]["Conv_0"]["bias"].any()
    assert not tree["ResBlock_1"]["Conv_1"]["kernel"].any()  # zero-initialised
    assert not tree["Conv_1"]["kernel"].any()  # the output conv
    assert not tree["AttentionBlock_0"]["Dense_1"]["kernel"].any()
    assert (tree["GroupNorm32_0"]["GroupNorm_0"]["scale"] == 1).all()
    again = tunet.flax_params(tunet.UNetModel(**dict(CONFIGS["tiny"], model_channels=32),
                                              generator=torch.Generator().manual_seed(0)))
    _assert_same_tree(again, {"params": tree})


@pytest.mark.parametrize("use_checkpoint", [True, False])
def test_full_width_tree_matches_flax(use_checkpoint):
    """The training CLI's UNet: names, shapes and leaf order of its flax tree
    equal flax's (jax.eval_shape: no compute). With checkpointing the blocks
    are CheckpointResBlock_N; the leaves sort as strings, so CheckpointResBlock_*
    precede Conv_* and ResBlock_10 .. 13 sit between ResBlock_1 and ResBlock_2."""
    cfg = dict(APP, use_checkpoint=use_checkpoint)
    shapes = jax.eval_shape(JaxUNet(**cfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 16, 16, 28), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))
    mine = tunet.flax_params(tunet.UNetModel(**cfg))
    want = [(jax.tree_util.keystr(p), tuple(v.shape))
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(jax.tree_util.keystr(p), np.shape(v))
           for p, v in jax.tree_util.tree_flatten_with_path(mine)[0]]
    assert got == want
    leaves = tunet.flax_leaves(mine)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(mine)):
        assert a is b
    prefix = "CheckpointResBlock" if use_checkpoint else "ResBlock"
    blocks = [k for k in mine["params"] if k.startswith(prefix)]
    assert len(blocks) == 14
    order = sorted(mine["params"])
    assert order.index(f"{prefix}_1") < order.index(f"{prefix}_10") < order.index(f"{prefix}_2")
    if use_checkpoint:
        assert order.index("CheckpointResBlock_9") < order.index("Conv_0")
    n_params = sum(int(np.prod(s)) for _, s in want)
    assert n_params == sum(p.numel() for p in tunet.UNetModel(**cfg).parameters())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_gradient_equal_jax(name):
    """Forward within rtol 1e-5 / atol 1e-5; the parameter gradient of a
    squared-error loss with cosine > 0.99999 (and each leaf's shape)."""
    cfg = CONFIGS[name]
    x, t, y = _inputs(cfg)
    unet, params = _jax_model(cfg, x, t, y)
    target = np.random.default_rng(3).normal(size=(*x.shape[:-1], cfg["out_channels"]))
    target = target.astype(np.float32)

    def jax_loss(p):
        return jnp.mean((unet.apply(p, x, t, y) - target) ** 2)

    want = np.asarray(jax.jit(unet.apply)(params, x, t, y))
    want_g = jax.tree_util.tree_leaves(jax.jit(jax.grad(jax_loss))(params))

    mod = tunet.UNetModel(**cfg)
    tunet.load_flax_params(mod, params)
    out = mod(torch.from_numpy(x), torch.from_numpy(t), None if y is None else torch.from_numpy(y))
    assert out.shape == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    got_g = _grad_leaves(mod)
    assert [np.shape(g) for g in got_g] == [np.shape(g) for g in want_g]
    assert _cosine(got_g, want_g) > 0.99999


def test_checkpointing_keeps_output_and_gradient():
    """use_checkpoint recomputes each ResBlock in the backward: the output
    and every gradient are those of the plain module."""
    cfg = CONFIGS["tiny"]
    x, t, _ = _inputs(cfg)
    _, params = _jax_model(cfg, x, t, None)
    outs, grads = [], []
    for use_checkpoint in (False, True):
        mod = tunet.UNetModel(**dict(cfg, use_checkpoint=use_checkpoint))
        tunet.load_flax_params(mod, {"params": {
            k.replace("ResBlock", "CheckpointResBlock") if use_checkpoint else k: v
            for k, v in params["params"].items()}})
        out = mod(torch.from_numpy(x), torch.from_numpy(t))
        (out ** 2).mean().backward()
        outs.append(out.detach())
        grads.append(torch.cat([p.grad.ravel() for p in mod.parameters()]))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_dropout_runs_only_when_not_deterministic():
    cfg = CONFIGS["no_scale_shift"]
    x, t, _ = _inputs(cfg)
    _, params = _jax_model(cfg, x, t, None)
    mod = tunet.UNetModel(**cfg)
    tunet.load_flax_params(mod, params)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    torch.testing.assert_close(mod(xt, tt), mod(xt, tt), rtol=0, atol=0)
    torch.manual_seed(0)
    assert not torch.equal(mod(xt, tt, deterministic=False), mod(xt, tt))
    with pytest.raises(ValueError, match="class-conditional"):
        mod(xt, tt, torch.tensor([1, 2]))


def test_attention_pool_and_flops_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4, 3, 8)).astype(np.float32)
    pool = JaxPool(embed_dim=12, output_dim=5, num_heads=3)
    params = _perturbed(pool.init(jax.random.PRNGKey(0), x), 7)
    mod = tunet.AttentionPool2d((4, 3), 8, 12, output_dim=5, num_heads=3)
    tunet.load_flax_params(mod, params)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(pool.apply(params, x)), rtol=1e-5, atol=1e-5)
    assert tunet.count_flops_attn(2, (14, 14, 14), 256) == jax_flops(2, (14, 14, 14), 256)


def test_flax_unflatten_inverts_flax_leaves():
    tree = tunet.flax_params(tunet.UNetModel(**CONFIGS["tiny"]))
    leaves = tunet.flax_leaves(tree)
    _assert_same_tree(tunet.flax_unflatten(tree, leaves), tree)
    with pytest.raises(ValueError):
        tunet.flax_unflatten(tree, leaves + [np.zeros(1)])

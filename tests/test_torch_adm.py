"""ADM's options of the port's 3inFusion path (no JAX): the UNet at ADM's
options (resampling residual blocks, scale-shift norm, attention at two
levels in heads of 8, 8 groups, learned range, dropout) against the plain
reference ``benchmark/reference/adm_plain.py`` with the program's dropout
masks (forward, hybrid loss, gradients, one Adam + EMA step, f32); the fused
attention against ``_attention``; the fp16 loss scale (halve and skip on a
non-finite gradient, growth, unscaled gradients, f32 master weights); dropout
in training only; the 3inFusion recipe's step bit-identical to its f32 path
before these options; the CLI's options. The ``gpu`` cases hold the fp16
path against the f32 reference on the card, and show guided-diffusion's own
fp16 attention losing the q and k gradient over 32,768 tokens where the
fused kernel loses it:

    python -m pytest --noconftest -m gpu tests/test_torch_adm.py
"""
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from thr3ed_atom_tpu_torch.apps import train_thre3infusion as cli
from thr3ed_atom_tpu_torch.diffusion import unet as unet_module
from thr3ed_atom_tpu_torch.diffusion.gaussian_diffusion import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    get_named_beta_schedule,
)
from thr3ed_atom_tpu_torch.diffusion.model import Thre3inFusionModel
from thr3ed_atom_tpu_torch.diffusion.unet import UNetModel, _attention, fused_attention

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("adm_plain",
                                               REPO / "benchmark" / "reference" / "adm_plain.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

C, BASE, MULT, HEAD, GROUPS, P = 4, 16, (1, 2), 8, 8, 0.1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unet(use_fp16=False, dropout=P, use_checkpoint=True, seed=1):
    return UNetModel(in_channels=C, model_channels=BASE, out_channels=2 * C, num_res_blocks=1,
                     attention_resolutions=(1, 2), channel_mult=MULT, dims=3,
                     use_checkpoint=use_checkpoint, num_head_channels=HEAD,
                     use_scale_shift_norm=True, resblock_updown=True, dropout=dropout,
                     norm_groups=GROUPS, use_fp16=use_fp16,
                     generator=torch.Generator().manual_seed(seed))


def _randomize(unet, seed=2):
    """Every parameter drawn (the flax init leaves the output convolutions
    at zero, which would hide their paths)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(unet.named_parameters()):
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p[0].numel()))
            elif not name.endswith("norm.weight"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return unet


def _reference(unet, dropout=P):
    r = ref.UNet(C, BASE, MULT, 1, (1, 2), HEAD, GROUPS, dropout, 2 * C)
    r.load_state_dict(unet.state_dict())
    return r


def _diffusion(steps=1000):
    return GaussianDiffusion(betas=get_named_beta_schedule("cosine", steps),
                             model_mean_type=ModelMeanType.EPSILON,
                             model_var_type=ModelVarType.LEARNED_RANGE,
                             loss_type=LossType.RESCALED_MSE)


def _batch(seed=3, batch=2, side=8):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.rand((batch, side, side, side, C), generator=gen) * 2 - 1
    noise = torch.randn(x0.shape, generator=gen)
    return x0, torch.tensor([0, 617][:batch]), noise


class _Recorder:
    """The program's dropout, keeping each forward call's mask (a recomputed
    block's call comes after the forward's and redraws the same mask)."""

    def __init__(self, count):
        self.count, self.calls, self.masks = count, 0, []

    def __call__(self, h, p):
        out, mask = torch.native_dropout(h, p, True)
        self.calls += 1
        if len(self.masks) < self.count:
            self.masks.append(mask)
        return out


def _blocks(unet):
    return sum(isinstance(m, unet_module.ResBlock) for m in unet.modules())


def _close(a, b, rtol):
    a, b = a.detach(), b.detach()
    scale = max(float(b.abs().max()), 1e-12)
    assert float((a - b).abs().max()) <= rtol * scale, (float((a - b).abs().max()), scale)


def _close_norm(a, b, rtol):
    gap, scale = float((a - b).double().norm()), float(b.double().norm())
    assert gap <= rtol * scale, (gap, scale)


def test_forward_loss_and_gradients_match_the_reference(monkeypatch):
    """f32, dropout on with the program's masks: the UNet's output, the
    per-crop hybrid loss (t = 0 takes the decoder NLL) and every gradient."""
    unet = _randomize(_unet())
    r = _reference(unet)
    x0, t, noise = _batch()
    rec = _Recorder(_blocks(unet))
    monkeypatch.setattr(unet_module, "dropout", rec)
    model = Thre3inFusionModel(unet, _diffusion(), device="cpu")
    losses = model.diffusion.training_losses(model._train_model_fn, x0, t, noise=noise)["loss"]
    losses.mean().backward()
    assert len(rec.masks) == _blocks(unet) == 10
    assert rec.calls == 20  # each block recomputed under use_checkpoint
    want = ref.hybrid_loss(r, x0, t, noise, ref.Schedule(1000), rec.masks)
    _close(losses.detach(), want.detach(), 1e-5)
    grads = torch.autograd.grad(want.mean(), list(r.parameters()))
    mine = dict(unet.named_parameters())
    for (name, _), g in zip(r.named_parameters(), grads):
        _close(mine[name].grad, g, 1e-4)
    x_t = torch.randn(x0.shape, generator=torch.Generator().manual_seed(5))
    rec.masks = []
    with torch.no_grad():
        out = unet(x_t, t, deterministic=False)
        _close(out, r(x_t, t, rec.masks), 1e-5)


def test_one_adam_and_ema_step_matches_the_reference(monkeypatch):
    """f32: Thre3inFusionModel.train_step with Adam and an EMA at 0.99: its
    loss against the reference's (the same masks), its gradients against the
    reference's as a whole, and its step against the reference's Adam and
    EMA given the program's gradients (Adam's first step moves an element by
    lr g / (|g| + eps), so round-off in a near-zero gradient moves it by up
    to lr)."""
    unet = _randomize(_unet())
    r = _reference(unet)
    start = [p.detach().clone() for p in r.parameters()]
    x0, t, noise = _batch(seed=4)
    rec = _Recorder(_blocks(unet))
    monkeypatch.setattr(unet_module, "dropout", rec)
    model = Thre3inFusionModel(unet, _diffusion(), device="cpu", ema_rate=0.99)
    optimizer = torch.optim.Adam(unet.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss = model.train_step(optimizer, x0, t, noise)
    assert model.took_step and model.lg_loss_scale is None
    params = list(r.parameters())
    want = ref.hybrid_loss(r, x0, t, noise, ref.Schedule(1000), rec.masks).mean()
    _close(loss, want.detach(), 1e-5)
    grads = torch.autograd.grad(want, params)
    mine = dict(unet.named_parameters())
    names = [n for n, _ in r.named_parameters()]
    for name, g in zip(names, grads):
        _close_norm(mine[name].grad, g, 1e-4)
    grads = [mine[name].grad for name in names]
    ref.adam_step(params, grads, [torch.zeros_like(p) for p in params],
                  [torch.zeros_like(p) for p in params], 1, 1e-3)
    ema = [s.clone() for s in start]
    ref.ema_update(ema, params, 0.99)
    order = {n: i for i, (n, _) in enumerate(unet.named_parameters())}
    for name, p, s, e in zip(names, params, start, ema):
        _close(mine[name] - s, p - s, 1e-5)
        _close(model.ema[order[name]], e, 1e-6)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float16, 3e-3),
                                        (torch.bfloat16, 3e-2)])
def test_fused_attention_matches_plain(dtype, rtol):
    """fused_attention in ``dtype`` against _attention in f32 on the same
    (rounded) q, k, v: outputs and the gradients of q, k and v."""
    gen = torch.Generator().manual_seed(6)
    qkv = [torch.randn((2, 300, 48), generator=gen).to(dtype) for _ in range(3)]
    fused = [t.clone().requires_grad_() for t in qkv]
    plain = [t.float().requires_grad_() for t in qkv]
    out = fused_attention(*fused, heads=6)
    want = _attention(*plain, heads=6)
    assert out.dtype == dtype
    _close(out.float(), want.detach(), rtol)
    cot = torch.randn(out.shape, generator=gen)
    out.float().backward(cot)
    want.backward(cot)
    for a, b in zip(fused, plain):
        _close(a.grad.float(), b.grad, 4 * rtol)


def test_half_unet_takes_the_fused_path(monkeypatch):
    """A half-precision UNet's attention blocks call fused_attention; an f32
    one keeps _attention."""
    calls = []
    real = unet_module.fused_attention
    monkeypatch.setattr(unet_module, "fused_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x0, t, _ = _batch()
    with torch.no_grad():
        _unet(dropout=0.0)(x0, t)
        assert not calls
        out = _unet(use_fp16=True, dropout=0.0)(x0, t)
    assert len(calls) == 7 and out.dtype == torch.float32


def test_loss_scale_halves_and_skips_on_a_non_finite_gradient():
    """An inf in one gradient: the step is skipped (parameters, Adam's state
    and the EMA unchanged), lg_loss_scale falls by 1, and t3.skip opens
    once; the next finite step steps and grows the scale by 1e-3."""
    unet = _randomize(_unet(use_fp16=True, dropout=0.0))
    # a scale that fits fp16 at this size (ADM's 2 ** 20 overflows crops of 8^3)
    model = Thre3inFusionModel(unet, _diffusion(), device="cpu", ema_rate=0.9)
    model.lg_loss_scale = 10.0
    optimizer = torch.optim.Adam(unet.parameters(), lr=1e-3)
    model.train_step(optimizer, *_batch(seed=7))
    assert model.took_step and model.lg_loss_scale == pytest.approx(10.001)
    params = [p.detach().clone() for p in unet.parameters()]
    moments = [optimizer.state[p]["exp_avg"].clone() for p in unet.parameters()]
    ema = [e.clone() for e in model.ema]
    hook = unet.conv_in.weight.register_hook(lambda g: torch.full_like(g, float("inf")))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.train_step(optimizer, *_batch(seed=8))
    hook.remove()
    assert not model.took_step and model.lg_loss_scale == pytest.approx(9.001)
    names = [e.name for e in prof.events()]
    assert names.count("t3.skip") == 1 and names.count("t3.step") == 1
    assert {"t3.forward", "t3.backward", "t3.optimizer"} <= set(names)
    assert "t3.attention" in names
    for p, q, m, e, f in zip(unet.parameters(), params, moments, model.ema, ema):
        assert torch.equal(p, q) and torch.equal(optimizer.state[p]["exp_avg"], m)
        assert torch.equal(e, f)
    assert all(int(s["step"]) == 1 for s in optimizer.state.values())
    model.train_step(optimizer, *_batch(seed=9))
    assert model.took_step and model.lg_loss_scale == pytest.approx(9.002)


def test_loss_scale_unscales_the_gradients():
    """A scaled step computed in f32 (compute_dtype set back to f32) steps
    as the unscaled f32 step does: the same gradients and parameters."""
    scaled = _randomize(_unet(use_fp16=True, dropout=0.0))
    scaled.compute_dtype = torch.float32
    plain = _randomize(_unet(dropout=0.0))
    models = [Thre3inFusionModel(u, _diffusion(), device="cpu") for u in (scaled, plain)]
    opts = [torch.optim.Adam(u.parameters(), lr=1e-3) for u in (scaled, plain)]
    for m, o in zip(models, opts):
        m.train_step(o, *_batch(seed=7))
    assert models[0].lg_loss_scale == pytest.approx(20.001) and models[1].lg_loss_scale is None
    for a, b in zip(scaled.parameters(), plain.parameters()):
        _close(a.grad, b.grad, 1e-6)
        _close(a.detach(), b.detach(), 1e-6)


def test_master_weights_stay_f32_and_round_per_call():
    """The fp16 UNet keeps f32 parameters (the master weights) through a
    step; its output is that of the parameters rounded to fp16, so rounding
    them in place changes nothing."""
    unet = _randomize(_unet(use_fp16=True, dropout=0.0))
    model = Thre3inFusionModel(unet, _diffusion(), device="cpu")
    model.train_step(torch.optim.Adam(unet.parameters(), lr=1e-3), *_batch(seed=7))
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    x0, t, _ = _batch(seed=10)
    x0, t = x0.clone(), t.clone()
    keep = ("time_embed", "emb_dense", "out_norm", "conv_out")  # f32 in ADM's split
    with torch.no_grad():
        first = unet(x0, t)
        for name, p in unet.named_parameters():
            if not any(k in name for k in keep) and "norm" not in name:
                p.copy_(p.half().float())
        assert torch.equal(unet(x0, t), first)


def test_dropout_acts_in_training_only(monkeypatch):
    """train_step draws a mask in each residual block (twice under
    use_checkpoint); sampling and the bits-per-dim loop draw none."""
    unet = _randomize(_unet())
    rec = _Recorder(_blocks(unet))
    monkeypatch.setattr(unet_module, "dropout", rec)
    model = Thre3inFusionModel(unet, _diffusion(4), device="cpu")
    x0, _, noise = _batch()
    model.train_step(torch.optim.Adam(unet.parameters(), lr=1e-3), x0, torch.tensor([0, 3]),
                     noise)
    assert rec.calls == 2 * _blocks(unet) == 20
    rec.calls = 0
    gen = torch.Generator().manual_seed(0)
    model.sample((8, 8, 8), 1, generator=gen, max_iter=2)
    model.diffusion.calc_bpd_loop(model.model_fn(), _batch()[0][:1], generator=gen)
    assert rec.calls == 0


def test_recipe_step_is_bit_identical_to_its_f32_path():
    """The CLI's default recipe (the thre3infusion_unet32 configuration at
    width 8): train_step equals, bit for bit, the f32 step without ADM's
    options (zero_grad, the loss through the UNet, backward, Adam)."""
    def recipe():
        return UNetModel(in_channels=C, model_channels=8, out_channels=C, num_res_blocks=1,
                         attention_resolutions=(), use_bottleneck_attn=True,
                         channel_mult=(1, 2, 4, 8), conv_resample=True, dims=3,
                         use_checkpoint=True, num_heads=4, use_scale_shift_norm=True,
                         generator=torch.Generator().manual_seed(11))

    diffusion = GaussianDiffusion(betas=get_named_beta_schedule("cosine", 500),
                                  model_mean_type=ModelMeanType.EPSILON,
                                  model_var_type=ModelVarType.FIXED_SMALL, loss_type=LossType.MSE)
    a, b = _randomize(recipe()), _randomize(recipe())
    model = Thre3inFusionModel(a, diffusion, device="cpu")
    opt_a, opt_b = (torch.optim.Adam(u.parameters(), lr=8e-5) for u in (a, b))
    for seed in (12, 13):
        gen = torch.Generator().manual_seed(seed)
        x0 = torch.rand((2, 16, 16, 16, C), generator=gen) * 2 - 1
        noise = torch.randn(x0.shape, generator=gen)
        t = torch.tensor([3, 400])
        loss_a = model.train_step(opt_a, x0, t, noise)
        opt_b.zero_grad(set_to_none=True)
        loss_b = diffusion.training_losses(b, x0, t, noise=noise)["loss"].mean()
        loss_b.backward()
        opt_b.step()
        assert torch.equal(loss_a, loss_b.detach())
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


ADM_FLAGS = ["--model_channels", "16", "--num_res_blocks", "1", "--channel_mult", "1", "2",
             "--attention_resolutions", "1", "2", "--num_head_channels", "8",
             "--resblock_updown", "true", "--dropout", "0.1", "--learn_sigma", "true",
             "--use_fp16", "true", "--norm_groups", "8", "--ema_rate", "0.9999"]


def test_cli_selects_adm_and_keeps_its_defaults():
    """The new options parse to ADM's choices; without them the parser gives
    the recipe's values."""
    args = cli.build_parser().parse_args(["-i", "m", "-o", "o"] + ADM_FLAGS)
    assert args.channel_mult == [1, 2] and args.attention_resolutions == [1, 2]
    assert args.resblock_updown and args.learn_sigma and args.use_fp16
    assert (args.num_head_channels, args.norm_groups, args.dropout, args.ema_rate) == (
        8, 8, 0.1, 0.9999)
    base = cli.build_parser().parse_args(["-i", "m", "-o", "o"])
    assert base.channel_mult == [1, 2, 4, 8] and base.attention_resolutions == []
    assert not (base.resblock_updown or base.learn_sigma or base.use_fp16)
    assert (base.num_head_channels, base.norm_groups, base.dropout, base.ema_rate) == (
        -1, 16, 0.0, None)


def test_cli_runs_one_adm_step_on_the_cpu(tmp_path):
    """One step of ADM's options at width 16 on a 16^3 scene's 8^3 crops:
    the model as configured, its checkpoint and its EMA's."""
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, VoxelSize
    from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

    gen = torch.Generator().manual_seed(14)
    grid = VoxelGrid(densities=torch.rand((16, 16, 16, 1), generator=gen),
                     features=torch.rand((16, 16, 16, 3), generator=gen) * 2 - 1,
                     voxel_size=VoxelSize(0.125, 0.125, 0.125),
                     density_preactivation="identity", density_postactivation="relu")
    config = SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=CameraBounds(1.0, 6.0),
                                   white_bkgd=True, perturb_sampled_points=False)
    VolumetricModel(grid, "render_sh_voxel_grid", config, device="cpu").save(
        tmp_path / "scene", {"hemispherical_radius": 3.5, "camera_intrinsics": [32, 32, 35.2]})
    out = tmp_path / "run"
    model = cli.main(["-i", str(tmp_path / "scene"), "-o", str(out), "--num_timesteps", "16",
                      "--batch_size", "2", "--num_iters", "1", "--crop_ratio", "0.125",
                      "--sample_frequency", "100", "--save_frequency", "1"] + ADM_FLAGS,
                     device="cpu")
    unet = model.unet
    assert (unet.out_channels, unet.channel_mult, unet.attention_resolutions) == (8, (1, 2), (1, 2))
    assert unet.use_fp16 and unet.resblock_updown and unet.norm_groups == 8
    assert model.diffusion.model_var_type is ModelVarType.LEARNED_RANGE
    assert model.diffusion.loss_type is LossType.RESCALED_MSE
    assert model.lg_loss_scale == pytest.approx(20.001) and model.ema is not None
    saved = out / "saved_models"
    for name in ("model_1", "model_final", "ema_1", "ema_final"):
        assert (saved / f"{name}.npz").exists(), name
    meta = json.loads((saved / "model_final.json").read_text())["unet_config"]
    assert meta["use_fp16"] is True and meta["norm_groups"] == 8 and meta["dropout"] == 0.1


# ------------------------------------------------------------------ the card


@pytest.mark.gpu
def test_fp16_step_against_the_f32_reference_on_the_card(monkeypatch):
    """On a card, at width 64 with heads of 64 on 16^3 crops: the fp16
    program's hybrid loss and gradients against the f32 reference with the
    same masks (fp16 round-off: loss within 1e-2, gradient cosines above
    0.99), and its attention through the flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref.strict_f32()
    cuda = torch.device("cuda")
    with torch.device(cuda):
        unet = UNetModel(in_channels=C, model_channels=64, out_channels=2 * C, num_res_blocks=1,
                         attention_resolutions=(1, 2), channel_mult=(1, 2), dims=3,
                         use_checkpoint=True, num_head_channels=64, use_scale_shift_norm=True,
                         resblock_updown=True, dropout=P, norm_groups=32, use_fp16=True)
        r = ref.UNet(C, 64, (1, 2), 1, (1, 2), 64, 32, P, 2 * C)
    _randomize(unet)
    r.load_state_dict(unet.state_dict())
    x0, t, noise = (v.to(cuda) for v in _batch(side=16))
    rec = _Recorder(_blocks(unet))
    monkeypatch.setattr(unet_module, "dropout", rec)
    model = Thre3inFusionModel(unet, _diffusion(), device=cuda)
    with torch.profiler.profile() as prof:
        loss = model.diffusion.training_losses(model._train_model_fn, x0, t, noise=noise)["loss"]
        (loss.mean() * 1024.0).backward()
        torch.cuda.synchronize()
    assert any("flash" in e.name for e in prof.events())
    want = ref.hybrid_loss(r, x0, t, noise, ref.Schedule(1000), rec.masks)
    assert float(((loss - want).abs() / want.abs()).max()) < 1e-2
    grads = torch.autograd.grad(want.mean() * 1024.0, list(r.parameters()))
    mine = dict(unet.named_parameters())
    for (name, _), g in zip(r.named_parameters(), grads):
        a, b = mine[name].grad.double().flatten(), g.double().flatten()
        if float(b.norm()) > 1e-6 * 1024:
            assert float(a @ b / (a.norm() * b.norm())) > 0.99, name


@pytest.mark.gpu
def test_fused_attention_on_the_card_holds_no_logits():
    """On a card, fp16 attention over 32,768 tokens in 6 heads of 64 (a
    crop's ds-2 block): no [N, N] tensor (the peak grows by far less than
    one head's logits), and the output of 1024 queries against the f32
    plain attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = (torch.randn((1, 32768, 384), generator=gen, device=cuda).half()
               for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fused_attention(q, k, v, 6)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 32768 * 32768 * 2 // 16
    heads = [t.float().reshape(1, -1, 6, 64).transpose(1, 2) for t in (q, k, v)]
    logits = heads[0][:, :, :1024] @ heads[1].transpose(-1, -2) / 8.0
    want = (torch.softmax(logits, -1) @ heads[2]).transpose(1, 2).reshape(1, 1024, 384)
    _close(out[:, :1024].float(), want, 3e-3)


def _adm_qkv_attention(qkv, heads: int) -> torch.Tensor:
    """guided-diffusion's ``QKVAttention`` (the new order) as written there:
    [B, 3 * heads * ch, T] -> [B, heads * ch, T]."""
    bs, width, length = qkv.shape
    ch = width // (3 * heads)
    q, k, v = qkv.chunk(3, dim=1)
    scale = 1 / math.sqrt(math.sqrt(ch))
    weight = torch.einsum("bct,bcs->bts", (q * scale).view(bs * heads, ch, length),
                          (k * scale).view(bs * heads, ch, length))
    weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
    a = torch.einsum("bts,bcs->bct", weight, v.reshape(bs * heads, ch, length))
    return a.reshape(bs, -1, length)


@pytest.mark.gpu
def test_fp16_loses_the_qk_gradient_at_32k_tokens_in_adm_attention_too():
    """On a card, one head of 64 over 32,768 tokens in fp16, against the
    same attention in f32: with an output gradient dO of order 1 both
    guided-diffusion's ``QKVAttention`` and ``fused_attention`` keep the
    gradient of q and k (error under 2%); with dO ~ 2^-20 both lose it
    (error above 0.9), because each logit's gradient, P ~ 1/32,768 times
    dO . v, is rounded to fp16 before the sum over keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref.strict_f32()
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(16)
    n = 32768
    qkv = torch.randn((1, 192, n), generator=gen, device=cuda)
    d_out = torch.randn((1, 64, n), generator=gen, device=cuda)

    def grads(fn, x, g):
        x = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(fn(x), x, g)
        return dx.float()[:, :128]  # q's and k's

    def fused(x):  # q, k and v as the attention block hands them over: [B, N, C], C innermost
        q, k, v = x.transpose(1, 2).contiguous().chunk(3, dim=-1)
        return fused_attention(q, k, v, 1).transpose(1, 2)

    for scale, lost in ((1.0, False), (2.0 ** -20, True)):
        g = d_out * scale
        want = grads(lambda x: _adm_qkv_attention(x, 1), qkv, g)
        for fn in (lambda x: _adm_qkv_attention(x, 1), fused):
            got = grads(fn, qkv.half(), g.half())
            for a, b in ((got[:, :64], want[:, :64]), (got[:, 64:], want[:, 64:])):
                error = float((a - b).norm() / b.norm())
                assert (error > 0.9) if lost else (error < 0.02), (scale, error)
            del got
            torch.cuda.empty_cache()

"""The PyTorch port's multi-device training against the JAX package's mesh
steps: K9 / K10 at a group offset, the table builders' group ranges, and the
gnomonic, bricked and ray-batch steps over gloo worlds of 2 and 4 ranks on
the CPU (tests/torch_mesh_workers.py runs the ranks; the JAX package runs
its mesh steps on the 8 virtual CPU devices of tests/conftest.py, its Pallas
kernels in interpret mode). The port is fed the JAX steps' draws. Every
tolerance is the one the port's single-device test of the same step uses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_workers as workers
from test_slab_march_grad import NCOEFF
from test_torch_bricked import _jax_draws, _tile_rays as _bricked_tile_rays
from test_torch_gnomonic import _grids, _one_torch_thread, _pose_arrays, _scene  # noqa: F401
from test_torch_raybatch_trainer import (
    FAST,
    _grid_pair,
    _jax_statics,
    _jax_step_draws,
    _statics as _ray_statics,
    _views,
)
from test_torch_slab_march import _inputs
from test_torch_train_ops import _rel_stats
from thr3ed_atom_tpu.modules import bricked_trainer as btj
from thr3ed_atom_tpu.modules import trainer as trainer_jax
from thr3ed_atom_tpu.ops.pallas import slab_march as sm_jax
from thr3ed_atom_tpu.rendering import bricked as brj
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu.rendering import planes as plj
from thr3ed_atom_tpu_torch.modules import bricked_trainer as btt
from thr3ed_atom_tpu_torch.ops import slab_march as sm
from thr3ed_atom_tpu_torch.rendering import bricked as brt
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.rendering import planes as plt_
from thr3ed_atom_tpu_torch.utils.camera import pose_spherical


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


# ------------------------------------------------------------------ repairs


def test_slab_march_group_offset_matches_jax():
    """K9 / K10's plain versions on a depth segment: the entries of groups
    1 and 2 of tests/test_slab_march_grad.py's tables (global indices; its
    seeded tables hold no group 0), the grid operand holding groups [1, 3),
    group_offset 1. Against the JAX
    package's slab_march at the same offset (interpret mode): the forward
    within max-abs 2e-6 and the gradient within one bf16 unit of its largest
    element with cosine > 0.99999 (the bounds of
    tests/test_torch_slab_march.py). Within the port the offset is a pure
    rebase: the same tables over the whole grid at offset 0 march bit-equal,
    and their cotangent's groups 1-2 are the segment's (group 0's zero)."""
    (tj, cj, rj, gj), (_, _, rt, gt_) = _inputs()
    tables, counts = np.array(tj), np.array(cj)
    seg_tab, seg_cnt = np.zeros_like(tables), np.zeros_like(counts)
    for i in range(len(tables)):
        e = tables[i, :counts[i, 0]]
        e = e[e[:, 0] >= 1]
        seg_tab[i, :len(e)], seg_cnt[i, 0] = e, len(e)
    assert seg_cnt.min() > 0
    tt, ct = torch.from_numpy(seg_tab), torch.from_numpy(seg_cnt)
    tj, cj = jnp.asarray(seg_tab), jnp.asarray(seg_cnt)
    gw = np.random.default_rng(5).normal(size=(len(tables), rt.shape[1], 8)).astype(np.float32)
    kw = dict(ncoeff=NCOEFF, exit_eps=0.0, with_diffuse=True)
    want = np.asarray(sm_jax.slab_march(tj, cj, rj, gj[1:], group_offset=1, interpret=True,
                                        **kw))
    got = sm.slab_march_render_plain(tt, ct, rt, gt_[1:], group_offset=1, **kw)
    assert np.abs(got.numpy() - want).max() <= 2e-6 and np.abs(want[..., 3]).max() > 0.1
    dwant = jax.grad(lambda g: jnp.sum(sm_jax.slab_march(tj, cj, rj, g, group_offset=1,
                                                         interpret=True, **kw) * gw))(gj[1:])
    dwant = np.asarray(dwant.astype(jnp.float32))
    g = gt_[1:].clone().requires_grad_(True)
    (sm.slab_march(tt, ct, rt, g, group_offset=1, plain=True, **kw)
     * torch.from_numpy(gw)).sum().backward()
    dgot = g.grad.float().numpy()
    scale = np.abs(dwant).max()
    cos = float((dgot * dwant).sum() / np.sqrt((dgot ** 2).sum() * (dwant ** 2).sum()))
    print(f"group offset: forward gap {np.abs(got.numpy() - want).max():.3g}, gradient gap "
          f"{np.abs(dgot - dwant).max():.3g} of {scale:.3g}, cosine {cos:.9f}")
    assert scale > 1e-3 and np.abs(dgot - dwant).max() <= scale * 2.0 ** -8 and cos > 0.99999
    np.testing.assert_array_equal(sm.slab_march_render_plain(tt, ct, rt, gt_, **kw).numpy(),
                                  got.numpy())
    full = sm.slab_march_grad_plain(tt, ct, rt, gt_, got, torch.from_numpy(gw), **kw)
    seg = sm.slab_march_grad_plain(tt, ct, rt, gt_[1:], got, torch.from_numpy(gw),
                                   group_offset=1, **kw)
    np.testing.assert_array_equal(full[1:].numpy(), seg.numpy())
    assert not full[0].any() and seg.any()


@pytest.mark.parametrize("kind", ["bricked", "planes"])
def test_group_range_tables_match_jax(kind):
    """build_tables(..., group_range=(g0, g1)) on the JAX package's ray
    records and the mip's slice of groups [g0, g1), for each half and for a
    middle range: tables, counts and the overflow flag array-equal to the JAX
    package's (global group indices), every entry's group inside the
    range, and the halves' live entries together those of the whole."""
    pose = pose_spherical(46.0, -49.5, 3.5 if kind == "bricked" else 4.0)
    if kind == "bricked":
        from test_torch_bricked import _statics
        jgrid, tgrid = _grids(size=16, seed=3)
        mod_j, mod_t, tile_rays = brj, brt, _bricked_tile_rays
        axis, flip = brt.dominant_axis_for_pose(np.asarray(pose.rotation))
        sj, st = _statics(jgrid, tgrid, axis, flip, axis_supersample=1)
        ro, rd = tile_rays(sj, pose, 48, 52.8)
        total = brt._slab_geometry(st)[3]
    else:
        from test_torch_planes import _grids as _plane_grids, _statics, _tile_rays
        jgrid, tgrid = _plane_grids((16,) * 3)
        mod_j, mod_t = plj, plt_
        axis, flip = plt_.dominant_axis_for_pose(np.asarray(pose.rotation))
        sj, st = _statics(jgrid, tgrid, axis, flip, pos_per_cell=2)
        ro, rd = _tile_rays(sj, pose, 32, 32, 35.2)
        total = plt_._geometry(st)[3]
    rf = mod_j.compute_ray_features(jnp.asarray(ro), jnp.asarray(rd), sj)
    occ = np.asarray(mod_j.occupancy_mip(jgrid, sj))
    half = total // 2
    live = {}
    for g0, g1 in ((0, half), (half, total), (1, total - 1)):
        tab_j, cnt_j, ovf_j = mod_j.build_tables(rf, jnp.asarray(occ[g0:g1]), sj,
                                                 group_range=(g0, g1))
        tab_t, cnt_t, ovf_t = mod_t.build_tables(torch.from_numpy(np.asarray(rf)),
                                                 torch.from_numpy(occ[g0:g1]), st,
                                                 group_range=(g0, g1))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
        assert bool(ovf_t) == bool(ovf_j)
        tab, cnt = tab_t.numpy(), cnt_t.numpy()
        mask = np.arange(tab.shape[1])[None, :] < cnt
        assert mask.any() and (tab[..., 0][mask] >= g0).all() and (tab[..., 0][mask] < g1).all()
        live[(g0, g1)] = cnt[:, 0]
    whole, cnt_w, _ = mod_t.build_tables(torch.from_numpy(np.asarray(rf)),
                                         torch.from_numpy(occ), st)
    np.testing.assert_array_equal(live[(0, half)] + live[(half, total)], cnt_w.numpy()[:, 0])
    with pytest.raises(ValueError, match="groups"):
        mod_t.build_tables(torch.from_numpy(np.asarray(rf)), torch.from_numpy(occ), st,
                           group_range=(0, half))


# ------------------------------------------------------------- the mesh steps


def _gnomonic_case(n_dev=2, k=2, size=12, hw=32):
    """The pose-parallel step's inputs and the JAX package's mesh step on
    them (n_dev devices, k views each, phase jitter from its key)."""
    d, f, config = _scene(size, seed=3)
    jgrid, _ = _grids(size=size, seed=3)
    poses = [_pose_arrays(140.0 + 6.0 * i, -30.0) for i in range(n_dev * k)]
    rots = np.stack([p[1] for p in poses]).reshape(n_dev, k, 3, 3)
    orgs = np.stack([p[2] for p in poses]).reshape(n_dev, k, 3)
    axis, flip = gn.dominant_axis_for_pose(rots[0, 0])
    assert len({gn.dominant_axis_for_pose(r) for r in rots.reshape(-1, 3, 3)}) == 1
    images = np.random.default_rng(1).random((n_dev, k, hw, hw, 3), dtype=np.float32)
    kw = dict(image_height=hw, image_width=hw, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=1, qb=128)
    tj = gt_jax.make_gnomonic_train_statics(jgrid, axis, flip, interpret=True, fused=True, **kw)
    lr, focal, key = 0.03, hw * 1.1, jax.random.PRNGKey(9)
    tx = optax.adam(lr, b1=0.9, b2=0.999)
    g_j, opt_j, m_j = gt_jax.gnomonic_train_step_mesh(
        tj, tx, n_dev, _copy(jgrid), tx.init(jgrid), jnp.asarray(images), jnp.asarray(rots),
        jnp.asarray(orgs), jnp.float32(focal), key)
    phases = [[tuple(float(x) for x in jax.random.uniform(kk, (2,), minval=-0.5, maxval=0.5))
               for kk in jax.random.split(jax.random.fold_in(key, r), k)]
              for r in range(n_dev)]
    case = dict(grid=(d, f, config), variant=(axis, flip), statics=kw, lr=lr, images=images,
                rotations=rots, origins=orgs, focal=focal, phases=phases)
    return case, dict(metrics=m_j, mu=opt_j[0].mu, grid=g_j)


def _bricked_case(shapes, tiles=4, size=40):
    """The bricked mesh step's inputs (4 tiles from three views, exit_eps 0)
    and the JAX package's bricked_train_step_mesh at each mesh shape."""
    d, f, config = _scene(13, seed=3)  # 12 slab groups: two segments of 6
    jgrid, _ = _grids(size=13, seed=3)
    rng = np.random.default_rng(6)
    P = np.stack([np.concatenate([np.asarray(p.rotation, np.float32).reshape(3, 3),
                                  np.asarray(p.translation, np.float32).reshape(3, 1)], 1)
                  for p in (pose_spherical(30.0 + 6.0 * i, -35.0, 3.5) for i in range(3))])
    axis, flip = brt.dominant_axis_for_pose(P[0][:, :3])
    images = rng.random((3, size, size, 3), dtype=np.float32)
    kw = dict(image_height=size, image_width=size, focal=size * 1.1,
              ray_batch_size=tiles * 256, white_bkgd=True, exit_eps=0.0)
    sj = btj.make_bricked_train_statics(jgrid, axis, flip, interpret=True, **kw)
    pose_idx = np.array([0, 2, 1, 0], np.int32)[:tiles]
    lr, key = 0.03, jax.random.PRNGKey(5)
    tx = optax.adam(lr, b1=0.9, b2=0.999)
    want = {}
    for shape in shapes:
        g_j, opt_j, m_j = btj.bricked_train_step_mesh(
            sj, tx, shape, _copy(jgrid), tx.init(jgrid), jnp.asarray(images), jnp.asarray(P),
            jnp.asarray(pose_idx), key)
        want[shape] = dict(metrics=m_j, mu=opt_j[0].mu, grid=g_j)
    from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy

    st = btt.make_bricked_train_statics(voxel_grid_from_numpy(d, f, config, device="cpu"),
                                        axis, flip, **kw)
    case = dict(grid=(d, f, config), variant=(axis, flip), statics=kw, lr=lr, images=images,
                poses=P, pose_idx=pose_idx, draws=_jax_draws(key, st), shapes=list(shapes))
    return case, want


def _ray_batch_case(model_parallel):
    """The ray-batch step's inputs (256 rays, fast top 16, jitter, Adam lr
    0.03 with the staircase decay) and the JAX package's _train_step with
    use_mesh (its meshes span the 8 CPU devices: the same sums)."""
    images, poses = _views()
    statics = _ray_statics(FAST, perturb_sampled_points=True)
    jgrid, tgrid = _grid_pair()
    key = jax.random.PRNGKey(11)
    tx = optax.adam(optax.exponential_decay(0.03, 3000, 0.1, staircase=True), b1=0.9, b2=0.999)
    js = dataclasses.replace(_jax_statics(statics), use_mesh=True,
                             model_parallel=model_parallel)
    jnew, _, jm = trainer_jax._train_step(js, tx, _copy(jgrid), tx.init(jgrid),
                                          jnp.asarray(images), jnp.asarray(poses), key)
    fields = {f.name: getattr(statics, f.name) for f in dataclasses.fields(statics)
              if f.name not in ("use_mesh", "model_parallel")}
    spec = (tgrid.densities.detach().numpy(), tgrid.features.detach().numpy(),
            dict(voxel_size=tuple(tgrid.voxel_size), **tgrid.get_config_dict()))
    case = dict(grid=spec, model_parallel=model_parallel, statics=fields,
                optimizer=(0.03, 3000, 0.1), images=images, poses=poses,
                draws=_jax_step_draws(key, statics, len(images)))
    return case, dict(metrics=jm, grid=jnew)


def _check_metrics(got, want, rtol=2e-5):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], float(want[name]), rtol=rtol, err_msg=name)


def _check_moments(state, mu, what):
    """Adam's first moments after one step (0.1 g) against the JAX step's:
    cosine > 0.99995 and p999 relative error < 0.12 (the single-device
    tests' gradient bounds)."""
    for fld in ("densities", "features"):
        p999, cos = _rel_stats(state[fld]["mu"], np.asarray(getattr(mu, fld)))
        print(f"{what} {fld}: gradient p999 {p999:.3g}, cosine {cos:.9f}")
        assert p999 < 0.12 and cos > 0.99995, (what, fld, p999, cos)


def _check_ray_batch(ranks, want, what):
    """Metrics within rtol 2e-5; after the Adam step the grid equal within
    1e-6 where |g| > 1e-5 and off by more than 1e-3 on at most 1% of the
    elements (tests/test_torch_raybatch_trainer.py's bounds)."""
    _check_metrics(ranks[0]["metrics"], want["metrics"])
    for fld in ("densities", "features"):
        got = ranks[0]["state"][fld]["value"]
        strong = np.abs(ranks[0]["state"][fld]["grad"]) > 1e-5
        diff = np.abs(got - np.asarray(getattr(want["grid"], fld)))
        print(f"{what} {fld}: max diff where |g| > 1e-5 {diff[strong].max():.3g}, "
              f"share off by > 1e-3 {(diff > 1e-3).mean():.4f}")
        assert strong.any() and diff[strong].max() <= 1e-6 and (diff > 1e-3).mean() <= 0.01
        for r in ranks[1:]:  # every rank's view of the whole grid is the same
            np.testing.assert_array_equal(r["state"][fld]["value"], got)
    assert all(r["agree"] for r in ranks)


def test_mesh_steps_match_jax_at_world_2(tmp_path):
    """One gloo world of 2 ranks: the gnomonic step at n_dev 2, k 2 (each
    rank its two views and the JAX key's phases for its device), the
    bricked step at (1, 2) (K9 / K10 at group offset G / 2 on rank 1) and
    at (2, 1), exit_eps 0, and the ray-batch step over "data" 2, each from
    the same grid and draws as the JAX package's mesh step. Metrics within
    rtol 2e-5, the gradients and grids within the bounds of the port's
    single-device tests of the same steps; after every step the two ranks'
    grids are bit-identical (replicas_agree)."""
    gcase, gwant = _gnomonic_case()
    bcase, bwant = _bricked_case([(1, 2), (2, 1)])
    rcase, rwant = _ray_batch_case(1)
    ranks = workers.run_world("world2", 2, dict(gnomonic=gcase, bricked=bcase,
                                                ray_batch=rcase), tmp_path)
    g = [r["gnomonic"] for r in ranks]
    _check_metrics(g[0]["metrics"], gwant["metrics"])
    _check_moments(g[0]["state"], gwant["mu"], "gnomonic mesh")
    assert all(r["agree"] for r in g) and g[0]["metrics"] == g[1]["metrics"]
    for shape in [(1, 2), (2, 1)]:
        b = [r["bricked"][shape] for r in ranks]
        _check_metrics(b[0]["metrics"], bwant[shape]["metrics"])
        _check_moments(b[0]["state"], bwant[shape]["mu"], f"bricked mesh {shape}")
        assert all(r["agree"] for r in b)
    _check_ray_batch([r["ray_batch"] for r in ranks], rwant, "ray batch data 2")


def test_mesh_steps_at_world_4(tmp_path):
    """One gloo world of 4 ranks: the ray-batch step over ("data" 2,
    "model" 2), each rank keeping an x slab of 4 of the 8^3 grid and of
    Adam's moments, against the JAX package's _train_step with
    model_parallel 2 (the bounds of the world-2 case); and the trainer's
    gnomonic stage over a mesh of 2 of the 4 ranks (mesh_devices 2): each
    step averages 2 x ceil(4 / 2) = 4 views (the view-diversity floor, as
    tests/test_trainer.py:334 checks the JAX trainer), the ranks beyond the
    mesh add zeros and end with the same grid, and only rank 0 writes."""
    from test_torch_trainer import _write_dataset

    rcase, rwant = _ray_batch_case(2)
    data = _write_dataset(tmp_path / "data", n_train=4, n_test=1, size=16)
    d, f, config = _scene(8, seed=3)
    tcase = dict(data=str(data), out=str(tmp_path / "out"), grid=(d, f, config),
                 mesh_devices=2)
    ranks = workers.run_world("world4", 4, dict(ray_batch=rcase, trainer=tcase),
                              tmp_path / "world")
    rb = [r["ray_batch"] for r in ranks]
    assert all(r["slab"] == (4, 8, 8) for r in rb)
    _check_ray_batch(rb, rwant, "ray batch (2, 2)")
    tr = [r["trainer"] for r in ranks]
    from thr3ed_atom_tpu_torch.modules.trainer import _GN_MIN_POSES_PER_STEP

    for r in tr:
        assert len(r["calls"]) == 2 and r["agree"]
        n_dev, (k,), n_phases = r["calls"][0]
        assert n_dev == 2 and n_dev * k >= _GN_MIN_POSES_PER_STEP and k == 2
        assert n_phases == (k if r["rank"] < 2 else 0)
        np.testing.assert_array_equal(r["densities"], tr[0]["densities"])
    assert np.isfinite(tr[0]["densities"]).all()
    assert "saved_models/model_final.npz" in tr[0]["wrote"]
    assert not any(r["wrote"] for r in tr[1:])


def test_dryrun_multichip_at_four_ranks(capfd):
    """dryrun_multichip(4, device="cpu") spawns four gloo ranks, runs one
    step of each mesh path (the ray batch over (2 data x 2 model), the
    bricked step over (2 tiles x 2 depth segments), the gnomonic step with
    one view a rank), checks the replicas agree and prints the JAX dry run's
    three OK lines with finite losses."""
    from thr3ed_atom_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    lines = [ln for ln in capfd.readouterr().out.splitlines() if "dryrun_multichip(4)" in ln]
    assert len(lines) == 3
    assert "mesh=(2 data x 2 model)" in lines[0]
    assert "mesh=(2 tiles x 2 depth-segments)" in lines[1]
    assert "mesh=(4 poses data-parallel)" in lines[2]
    for ln in lines:
        assert np.isfinite(float(ln.split("loss=")[1].split()[0]))


def test_replica_checksum_is_chunked_and_sees_one_bit(monkeypatch):
    """The replicas' checksum taken in chunks of 3 words equals the one taken
    in one chunk, and a flipped low bit of one word changes it."""
    from thr3ed_atom_tpu_torch.parallel import mesh as pm

    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn(5, 7, generator=gen), torch.randn(11, generator=gen)]
    whole = pm._checksum(tensors)
    monkeypatch.setattr(pm, "_CHECKSUM_CHUNK", 3)
    assert torch.equal(pm._checksum(tensors), whole)
    flipped = tensors[1].clone()
    flipped.view(torch.int32)[4] ^= 1
    assert not torch.equal(pm._checksum([tensors[0], flipped]), whole)


def test_mesh_entry_points_raise_without_a_group():
    """No fallback: a mesh step without a process group raises, as does a
    mesh wider than the world (checked on a one-rank gloo group), NCCL
    without CUDA, and a ray-batch step asked for model_parallel 2 without
    use_mesh."""
    import torch.distributed as dist

    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.parallel import mesh as pm

    statics = _ray_statics(FAST)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        gt.gnomonic_train_step_mesh(None, None, 2, None, [], [], [], 1.0)
    with pytest.raises(RuntimeError, match="process group"):
        trainer.ray_batch_train_step(dataclasses.replace(statics, use_mesh=True),
                                     None, None, None, None)
    with pytest.raises(ValueError, match="needs use_mesh"):
        trainer.ray_batch_train_step(dataclasses.replace(statics, model_parallel=2),
                                     None, None, None, None)
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_data_mesh(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            pm.init_process_group(backend="nccl", device="cpu")
    assert pm.init_process_group(device="cpu")
    try:
        assert dist.get_world_size() == 1 and not pm.init_process_group(device="cpu")
        with pytest.raises(RuntimeError, match="needs 2 ranks"):
            pm.make_data_mesh(2)
        with pytest.raises(ValueError, match="model_parallel 2"):
            trainer.ray_batch_train_step(
                dataclasses.replace(statics, use_mesh=True, model_parallel=2),
                None, None, None, None)
        mesh = pm.make_grid_mesh(1)
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(pm.shard_batch(mesh, x), x)
        assert torch.equal(pm.gather_grid_spatial(mesh, pm.shard_grid_spatial(mesh, x), 3), x)
        assert pm.replicas_agree([x]) and mesh is pm.make_grid_mesh(1)
    finally:
        dist.destroy_process_group()

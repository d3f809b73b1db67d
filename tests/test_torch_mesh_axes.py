"""The mesh's ctx axis (context parallelism over Li) and model axis (tensor
parallelism of the large dense weights) in the port
(``tvqaplus_tpu_torch/parallel/mesh.py`` and the trainer, pipeline, model
and serving runner it threads through), on the CPU: gloo ranks in
processes of their own (tests/torch_parallel_ranks.py).

Each mesh must take the step that one process takes on the global batch:
against the port's single process, against the JAX Trainer's step on the
same mesh shape, and its layout against the JAX package's own
(``make_mesh``, ``batch_shardings``, ``state_shardings``).  Tiny configs
from numpy-seeded synthetic data; each tolerance is stated at its use."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel import dispatches, port_setup
from tests.test_torch_train import STEP_CFG, port_config
from tests.test_train import small_cfg
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.parallel import mesh as jmesh
from tvqaplus_tpu.train.loop import Trainer as JaxTrainer
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.interop.weights import (
    flax_from_params,
    params_from_flax,
)
from tvqaplus_tpu_torch.models.layers import Dropout, MLPBridge
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.parallel import mesh as dp
from tvqaplus_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)
MESHES = [(-1, 2), (2, -1), (2, 2), (1, 4), (2, 1, 2), (4, 2), (1, 2, 4),
          (2, 2, 2), (-1, 1, 2)]


# ------------------------------------------------------------- the mesh
def fake_world(monkeypatch, world, rank):
    """A world of ``world`` processes without a backend: ``new_group``
    returns ("g", its ranks), so a rank's groups name their members."""
    monkeypatch.setattr(dp, "_world", lambda: (world, rank, ("world",)))
    monkeypatch.setattr(dp.dist, "new_group",
                        lambda ranks: ("g",) + tuple(ranks))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("world", [4, 8])
def test_each_rank_sits_where_jax_puts_its_device(monkeypatch, shape, world):
    """Sizes as JAX's ``make_mesh`` gives them; rank r's (d, c, m) is the
    place of device r in JAX's device grid, and its data / ctx / model /
    grad groups are the ranks of that grid that differ from it in those
    coordinates alone (the world group where they span every rank, none
    for an axis of size 1)."""
    try:
        jm = jmesh.make_mesh(shape, devices=jax.devices()[:world])
    except AssertionError:
        jm = None
    if jm is None or jm.devices.size != world:
        for rank in range(world):
            fake_world(monkeypatch, world, rank)
            with pytest.raises(ValueError):
                dp.make_mesh(shape)
        return
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    ids = ids.reshape(ids.shape + (1,) * (3 - ids.ndim))
    for rank in range(world):
        fake_world(monkeypatch, world, rank)
        mesh = dp.make_mesh(shape)
        assert mesh.shape == dict(jm.shape)
        where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert mesh.coords == where
        d, c, m = where
        members = {"data": ids[:, c, m], "ctx": ids[d, :, m],
                   "model": ids[d, c, :], "grad": ids[:, :, m].reshape(-1)}
        for name, ranks_ in members.items():
            group = getattr(mesh, f"{name}_group")
            if len(ranks_) == 1:
                assert group is None, name
            elif len(ranks_) == world:
                assert group == ("world",), name
            else:
                assert group == ("g",) + tuple(sorted(int(r) for r in
                                                      ranks_)), name


@pytest.mark.parametrize("shape, world, match", [
    ((2, 2), 8, r"data x ctx x model = 4, but 8"),
    ((1, 2, 2), 2, r"= 4, but 2"),
    ((3, -1), 8, r"does not divide"),
    ((0, 1), 1, r">= 1 or -1")])
def test_a_mesh_that_is_not_the_world_is_refused(monkeypatch, shape, world,
                                                 match):
    fake_world(monkeypatch, world, 0)
    with pytest.raises(ValueError, match=match):
        dp.make_mesh(shape)


def test_the_multihost_mesh_keeps_ctx_within_a_node(monkeypatch):
    """JAX mesh.py:80-95: ctx must divide the node's process count
    (``LOCAL_WORLD_SIZE``); the ctx ranks of a row are contiguous ranks."""
    fake_world(monkeypatch, 8, 5)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    mesh = dp.make_multihost_mesh(ctx=2)
    assert (mesh.data, mesh.ctx, mesh.coords) == (4, 2, (2, 1, 0))
    assert mesh.ctx_group == ("g", 4, 5)
    for ctx in (3, 8):
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            dp.make_multihost_mesh(ctx=ctx)


def test_an_axis_without_a_group_raises(tmp_path):
    """No fallback replicates what a ctx or model axis shards: without a
    process group the gather and the placement raise."""
    x = torch.ones(2, 4)
    with pytest.raises(RuntimeError, match="needs a process group"):
        dp.gather_ctx(dp.Mesh(data=1, ctx=2), x, 1)
    cfg, _ = port_setup_tp(tmp_path)
    with pytest.raises(RuntimeError, match="needs a process group"):
        dp.place_model(dp.Mesh(data=1, ctx=1, model=2),
                       STAGE(ModelConfig.from_config(cfg)))


def test_the_mlp_bridge_kernel_is_refused_at_model_two():
    """B5 takes whole weights: a sharded weight under ``use_kernel``
    raises, naming ROADMAP, at placement and in the forward."""
    model = torch.nn.Module()
    model.bridge = MLPBridge(256, 300, use_kernel=True)
    mesh = dp.Mesh(data=1, model=2, model_group="g")
    with pytest.raises(NotImplementedError, match="B5 at model > 1"):
        dp.place_model(mesh, model)
    model.bridge.use_kernel = False
    dp.place_model(mesh, model)
    assert model.bridge[2].weight.shape == (150, 256)
    model.bridge.use_kernel = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.bridge(torch.ones(1, 1, 2, 256))


def test_a_split_model_is_written_whole_or_not_at_all(tmp_path):
    """Outside ``full_state`` a model split over the model axis holds one
    rank's columns: the trainer's checkpoint and the flax export refuse
    it rather than write them."""
    from tvqaplus_tpu_torch.interop.weights import flax_checkpoint_tree
    from tvqaplus_tpu_torch.train.state import make_optimizer, \
        save_checkpoint
    cfg, _ = port_setup_tp(tmp_path)
    model = STAGE(ModelConfig.from_config(cfg))
    opt = make_optimizer(list(model.parameters()), 1e-3)
    dp.place_model(dp.Mesh(data=1, model=2, model_group="g"), model)
    assert model.bert_word_encoding_fc[2].weight.shape == (150, 256)
    with pytest.raises(ValueError, match="full_state"):
        save_checkpoint(str(tmp_path / "x.ckpt"), model, opt, 0)
    with pytest.raises(ValueError, match="full_state"):
        flax_checkpoint_tree(model, opt, 0, {}, cfg)
    assert not (tmp_path / "x.ckpt").exists()


# ------------------------------------------------------------- pipeline
def test_li_that_ctx_does_not_divide_is_refused(tmp_path):
    cfg, _ = port_setup(tmp_path, max_num_img=6, img_buckets=[6])
    ds = SyntheticTVQADataset(cfg, 4, mode="valid")
    mesh = dp.Mesh(data=1, ctx=4, rank=1)
    with pytest.raises(ValueError, match="6 frames does not split over "
                                         "ctx = 4"):
        list(DataPipeline(ds, cfg, "cpu", batch_size=4, mesh=mesh))
    with pytest.raises(ValueError, match="ctx = 4"):
        dp.shard_batch(mesh, {"vid": torch.zeros(4, 6, 5, 3)})
    with pytest.raises(ValueError, match="video_dedup is single-process"):
        DataPipeline(ds, cfg, "cpu", batch_size=4, video_dedup=True,
                     mesh=dp.Mesh(data=1, ctx=2, rank=1))


@pytest.mark.parametrize("group", [1, 2])
def test_each_rank_holds_its_cut_of_jax_batch_shardings(tmp_path, group):
    """On a (2, 2) mesh each (d, c) rank's pipeline batches, single and
    stacked (K = 2), equal the single process's global batches cut by JAX's
    own ``batch_shardings`` on a (2, 2) JAX mesh, for the device at the
    rank's grid position (``devices_indices_map``), bit for bit."""
    cfg, _ = port_setup(tmp_path, img_buckets=[4, 8], max_num_img=8)
    ds = SyntheticTVQADataset(cfg, 24, mode="train")
    kw = dict(batch_size=8, train=True, seed=1, group=group)
    single = [b for b, _, _ in DataPipeline(ds, cfg, "cpu", **kw)]
    assert len({b["vid"].shape[-3] for b in single}) == 2
    jm = jmesh.make_mesh((2, 2), devices=jax.devices()[:4])
    for rank in range(4):
        mesh = dp.Mesh(data=2, ctx=2, rank=rank)
        device = jm.devices[mesh.d, mesh.c]
        got = [b for b, _, _ in DataPipeline(ds, cfg, "cpu", mesh=mesh,
                                             **kw)]
        assert len(got) == len(single)
        for g, s in zip(got, single):
            stacked = s["ex_mask"].dim() == 2
            specs = jmesh.batch_shardings(
                jm, {k: v.numpy() for k, v in s.items()}, stacked=stacked)
            assert set(g) == set(s)
            for k, v in s.items():
                sh = specs[k]
                assert isinstance(sh, NamedSharding)
                index = sh.devices_indices_map(tuple(v.shape))[device]
                assert torch.equal(g[k], v[index]), (rank, k)
                assert torch.equal(dp.shard_batch(mesh, s, stacked)[k],
                                   v[index])


# ------------------------------------------------------ ctx: training
def ctx_jobs(tmp_path, shape, **kw):
    cfg, sd = port_setup(tmp_path, max_num_img=8, img_buckets=[8], **kw)
    job = ranks.train_job(cfg, sd, dispatches(cfg, 32, 2), False,
                          mesh_shape=shape)
    return cfg, sd, job


def held_params(single, got, n_ranks, step="last"):
    """Parameters at 1e-5 where the step's gradient |g| > 1e-4 (the
    data-parallel tests' bar, tests/test_torch_parallel.py: Adam moves a
    parameter whose gradient is rounding noise by about lr, of random
    sign), after the ``step`` ("first" or "last") dispatch; returns the
    share of elements held."""
    params, grads = (("params", "grads") if step == "last"
                     else ("first_params", "first_grads"))
    held = total = 0
    for name, p in single[params].items():
        big = single[grads][name].abs().numpy() > 1e-4
        held += big.sum()
        total += p.numel()
        np.testing.assert_allclose(got[params][name].numpy()[big],
                                   p.numpy()[big], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    return held / total


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_ctx_ranks_take_the_single_process_steps(tmp_path, shape):
    """4 gloo ranks at (1, 4) and (2, 2) against the port's single process
    on the global batch of 8 over two K = 2 dispatches, dropout 0, the att
    loss's uniform negatives on, Li 8 (2 or 4 frames a rank): each data
    row's summed losses at 1e-5 relative (every ctx rank of a row holds
    the same), the grad norms at 1e-5 relative, every rank's parameters
    at the data-parallel tests' bar; the ctx ranks of a row equal bit for bit."""
    cfg, sd, job = ctx_jobs(tmp_path, shape, dropout=0.0)
    single = ranks.train(job, None)
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.train_rank, 4, path)
    assert single["metrics"][0]["att_n_pairs"] > 0
    rows = [o for o in out if o["coords"][1] == 0]
    assert len(rows) == shape[0]
    for d, want in enumerate(single["metrics"]):
        for k in ("loss", "loss_cls", "loss_ts", "loss_att", "n_eff"):
            np.testing.assert_allclose(
                sum(o["metrics"][d][k] for o in rows), want[k], rtol=1e-5,
                atol=1e-5, err_msg=f"dispatch {d} {k}")
        for o in out:
            np.testing.assert_allclose(o["metrics"][d]["grad_norm"],
                                       want["grad_norm"], rtol=1e-5)
    for o in out:
        assert o["step"] == 4
        assert held_params(single, o, 4) > 0.95
        peer = next(p for p in out if p["coords"][0] == o["coords"][0])
        for name, p in o["params"].items():
            assert torch.equal(p, peer["params"][name]), name


def jax_trainer_loss(jcfg, shape, steps=1):
    """The JAX Trainer's losses of ``steps`` steps on its first batch on a
    mesh of ``shape`` (tests/test_train.py:305-352: hard negatives here, so
    neither side samples), its batch as numpy and its initial weights in
    the port's names."""
    ndev = int(np.prod(shape))
    trainer = JaxTrainer(jcfg, mesh=jmesh.make_mesh(
        shape, devices=jax.devices()[:ndev]))
    sd = params_from_flax(jax.tree_util.tree_map(
        np.asarray, trainer.state.params), jcfg)
    ds = JaxSynthetic(jcfg, jcfg.bsz, mode="train")
    batch, _, _ = next(iter(trainer._pipeline(ds, shuffle=False,
                                              batch_size=jcfg.bsz)))
    state, losses = trainer.state, []
    for _ in range(steps):
        state, metrics = trainer._train_step(state, batch, trainer.rng,
                                             use_hard_negatives=True)
        losses.append(float(metrics["loss"]))
    host = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return losses, host, sd


@pytest.mark.parametrize("merged", [False, True])
def test_ctx_four_matches_the_jax_trainer(tmp_path, merged):
    """4 gloo ranks at (1, 4) against the JAX Trainer on a (1, 4) mesh
    (tests/test_train.py:305-320's config: max_num_img 8, img_buckets [8],
    --use_sup_att --add_local; dropout 0 and hard negatives, float32), on
    the sub_dedup and the merged input path: the loss at 1e-4 relative,
    JAX's own bar."""
    jcfg = small_cfg(tmp_path, bsz=4, max_num_img=8, img_buckets=[8],
                     use_sup_att=True, add_local=True, dropout=0.0,
                     compute_dtype="float32", use_pallas=False,
                     merge_input_streams=merged)
    (ref,), batch, sd = jax_trainer_loss(jcfg, (1, 4))
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    path = str(tmp_path / "job")
    torch.save(ranks.train_job(cfg, sd, [batch], True, mesh_shape=(1, 4)),
               path)
    out = ranks.run_ranks(ranks.train_rank, 4, path)
    for o in out:
        assert abs(o["metrics"][0]["loss"] - ref) / abs(ref) < 1e-4


def test_ctx_ranks_drop_alike_where_the_work_is_replicated(tmp_path):
    """Dropout 0.1 at (2, 2): the QA stream and the pooled statement
    before the classifier are equal bit for bit on the two ctx ranks of a
    data row (replicated work draws under the row's seeds) and differ
    between rows; every rank ends with the same parameters."""
    cfg, sd, job = ctx_jobs(tmp_path, (2, 2), dropout=0.1)
    job["probe"] = True
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.train_rank, 4, path)
    by = {o["coords"][:2]: o for o in out}
    for d in range(2):
        a, b = by[(d, 0)]["seen"], by[(d, 1)]["seen"]
        assert len(a["qa"]) == len(a["pooled"]) == 4
        for key in ("qa", "pooled"):
            for x, y in zip(a[key], b[key]):
                assert torch.equal(x, y), (d, key)
    assert not torch.equal(by[(0, 0)]["seen"]["qa"][0],
                           by[(1, 0)]["seen"]["qa"][0])
    for o in out:
        for name, p in o["params"].items():
            assert torch.equal(p, out[0]["params"][name]), name
    assert not torch.equal(out[0]["params"][name], sd[name])


# ------------------------------- ctx: the merged input encoder's masks
def merged_encoder_calls(tmp_path, blind, **kw):
    """Two gloo ranks at (1, 2), merged input path, dropout 0.1, one K = 2
    dispatch: each rank's merged input-encoder calls (``probe_merged``),
    with the group map or rank-blind; ``kw`` edits the config."""
    cfg, sd, job = ctx_jobs(tmp_path, (1, 2), dropout=0.1,
                            merge_input_streams=True, **kw)
    job.update(batches=job["batches"][:1], probe_merged=True,
               blind_map=blind)
    path = str(tmp_path / "job")
    torch.save(job, path)
    num_a = job["batches"][0]["qas_bert"].shape[2]
    return cfg, sd, num_a, ranks.run_ranks(ranks.train_rank, 2, path)


def whole_call(cfg, sd, num_a, calls):
    """The single process's merged encoder call on the ranks' first calls
    put together (the QA groups, then each stream's frames in rank order),
    with their seeds: its output, and each rank's (QA, sub, vid) group
    ranges in it."""
    parts = [c["seen"][0] for c in calls]
    li = (parts[0]["x"].shape[1] - num_a) // 2

    def cat(key):
        dim = 0 if key == "zero_mask" else 1
        t = [p[key] for p in parts]
        return torch.cat([t[0].narrow(dim, 0, num_a)]
                         + [u.narrow(dim, num_a, li) for u in t]
                         + [u.narrow(dim, num_a + li, li) for u in t], dim)
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd)
    gen = torch.Generator()
    gen.set_state(parts[0]["generator"])
    drop = Dropout(parts[0]["rate"], gen, parts[0]["seeds"])
    with torch.no_grad():
        out = model.input_encoder(cat("x"), drop=drop,
                                  zero_mask=cat("zero_mask"))
    whole = li * len(parts)
    spans = [(num_a + c * li, num_a + whole + c * li)
             for c in range(len(parts))]
    return out, li, spans


def test_ctx_ranks_key_the_merged_encoder_at_their_global_frames(tmp_path):
    """C5: at (1, 2) on the merged path with dropout 0.1, each ctx rank's
    frame rows of the merged input encoder's output equal bit for bit the
    single process's rows at the same global frames, fed the same rows
    and seeds (the kernel's group map keys each frame where one process
    keys it); the QA rows are equal on both ranks and to the single
    process's."""
    cfg, sd, num_a, out = merged_encoder_calls(tmp_path, blind=False)
    ref, li, spans = whole_call(cfg, sd, num_a, out)
    for o, (sub, vid) in zip(out, spans):
        got = o["seen"][0]["out"]
        assert o["seen"][0]["rate"] == 0.1
        assert torch.equal(got[:, :num_a], ref[:, :num_a])
        assert torch.equal(got[:, num_a:num_a + li], ref[:, sub:sub + li])
        assert torch.equal(got[:, num_a + li:], ref[:, vid:vid + li])
    assert torch.equal(out[0]["seen"][0]["out"][:, :num_a],
                       out[1]["seen"][0]["out"][:, :num_a])


def test_a_rank_blind_map_repeats_the_frame_masks(tmp_path):
    """The mutation the check above must catch: without the group map each
    ctx rank keys its groups by their local place, so the second rank's
    frame rows are not the single process's at its global frames (and the
    QA rows past the first batch row move too, the row stride being the
    local group count), though the ranks' QA rows still agree."""
    cfg, sd, num_a, out = merged_encoder_calls(tmp_path, blind=True)
    ref, li, (_, (sub, vid)) = whole_call(cfg, sd, num_a, out)
    got = out[1]["seen"][0]["out"]
    assert torch.equal(got[:, :num_a], out[0]["seen"][0]["out"][:, :num_a])
    assert not torch.equal(got[:, num_a:num_a + li], ref[:, sub:sub + li])
    assert not torch.equal(got[:, num_a + li:], ref[:, vid:vid + li])


def test_ctx_ranks_draw_the_plain_merged_chain_at_their_global_frames(
        tmp_path):
    """C7: as the check above with an input encoder the kernel does not
    take (n_conv 1: the plain chain, its dropout drawn from the data row's
    generator), float32: each rank's frame rows equal the single
    process's at its global frames bit for bit, fed the same rows and the
    generator's state at the call, and the QA rows are alike on both
    ranks and the single process's."""
    cfg, sd, num_a, out = merged_encoder_calls(
        tmp_path, blind=False, input_encoder_n_conv=1)
    assert cfg.input_encoder_n_conv == 1 and cfg.compute_dtype == "float32"
    ref, li, spans = whole_call(cfg, sd, num_a, out)
    for o, (sub, vid) in zip(out, spans):
        got = o["seen"][0]["out"]
        assert o["seen"][0]["rate"] == 0.1
        assert torch.equal(got[:, :num_a], ref[:, :num_a])
        assert torch.equal(got[:, num_a:num_a + li], ref[:, sub:sub + li])
        assert torch.equal(got[:, num_a + li:], ref[:, vid:vid + li])
    assert torch.equal(out[0]["seen"][0]["generator"],
                       out[1]["seen"][0]["generator"])


def test_a_rank_blind_plain_chain_repeats_the_frame_masks(tmp_path):
    """C7's mutation: the plain chain without the group map draws each
    rank's masks for its local groups, so the second rank's frame rows
    are not the single process's at its global frames."""
    cfg, sd, num_a, out = merged_encoder_calls(
        tmp_path, blind=True, input_encoder_n_conv=1)
    ref, li, (_, (sub, vid)) = whole_call(cfg, sd, num_a, out)
    got = out[1]["seen"][0]["out"]
    assert torch.equal(got[:, :num_a], out[0]["seen"][0]["out"][:, :num_a])
    assert not torch.equal(got[:, num_a:num_a + li], ref[:, sub:sub + li])
    assert not torch.equal(got[:, num_a + li:], ref[:, vid:vid + li])


@pytest.mark.parametrize("heads", [0, 2])
@pytest.mark.parametrize("n_conv", [1, 3])
def test_the_plain_chain_draws_a_rank_s_groups_as_the_whole(heads, n_conv):
    """``GroupDropout`` in the plain chain (conv and attention dropout):
    an encoder block the kernel does not take, called with dropout 0.1 on
    one rank's groups under its group map, equals bit for bit the call on
    the whole group axis at those groups from the same generator state,
    and leaves the generator where the whole call leaves it."""
    from tvqaplus_tpu_torch.models.layers import EncoderBlock
    rng = np.random.default_rng(n_conv + heads)
    bsz, num_a, whole, length, d = 2, 3, 8, 6, 16
    g = num_a + 2 * whole
    block = EncoderBlock(d, n_conv, 5, heads, 0.1)
    torch.manual_seed(n_conv)
    x = torch.from_numpy(rng.standard_normal((bsz, g, length, d),
                                             np.float32))
    zm = torch.from_numpy((rng.random((g, length)) > 0.2).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        ref = block(x, drop=Dropout(0.1, gen, []), zero_mask=zm)
    after = gen.get_state()
    li = whole // 2
    for c in range(2):
        rows = torch.cat([torch.arange(num_a),
                          num_a + c * li + torch.arange(li),
                          num_a + whole + c * li + torch.arange(li)])
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            got = block(x[:, rows], drop=Dropout(0.1, gen, []),
                        zero_mask=zm[rows],
                        groups=(rows.to(torch.int32), g))
        assert torch.equal(got, ref[:, rows]), c
        assert torch.equal(gen.get_state(), after)


@pytest.mark.parametrize("ctx", [2, 4])
def test_the_plain_encoder_keys_a_rank_s_frames_as_the_whole(ctx):
    """The plain full-output encoder with dropout 0.1 (float32) on one
    rank's groups under its group map equals, bit for bit, the call on the
    whole group axis at those groups."""
    from tvqaplus_tpu_torch.ops.encoder import encoder_block_plain
    rng = np.random.default_rng(ctx)
    bsz, num_a, whole, length, d, k = 2, 3, 8, 6, 16, 7
    g = num_a + 2 * whole
    x = torch.from_numpy(rng.standard_normal((bsz, g, length, d),
                                             np.float32))
    params = {key: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * 0.3)
        for key, shape in [("ln0_s", (d,)), ("ln0_b", (d,)),
                           ("dw0", (k, d)), ("dwb0", (d,)),
                           ("pw0", (d, d)), ("pwb0", (d,)),
                           ("ln1_s", (d,)), ("ln1_b", (d,)),
                           ("dw1", (k, d)), ("dwb1", (d,)),
                           ("pw1", (d, d)), ("pwb1", (d,)),
                           ("lnf_s", (d,)), ("lnf_b", (d,))]}
    pe = torch.zeros(length, d)
    ref = encoder_block_plain(x, pe, params, k, None, 0.1, 12345)
    li = whole // ctx
    for c in range(ctx):
        rows = torch.cat([torch.arange(num_a),
                          num_a + c * li + torch.arange(li),
                          num_a + whole + c * li + torch.arange(li)])
        groups = (rows.to(torch.int32), g)
        got = encoder_block_plain(x[:, rows], pe, params, k, None, 0.1,
                                  12345, groups=groups)
        assert torch.equal(got, ref[:, rows]), c
        if c:
            blind = encoder_block_plain(x[:, rows], pe, params, k, None,
                                        0.1, 12345)
            assert not torch.equal(blind, ref[:, rows])


# ---------------------------------------------------- model: training
def port_setup_tp(tmp_path, **kw):
    """JAX's tensor-parallel test config (tests/test_train.py:322-352):
    embedding_size 256, so the 256 x 300 BERT bridge shards."""
    jcfg = small_cfg(tmp_path, **dict(STEP_CFG, use_pallas=False, bsz=4,
                                      embedding_size=256, **kw))
    return port_config(jcfg, results_dir=str(tmp_path / "port")), jcfg


# the leaves the kernels take whole that JAX's rule shards at hsz 256
KERNEL_LEAVES = {"c2q_down_projection.2.weight", "concat_fc.2.weight"} | {
    f"{enc}.stacked_encoderBlocks.0.conv.{i}.pointwise_conv.weight"
    for enc in ("input_encoder", "cls_encoder") for i in (0, 1)}


@pytest.mark.parametrize("hsz", [128, 256])
def test_model_two_shards_the_leaves_jax_shards(tmp_path, hsz):
    """The port's sharded weights at model 2 and 8, named in the JAX tree
    through the weight bridge, are the leaves JAX's ``state_shardings``
    shards over "model" on the same parameters.  At hsz 128: both bridges
    at 2, none at 8, where 300 output columns do not split (a rule on
    torch's own last dim, 256 input columns, would shard the BERT bridge).
    At hsz 256 also the kernels' weights (the attention's and the tri
    bridge's projections, the encoders' pointwise convs), which the port
    places (``_split_layer``) to gather whole."""
    cfg, _ = port_setup_tp(tmp_path, vfeat_size=300, hsz=hsz)
    model = STAGE(ModelConfig.from_config(cfg))
    sd = model.state_dict()
    jparams = jax.tree_util.tree_map(np.asarray, flax_from_params(sd, cfg))
    for size, shape in ((2, (1, 1, 2)), (8, (1, 1, 8))):
        jm = jmesh.make_mesh(shape, devices=jax.devices()[:size])
        specs = jmesh.state_shardings(jm, jparams)
        want = {jax.tree_util.keystr(path) for path, s in
                jax.tree_util.tree_leaves_with_path(
                    specs, is_leaf=lambda x: isinstance(x, NamedSharding))
                if "model" in tuple(s.spec)}
        ours = dp.sharded_parameters(model, size)
        marked = {k: torch.full_like(v, 1.0 if k in ours else 0.0)
                  for k, v in sd.items()}
        got = {jax.tree_util.keystr(path) for path, v in
               jax.tree_util.tree_leaves_with_path(flax_from_params(
                   marked, cfg)) if np.all(np.asarray(v) == 1.0)}
        assert got == want, size
        if hsz == 128:
            assert set(ours) == ({"bert_word_encoding_fc.2.weight",
                                  "vid_fc.2.weight"} if size == 2 else set())
        elif size == 2:
            assert KERNEL_LEAVES <= set(ours)
            for name in ours:
                _, whole = dp._split_layer(model, name)
                assert whole == (name in KERNEL_LEAVES), name


def model_axis_ranks(tmp_path, shape, hsz, **flags):
    """The JAX Trainer's two losses on a mesh of ``shape`` at ``hsz``, the
    port's single process and its gloo ranks on the same mesh, two steps
    on one batch of 4 (dropout 0, hard negatives, float32, --use_sup_att);
    ``flags`` go into the ranks' job."""
    cfg, jcfg = port_setup_tp(tmp_path, hsz=hsz)
    ref, batch, sd = jax_trainer_loss(jcfg, shape, steps=2)
    job = ranks.train_job(cfg, sd, [batch, batch], True, mesh_shape=shape)
    single = ranks.train(job, None)
    path = str(tmp_path / "job")
    torch.save(dict(job, **flags), path)
    out = ranks.run_ranks(ranks.train_rank, int(np.prod(shape)), path)
    return cfg, ref, single, out


@pytest.mark.parametrize("shape,hsz", [((2, 1, 2), 128), ((1, 1, 2), 256),
                                       ((2, 1, 2), 256)])
def test_model_two_matches_one_process_and_the_jax_trainer(tmp_path, shape,
                                                           hsz):
    """The model axis on gloo ranks against the JAX Trainer on a mesh of
    the same shape, two steps on one batch of 4 (dropout 0, hard negatives,
    float32, --use_sup_att): step 1's loss at 1e-4 and step 2's at 5e-3
    relative, JAX's bars (tests/test_train.py:322-352); against the port's
    single process, every rank's losses at 1e-5 relative, its grad norms at
    1e-5 (step 2 at hsz 256: 1e-4) and its whole parameters at the
    data-parallel tests' bar (at hsz 256 after step 1).  At hsz 128 the BERT
    bridge's weight is split over the model ranks; at hsz 256 also the kernels'
    weights, gathered whole in each forward, and the input embedding and the
    linear wrappers by columns: their sums in another order part the gradients
    by float32 rounding (step 1's agree to 1.1e-6 of each leaf's largest), and
    Adam's first update moves each parameter whose gradient is such noise by
    about lr (1e-3) either way, which moves step 2's gradients: its grad norm
    by 1.1e-5 at (1, 1, 2), two elements of a pointwise conv by 2e-4 after it,
    with both steps' gradients over 1e-4 (JAX holds its own step 2 at 5e-3)."""
    cfg, ref, single, out = model_axis_ranks(tmp_path, shape, hsz)
    rows = [o for o in out if o["coords"][2] == 0]
    for step, (bar, want) in enumerate(zip((1e-4, 5e-3), ref)):
        got = sum(o["metrics"][step]["loss"] for o in rows)
        assert abs(got - want) / abs(want) < bar, step
        np.testing.assert_allclose(got, single["metrics"][step]["loss"],
                                   rtol=1e-5)
    sharded = sorted(dp.sharded_parameters(
        STAGE(ModelConfig.from_config(cfg)), 2))
    assert KERNEL_LEAVES <= set(sharded) if hsz == 256 \
        else sharded == ["bert_word_encoding_fc.2.weight"]
    for o in out:
        assert o["sharded"] == sharded
        for step, bar in enumerate((1e-5, 1e-5 if hsz == 128 else 1e-4)):
            np.testing.assert_allclose(o["metrics"][step]["grad_norm"],
                                       single["metrics"][step]["grad_norm"],
                                       rtol=bar)
        assert held_params(single, o, len(out),
                           "last" if hsz == 128 else "first") > 0.95
        for name in o["params"]:
            assert torch.equal(o["params"][name], out[0]["params"][name])


def test_a_summing_weight_gather_fails_the_model_axis_bar(tmp_path):
    """The mutation the check above must catch: a gather of the kernels'
    whole weights whose backward sums the whole gradients over the model
    group (instead of taking this rank's block) hands each block twice its
    gradient at (1, 1, 2): step 1's grad norm leaves the single process's
    far past its bar (Adam's update is nearly blind to the scale, so the
    losses barely move), and so do those weights' gradients."""
    cfg, _, single, out = model_axis_ranks(tmp_path, (1, 1, 2), 256,
                                           summing_gather=True)
    got = out[0]["metrics"][0]["grad_norm"]
    want = single["metrics"][0]["grad_norm"]
    assert abs(got - want) / abs(want) > 1e-2
    # step 1's gradients (after the clip at 10, which scales each side by
    # 10 / its own norm): twice the single process's, times the norms' ratio
    twice = 2.0 * want / got
    for name in KERNEL_LEAVES:
        ratio = float(out[0]["first_grads"][name].norm()
                      / single["first_grads"][name].norm())
        assert abs(ratio - twice) < 1e-2 * twice, (name, ratio, twice)


def test_model_two_checkpoints_round_trip_with_one_process(tmp_path):
    """A checkpoint saved at (1, 1, 2) holds whole leaves: it loads in one
    process, and its keys, shapes and values (parameters and Adam's
    moments, at 1e-5) are the single process's; a single process's
    checkpoint resumes at (1, 1, 2) and the next step's parameters are the
    single process's resumed step at the data-parallel tests' bar."""
    cfg, _ = port_setup_tp(tmp_path)
    cfg.bsz = 4
    sd = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).state_dict()
    batches = dispatches(cfg, 8, 1)
    one, two = str(tmp_path / "one.ckpt"), str(tmp_path / "two.ckpt")
    job = ranks.train_job(cfg, sd, batches[:1], True, save=one)
    ranks.train(job, None)
    path = str(tmp_path / "job")
    torch.save(dict(job, mesh_shape=(1, 1, 2), save=two), path)
    ranks.run_ranks(ranks.train_rank, 2, path)
    a, b = (torch.load(p, weights_only=False) for p in (one, two))
    assert a["step"] == b["step"] == 1
    assert list(a["model"]) == list(b["model"])
    for k, v in a["model"].items():
        assert v.shape == b["model"][k].shape, k
        np.testing.assert_allclose(b["model"][k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert sa[i][k].shape == sb[i][k].shape
            np.testing.assert_allclose(sb[i][k], sa[i][k], rtol=1e-5,
                                       atol=1e-5)
    loaded = Trainer(dataclasses.replace(cfg, resume=two), "cpu")
    assert loaded.step == 1
    resumed = ranks.train_job(cfg, sd, batches[1:], True, resume=one)
    single = ranks.train(resumed, None)
    torch.save(dict(resumed, mesh_shape=(1, 1, 2)), path)
    out = ranks.run_ranks(ranks.train_rank, 2, path)
    for o in out:
        assert o["step"] == 2 and o["sharded"]
        assert held_params(single, o, 2) > 0.95

"""Data parallelism in the port (``tvqaplus_tpu_torch/parallel/mesh.py``
and the trainer, pipeline and losses it threads through) on the CPU: gloo
ranks in processes of their own (tests/torch_parallel_ranks.py).

N ranks x b rows must give the step of one process on the global batch of
N b rows, which is what the JAX package's SPMD step computes: against the
JAX step itself (4 x 2 against the global 8, with ranks whose cls-rescale
counts differ), against the port's own single process over K-step
dispatches with the att loss's sampling on, and, at world size 1, a run
with a process group equals the run without one bit for bit.  Tiny
configs from numpy-seeded synthetic data; each tolerance is stated at its
use."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_torch_train import STEP_CFG, port_config
from tests.test_train import small_cfg
from tvqaplus_tpu.data.pipeline import DataPipeline as JaxPipeline
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.models import losses as jlosses
from tvqaplus_tpu.models.stage import STAGE as JaxSTAGE
from tvqaplus_tpu.models.stage import ModelConfig as JaxModelConfig
from tvqaplus_tpu.train.state import make_optimizer as jax_optimizer
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.interop.weights import (
    flax_from_params,
    params_from_flax,
)
from tvqaplus_tpu_torch.models import spans
from tvqaplus_tpu_torch.models.layers import Dropout
from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
from tvqaplus_tpu_torch.ops import philox
from tvqaplus_tpu_torch.ops.masking import safe_softmax
from tvqaplus_tpu_torch.parallel import mesh as dp

torch.set_num_threads(1)
METRICS = ("loss", "loss_cls", "loss_ts", "loss_att", "n_correct", "n_eff",
           "att_n_pairs", "att_n_pos_dropped")


# ------------------------------------------------------------- the mesh
@pytest.mark.parametrize("shape, world, data", [
    ((-1, 1), 4, 4), ((4, 1), 4, 4), ((-1, 1, 1), 4, 4), ((4, -1), 4, 4),
    ((-1, 1), 1, 1), ((1, 1), 1, 1)])
def test_make_mesh_absorbs_the_world(monkeypatch, shape, world, data):
    """The port's cases of tests/test_parallel.py:16-24 on the data axis:
    -1 takes the world size."""
    monkeypatch.setattr(dp, "_world", lambda: (world, world - 1, "group"))
    mesh = dp.make_mesh(shape)
    assert dp.data_parallel_size(mesh) == data == mesh.data
    assert mesh.shape == ({"data": data, "ctx": 1} if len(shape) == 2
                          else {"data": data, "ctx": 1, "model": 1})
    assert mesh.rank == world - 1 and mesh.is_main == (world == 1)
    assert dp.make_multihost_mesh().data == world


@pytest.mark.parametrize("shape, world, match", [
    ((2, 1), 4, r"data x ctx x model = 2, but 4 process"),
    ((8, 1), 4, r"= 8, but 4 process"),
    ((4, 1), 1, r"torchrun --nproc_per_node 4"),
    ((2, 2), 8, r"= 4, but 8 process"),
    ((1, 4, 2), 4, r"torchrun --nproc_per_node 8"),
    ((-1, -1), 4, r"one -1"),
    ((-1, 3), 4, r"does not divide"),
    ((-1,), 1, r"2 or 3 entries")])
def test_make_mesh_refuses_what_is_not_ported(monkeypatch, shape, world,
                                              match):
    """A mesh whose sizes do not multiply to the world size raises, naming
    the launch it needs; so do a second -1 and a shape of 1 or 4 entries.
    (Every shape JAX's ``make_mesh`` takes over the whole world is ported:
    ``test_make_mesh_takes_the_ctx_and_model_axes``.)"""
    monkeypatch.setattr(dp, "_world", lambda: (world, 0, "group"))
    with pytest.raises(ValueError, match=match):
        dp.make_mesh(shape)


@pytest.mark.parametrize("shape, world, sizes", [
    ((-1, 2), 4, (2, 2, None)), ((2, 2), 4, (2, 2, None)),
    ((-1, 1, 2), 4, (2, 1, 2))])
def test_make_mesh_takes_the_ctx_and_model_axes(monkeypatch, shape, world,
                                                sizes):
    """The shapes that raised before the ctx and model axes were ported:
    their sizes, and the last rank's place (d, c, m) in the row-major
    grid."""
    monkeypatch.setattr(dp, "_world", lambda: (world, world - 1, "group"))
    monkeypatch.setattr(dp.dist, "new_group", lambda ranks: tuple(ranks))
    mesh = dp.make_mesh(shape)
    assert (mesh.data, mesh.ctx, mesh.model) == sizes
    assert mesh.coords == (sizes[0] - 1, sizes[1] - 1,
                           (sizes[2] or 1) - 1)


def test_multihost_mesh_takes_ctx(monkeypatch):
    """ctx 2 over a node of 4 processes: two data rows of two ctx ranks."""
    monkeypatch.setattr(dp, "_world", lambda: (4, 0, "group"))
    monkeypatch.setattr(dp.dist, "new_group", lambda ranks: tuple(ranks))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    mesh = dp.make_multihost_mesh(ctx=2)
    assert mesh.shape == {"data": 2, "ctx": 2}
    assert (mesh.data_group, mesh.ctx_group) == ((0, 2), (0, 1))


def test_without_a_group_the_mesh_is_one_rank_and_talks_to_no_one():
    mesh = dp.make_mesh()
    assert (mesh.data, mesh.rank, mesh.group) == (1, 0, None)
    t = torch.arange(3.0)
    assert dp.all_reduce_sum(mesh, t) is t and t.tolist() == [0, 1, 2]
    assert dp.gather_objects(mesh, "x") == ["x"]
    assert dp.broadcast_object(None, {"a": 1}) == {"a": 1}


@pytest.mark.parametrize("stacked", [False, True])
def test_shard_batch_gives_a_rank_its_rows(stacked):
    """Rows [r b, (r + 1) b) of dim 0, dim 1 under a leading K axis
    (JAX mesh.py:186-197)."""
    full = {"x": torch.arange(2 * 8 * 3).reshape(2, 8, 3)}
    if not stacked:
        full = {"x": full["x"][0]}
    for r in range(4):
        got = dp.shard_batch(dp.Mesh(data=4, rank=r), full, stacked)["x"]
        want = full["x"][:, 2 * r:2 * r + 2] if stacked \
            else full["x"][2 * r:2 * r + 2]
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split"):
        dp.rank_rows(dp.Mesh(data=3), 8)


def test_video_dedup_refuses_more_than_one_rank(tmp_path):
    """JAX pipeline.py:83-88: each rank's table of unique clips would
    differ."""
    cfg = port_config(small_cfg(tmp_path))
    ds = SyntheticTVQADataset(cfg, 4, mode="valid")
    with pytest.raises(ValueError, match="video_dedup is single-process"):
        DataPipeline(ds, cfg, "cpu", batch_size=4, video_dedup=True,
                     mesh=dp.Mesh(data=2, rank=1))
    DataPipeline(ds, cfg, "cpu", batch_size=4, video_dedup=True,
                 mesh=dp.Mesh(data=1))


def test_the_rank_folds_into_the_dropout_seeds_and_not_the_noise():
    """Rank 0 keeps a single process's Philox keys and generator seed;
    rank r's keys start RANK_STRIDE r further on and its generator takes
    another seed; the Gumbel-noise seed is one for every rank and none of
    the ranks' dropout seeds."""
    base = philox.draw_seed(torch.Generator().manual_seed(7))
    for r in range(3):
        seeds = philox.StepSeeds(7, "cpu", rank=r).next()
        assert torch.equal(seeds, base + r * philox.RANK_STRIDE
                           + torch.arange(philox.SITES))
    assert philox.rank_seed(7, 0) == 7
    dropout = {philox.rank_seed(7, r) for r in range(64)}
    assert len(dropout) == 64 and philox.noise_seed(7) not in dropout


# ------------------------------------------------------------- helpers
def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def set_rescale_counts(cfg, sd, batch, pattern):
    """Edit the span labels and ``ex_mask`` of a global batch so that row
    i's second training proposal (stage.py GT-anchored proposals) is kept
    (pattern "k": the label is the predicted span, IoU 1), dropped ("d":
    a one-frame label apart from it) or the row is padding ("m").  The
    predicted spans come from the port's forward with these weights."""
    model = STAGE(ModelConfig.from_config(cfg))
    model.load_state_dict(sd)
    tb = torch_batch(batch)
    with torch.no_grad():
        out = model(tb, train=True, need_sub_raw=False, need_vid_raw=False,
                    drop=Dropout(0.0, None, None))
    t_ca = out["t_scores"][torch.arange(len(pattern)), tb["target"].long()]
    probs = safe_softmax(t_ca.float(), dim=1)
    st, ed, conf = spans.top_spans(probs[..., 0], probs[..., 1])
    assert float(conf.min()) > 0.011          # above ce_prob_thd 0.01
    batch = {k: np.array(v) for k, v in batch.items()}
    for i, p in enumerate(pattern):
        s, e = int(st[i, 0]), int(ed[i, 0])
        n = int(batch["ts_mask"][i].sum())
        if p == "k":
            batch["ts_st"][i], batch["ts_ed"][i] = s, e
        elif p == "d":
            frame = 0 if s > 0 else (n - 1 if e < n - 1 else 0)
            batch["ts_st"][i] = batch["ts_ed"][i] = frame
            assert n >= 2
        else:
            batch["ex_mask"][i] = 0.0
    return batch


def jax_step(jcfg, batch, params):
    """The JAX Trainer's step body on one batch (loop.py:149-172), hard
    negatives, dropout 0: (metrics, grads, updated params) in the port's
    parameter names, and the global gradient norm."""
    jmodel = JaxSTAGE(JaxModelConfig.from_config(jcfg))
    tx = jax_optimizer(jcfg.lr, jcfg.wd, jcfg.clip)
    loss_kwargs = dict(
        att_weight=jcfg.att_weight, ts_weight=jcfg.ts_weight,
        use_sup_att=jcfg.use_sup_att, num_negatives=jcfg.num_negatives,
        att_loss_type=jcfg.att_loss_type, margin=jcfg.margin,
        alpha=jcfg.alpha, drop_topk=jcfg.drop_topk,
        negative_pool_size=jcfg.negative_pool_size, num_hard=jcfg.num_hard,
        entry_cap=jcfg.att_entry_cap, vfeat_flag=jcfg.vfeat_flag)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True,
                           need_sub_raw=False, need_vid_raw="target",
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jlosses.total_loss(out, batch, jax.random.PRNGKey(0),
                                  train=True, use_hard_negatives=True,
                                  **loss_kwargs)

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return ({k: float(v) for k, v in ref.items()},
            params_from_flax(to_np(grads), jcfg),
            params_from_flax(to_np(new), jcfg), float(optax.global_norm(grads)))


# ---------------------------------------------------- against the JAX step
def test_four_ranks_of_two_rows_take_the_jax_step_on_the_global_eight(
        tmp_path):
    """4 gloo ranks x 2 rows against the JAX step on the global batch of 8
    (float32, dropout 0, hard negatives, --add_local --use_sup_att; the
    JAX model through its plain reference, use_pallas False).  The batch
    is edited so the ranks' cls-rescale counts (real rows, kept proposals)
    are 2/4, 2/2, 2/3 and 1/2: a per-rank rescale, or a mean of the
    gradients in place of their sum, fails.  The ranks' metric sums
    against JAX's at 1e-4 relative; each rank's gradient (after the sum
    and the clip) at rtol 1e-3 / atol 1e-5 and its updated parameters at
    2e-6 where |g| > 1e-3, as tests/test_torch_train.py holds one process;
    the ranks' gradients and parameters are equal bit for bit."""
    jcfg = small_cfg(tmp_path, **dict(STEP_CFG, use_pallas=False, bsz=8))
    batch = next(iter(JaxPipeline(JaxSynthetic(jcfg, 8, mode="train"), jcfg,
                                  batch_size=8)))[0]
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    sd0 = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(sd0, cfg))
    batch = set_rescale_counts(cfg, sd0, batch, "kkdd" + "kd" + "km")
    ref, g_ref, p_ref, norm_ref = jax_step(jcfg, batch, params)
    assert ref["n_eff"] == 11.0 and ref["att_n_pairs"] > 0

    path = str(tmp_path / "job")
    torch.save(ranks.train_job(cfg, sd0, [torch_batch(batch)], True), path)
    out = ranks.run_ranks(ranks.train_rank, 4, path)
    for k in METRICS:
        got = sum(o["metrics"][0][k] for o in out)
        np.testing.assert_allclose(got, ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    scale = min(1.0, jcfg.clip / norm_ref)
    for o in out:
        np.testing.assert_allclose(o["metrics"][0]["grad_norm"], norm_ref,
                                   rtol=1e-4)
        assert set(o["grads"]) == set(g_ref)
        for name, g in g_ref.items():
            g = g.numpy()
            np.testing.assert_allclose(o["grads"][name].numpy(), g * scale,
                                       rtol=1e-3, atol=1e-5, err_msg=name)
            big = np.abs(g) > 1e-3
            np.testing.assert_allclose(o["params"][name].numpy()[big],
                                       p_ref[name].numpy()[big], rtol=0,
                                       atol=2e-6, err_msg=name)
            assert torch.equal(o["grads"][name], out[0]["grads"][name])
            assert torch.equal(o["params"][name], out[0]["params"][name])


# ------------------------------------------- against the port's own process
def port_setup(tmp_path, **kw):
    """A tiny port config (global batch 8) and seeded weights."""
    jcfg = small_cfg(tmp_path, **dict(STEP_CFG, use_pallas=False, bsz=8,
                                      **kw))
    cfg = port_config(jcfg, results_dir=str(tmp_path / "port"))
    sd = STAGE(ModelConfig.from_config(cfg)).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).state_dict()
    return cfg, sd


def dispatches(cfg, n, group):
    """The port pipeline's training dispatches over n examples (global
    batch ``cfg.bsz``, ``group`` stacked)."""
    ds = SyntheticTVQADataset(cfg, n, mode="train")
    return [b for b, _, _ in DataPipeline(ds, cfg, "cpu",
                                          batch_size=cfg.bsz, train=True,
                                          seed=cfg.seed, group=group)]


def test_four_ranks_take_the_single_process_steps_with_sampled_negatives(
        tmp_path):
    """4 ranks x 2 rows against the port's single process x 8 over two
    K = 2 dispatches, with the att loss's uniform negatives on (each rank
    takes its rows of one global Gumbel draw): the ranks' summed losses of
    each dispatch at 1e-5 relative, and every rank's parameters at 1e-5
    (float32 sums in another order over four optimizer steps) where the
    last step's gradient |g| > 1e-4.  Adam moves a parameter by about lr
    whatever its gradient's size, so one whose gradient is rounding noise
    (a bias before a softmax, which the softmax does not see) takes a
    step of random sign on either side, as in tests/test_torch_train.py."""
    cfg, sd = port_setup(tmp_path, dropout=0.0)
    batches = dispatches(cfg, 32, 2)
    assert [b["ex_mask"].shape for b in batches] == [(2, 8)] * 2
    job = ranks.train_job(cfg, sd, batches, use_hard_negatives=False)
    single = ranks.train(job, None)
    path = str(tmp_path / "job")
    torch.save(job, path)
    out = ranks.run_ranks(ranks.train_rank, 4, path)
    assert single["metrics"][0]["att_n_pairs"] > 0
    for d, want in enumerate(single["metrics"]):
        for k in ("loss", "loss_cls", "loss_ts", "loss_att", "n_eff"):
            np.testing.assert_allclose(
                sum(o["metrics"][d][k] for o in out), want[k], rtol=1e-5,
                atol=1e-5, err_msg=f"dispatch {d} {k}")
    held = 0
    for o in out:
        assert o["step"] == 4
        for name, p in single["params"].items():
            big = single["grads"][name].abs().numpy() > 1e-4
            held += big.sum()
            np.testing.assert_allclose(o["params"][name].numpy()[big],
                                       p.numpy()[big], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    # 21,236 of the 21,539 elements at this seed
    assert held / 4 > 0.95 * sum(p.numel() for p in single["params"].values())


def test_ranks_drop_other_units_and_stay_in_step(tmp_path):
    """Dropout 0.1, two ranks fed the same rows for two steps: the ranks'
    losses differ (each rank draws its own masks, plain and Philox), their
    gradients and parameters are equal bit for bit (one sum, one Adam
    step on every rank)."""
    cfg, sd = port_setup(tmp_path, dropout=0.1)
    batches = dispatches(cfg, 16, 1)
    local = [dp.shard_batch(dp.Mesh(data=2), b) for b in batches]
    path = str(tmp_path / "job")
    torch.save(ranks.train_job(cfg, sd, local, False, rows="same"), path)
    a, b = ranks.run_ranks(ranks.train_rank, 2, path)
    for d in range(2):
        assert a["metrics"][d]["loss"] != b["metrics"][d]["loss"]
        assert a["metrics"][d]["grad_norm"] == b["metrics"][d]["grad_norm"]
    for name in a["params"]:
        assert torch.equal(a["grads"][name], b["grads"][name]), name
        assert torch.equal(a["params"][name], b["params"][name]), name
    assert not torch.equal(a["params"][name], sd[name])


def test_a_world_of_one_equals_no_group_bit_for_bit(tmp_path):
    """At world size 1 a run with a gloo group (collectives and all) gives
    the run without one, bit for bit: dropout 0.1, sampled negatives, two
    K = 2 dispatches."""
    cfg, sd = port_setup(tmp_path, dropout=0.1)
    job = ranks.train_job(cfg, sd, dispatches(cfg, 32, 2), False)
    single = ranks.train(job, None)
    path = str(tmp_path / "job")
    torch.save(job, path)
    (grouped,) = ranks.run_ranks(ranks.train_rank, 1, path)
    assert grouped["metrics"] == single["metrics"]
    for name, p in single["params"].items():
        assert torch.equal(grouped["params"][name], p), name
        assert torch.equal(grouped["grads"][name], single["grads"][name])


# ------------------------------------------------------------- pipeline
def local_batches(cfg, ds, mesh, **kw):
    return [(b, m, k) for b, m, k in DataPipeline(
        ds, cfg, "cpu", seed=1, mesh=mesh, **kw)]


@pytest.mark.parametrize("mode, n, batch_size", [("train", 28, 8),
                                                 ("valid", 13, 4)])
def test_each_rank_collates_its_rows_of_the_global_batches(tmp_path, mode,
                                                           n, batch_size):
    """Two ranks' pipelines against the single process's: every shape
    decision (shuffle order, Li bucket, St bucket, K = 2 grouping) is the
    global batch's, so each rank's batches are its rows of the single
    process's batches bit for bit, and its meta their rows' entries.
    Training: two Li buckets and St buckets; validation: a partial last
    batch that leaves rank 1 no row.  (The pipeline reads the mesh's rank
    and size only: no process group is needed.)"""
    cfg, _ = port_setup(tmp_path, img_buckets=[4, 6], max_sub_tokens=64,
                        sub_token_buckets=[24, 40])
    ds = SyntheticTVQADataset(cfg, n, mode=mode)
    kw = dict(batch_size=batch_size, train=mode == "train", group=2)
    single = local_batches(cfg, ds, None, **kw)
    shapes = {tuple(b["sub_tokens"].shape[-2:]) for b, _, _ in single}
    assert len(single) >= 2 and (mode == "valid" or len(shapes) > 1)
    empty = False
    for r in range(2):
        mesh = dp.Mesh(data=2, rank=r)
        got = local_batches(cfg, ds, mesh, **kw)
        assert len(got) == len(single)
        for (gb, gm, gk), (sb, sm, sk) in zip(got, single):
            stacked = sb["ex_mask"].dim() == 2
            want = dp.shard_batch(mesh, sb, stacked)
            assert gk == sk and set(gb) == set(want)
            for k in want:
                assert torch.equal(gb[k], want[k]), (mode, k)
            b = batch_size // 2
            rows = [i for s in range(sb["ex_mask"].shape[0]
                                     if stacked else 1)
                    for i in range(s * 2 * b + r * b,
                                   s * 2 * b + (r + 1) * b)
                    if i < len(sm["qid"])]
            assert gm["qid"] == [sm["qid"][i] for i in rows]
            empty |= bool((gb["ex_mask"].reshape(-1, b).sum(-1) == 0).any())
    assert empty == (mode == "valid")


class NounMasksOnFirst:
    """A split whose first example alone carries noun masks."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        ex = dict(self.ds[i])
        if i == 0:
            ex["qa_noun_masks"] = [[1.0] * 3] * 5
        return ex


def test_a_rank_without_noun_masks_still_ships_the_key(tmp_path):
    """The batch's keys are the global batch's: rank 1's rows carry no
    noun masks, but rank 0's do, so rank 1 ships zero masks too (both ranks
    take the same attention route and graph)."""
    cfg, _ = port_setup(tmp_path)
    ds = NounMasksOnFirst(SyntheticTVQADataset(cfg, 4, mode="valid"))
    for r in range(2):
        (batch, _, _), = local_batches(cfg, ds, dp.Mesh(data=2, rank=r),
                                       batch_size=4)
        masks = batch["qa_noun_masks"]
        assert masks.shape == (2, 5, cfg.max_qa_l)
        assert float(masks.sum()) == (15.0 if r == 0 else 0.0)

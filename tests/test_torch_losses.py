"""The port's losses, training spans and training collate against the JAX
package on the same numpy inputs (1e-5): cls/ts losses in train and eval
shapes, the att loss on the collate-time entries (uniform negatives with
JAX's Gumbel noise fed in, direct hard negatives, the pool window; hinge
and lse), top_spans / temporal_iou / training_proposals, and the
training batch keys of collate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data import batching as jbatch
from tvqaplus_tpu.data.synthetic import SyntheticTVQADataset as JaxSynthetic
from tvqaplus_tpu.models import losses as jlosses
from tvqaplus_tpu.models import spans as jspans
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data import batching as tbatch
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
from tvqaplus_tpu_torch.models import losses, spans

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(bsz=4, test_bsz=4, hsz=16, embedding_size=24, vfeat_size=12,
            max_qa_l=10, max_sub_l=8, max_num_img=6, num_region=5,
            img_buckets=[6], max_q_l=4, max_a_l=4, synthetic_data=True,
            att_entry_cap=16)


def t(x):
    return torch.from_numpy(np.array(x))


def configs():
    jcfg = JaxConfig(**TINY)
    jcfg.finalize(save=False)
    return jcfg, Config(**TINY).finalize("cpu")


def train_batches(n=4):
    """The same synthetic train examples collated by both packages."""
    jcfg, cfg = configs()
    jex = [JaxSynthetic(jcfg, n, mode="train")[i] for i in range(n)]
    ex = [SyntheticTVQADataset(cfg, n, mode="train")[i] for i in range(n)]
    ref, _ = jbatch.collate_static(jex, jbatch.StaticShapeSpec.from_config(
        jcfg, batch=4))
    got, meta = tbatch.collate_static(ex, tbatch.StaticShapeSpec.from_config(
        cfg, batch=4, train=True))
    return ref, got, meta


def test_training_collate_matches_jax():
    ref, got, meta = train_batches()
    for k in tbatch.ATT_KEYS + ("target", "ts_st", "ts_ed", "ts_mask",
                                "ex_mask"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["att_entry_valid"].sum() > 0
    assert meta["att_n_pos"] == [int(v) for v in ref["att_n_pos"]]


# -------------------------------------------------------------- cls and ts
def test_cls_and_ts_losses_match_jax():
    rng = np.random.default_rng(0)
    b, p, a, li = 4, 2, 5, 6
    scores3 = rng.standard_normal((b, p, a)).astype(np.float32)
    scores2 = rng.standard_normal((b, a)).astype(np.float32)
    weights = np.array([[1, 1], [1, 0], [1, 1], [1, 0]], np.float32)
    targets = np.array([0, 3, 4, 1], np.int32)
    ex_mask = np.array([1, 1, 1, 0], np.float32)
    tsc = rng.standard_normal((b, a, li, 2)).astype(np.float32)
    tsc[1, :, 4:] = -1e10
    st, ed = np.array([0, 2, 5, 1], np.int32), np.array([3, 3, 5, 2], np.int32)
    for s, w in ((scores3, weights), (scores2, weights[:, :1])):
        ref = jlosses.cls_loss(jnp.asarray(s), jnp.asarray(w),
                               jnp.asarray(targets), jnp.asarray(ex_mask))
        got = losses.cls_loss(t(s), t(w), t(targets), t(ex_mask))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), **TOL)
    ref = jlosses.ts_loss(jnp.asarray(tsc), jnp.asarray(st), jnp.asarray(ed),
                          jnp.asarray(targets), jnp.asarray(ex_mask))
    got = losses.ts_loss(t(tsc), t(st), t(ed), t(targets), t(ex_mask))
    np.testing.assert_allclose(float(got), float(ref), **TOL)


# ---------------------------------------------------------------- att loss
@pytest.mark.parametrize("loss_type", ["lse", "hinge"])
@pytest.mark.parametrize("variant", ["uniform", "hard", "pool"])
def test_att_loss_on_collate_entries_matches_jax(loss_type, variant):
    ref_batch, batch, _ = train_batches()
    rng = np.random.default_rng(1)
    b, li, lqa, lr = 4, 6, 10, 5
    scores = rng.uniform(-1, 1, (b, li, lqa, lr)).astype(np.float32)
    scores[3] = -1e10                    # the padded example
    scores[:, :, 8:] = -1e10             # words past the QA length
    kw = dict(num_negatives=2, loss_type=loss_type, margin=0.1, alpha=20.0,
              use_hard_negatives=variant != "uniform", drop_topk=0,
              negative_pool_size=3 if variant == "pool" else 0, num_hard=1,
              entry_cap=16)
    key = jax.random.PRNGKey(3)
    ex_mask = np.array([1, 1, 1, 0], np.float32)
    entries = {k: jnp.asarray(ref_batch[k]) for k in jbatch.ATT_KEYS
               if k in ref_batch}

    def jloss(sc):
        return jlosses.att_loss(sc, None, None, jnp.asarray(
            ref_batch["target"]), jnp.asarray(ex_mask), key,
            entries=entries, **kw)

    (ref, aux), gref = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(scores))
    noise = jax.random.gumbel(key, (b, 16, 2, lr))
    st = t(scores).requires_grad_()
    got, gaux = losses.att_loss(
        st, {k: t(v) for k, v in batch.items()}, t(batch["target"]),
        t(ex_mask), t(np.asarray(noise)), **kw)
    got.backward()
    assert float(aux["att_n_pairs"]) > 0
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    for k in aux:
        np.testing.assert_allclose(float(gaux[k]), float(aux[k]), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gref), **TOL)


# ------------------------------------------------------------------- spans
def span_logits(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 7, 2)).astype(np.float32)
    x[0] = 0.0                           # ties everywhere
    x[1, 5:] = -1e10                     # masked frames
    return x


@pytest.mark.parametrize("top_n", [1, 3])
def test_top_spans_and_iou_match_jax(top_n):
    x = span_logits(0)
    p = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=1))
    ref = jspans.top_spans(jnp.asarray(p[..., 0]), jnp.asarray(p[..., 1]),
                           top_n)
    got = spans.top_spans(t(p[..., 0]), t(p[..., 1]), top_n)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    a = np.array([[0., 2.], [3., 5.], [1., 1.]], np.float32)
    bb = np.array([[1., 3.], [0., 4.], [1., 1.]], np.float32)
    ref = jspans.temporal_iou(*(jnp.asarray(v) for v in (a[:, 0], a[:, 1],
                                                         bb[:, 0], bb[:, 1])))
    got = spans.temporal_iou(*(t(v) for v in (a[:, 0], a[:, 1], bb[:, 0],
                                             bb[:, 1])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("max_num_proposal", [1, 2])
def test_training_proposals_match_jax(max_num_proposal):
    x = span_logits(1)
    st = np.array([0, 1, 2, 6, 3], np.int32)
    ed = np.array([2, 1, 4, 6, 3], np.int32)
    # a confident span on the GT for example 2: its proposal is kept
    x[2, :, :] = -5.0
    x[2, 2, 0] = x[2, 4, 1] = 5.0
    ref = jspans.training_proposals(jnp.asarray(x), jnp.asarray(st),
                                    jnp.asarray(ed), None,
                                    max_num_proposal=max_num_proposal)
    got = spans.training_proposals(t(x), t(st), t(ed),
                                   max_num_proposal=max_num_proposal)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert float(got[2][2, 1]) == 1.0

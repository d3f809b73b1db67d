"""The PyTorch port's real-data path against the JAX package: the fixture
writer, the sampling / label / vocabulary helpers (property tests), and
``TVQAPlusDataset`` item by item and through ``collate_static`` on the same
TVQA+-format artifacts."""
import json
import os
import pickle

import h5py
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tvqaplus_tpu.config import Config as JaxConfig
from tvqaplus_tpu.data import batching as jbatch
from tvqaplus_tpu.data import fixtures as jfix
from tvqaplus_tpu.data import labels as jlabels
from tvqaplus_tpu.data import sampling as jsamp
from tvqaplus_tpu.data import spatial as jspatial
from tvqaplus_tpu.data import tvqa as jtvqa
from tvqaplus_tpu.utils import io as jio
from tvqaplus_tpu.utils import misc as jmisc
from tvqaplus_tpu_torch.config import Config
from tvqaplus_tpu_torch.data import batching as tbatch
from tvqaplus_tpu_torch.data import fixtures as tfix
from tvqaplus_tpu_torch.data import labels as tlabels
from tvqaplus_tpu_torch.data import sampling as tsamp
from tvqaplus_tpu_torch.data import spatial as tspatial
from tvqaplus_tpu_torch.data import tvqa as ttvqa
from tvqaplus_tpu_torch.utils import io as tio
from tvqaplus_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)
PROPS = settings(max_examples=150, deadline=None, database=None,
                 derandomize=True, suppress_health_check=[HealthCheck.too_slow])
JSON_FILES = ("train_path", "valid_path", "sub_path", "frm_cnt_path",
              "vcpt_path", "word2idx_path", "eval_object_vocab_path")
H5_FILES = ("qa_bert_path", "sub_bert_path", "vfeat_path")
# artifact sets: the e2e test's geometry at tiny widths, and videos longer
# than the 300-frame cap (get_ts_label's rescale, the grid's cap)
ARTIFACTS = {
    "short": dict(n_videos=4, qa_per_video=2, frames_per_video=42,
                  bert_dim=8, vfeat_dim=4, num_region=5, seed=3,
                  split="overlap"),
    "long": dict(n_videos=2, qa_per_video=2, frames_per_video=330,
                 bert_dim=8, vfeat_dim=4, num_region=4, seed=5),
}


def outcome(fn, *args):
    """``fn(*args)``, or the type of the exception it raised: the copies
    must fail where the originals fail (the +1-pixel IoU divides by zero
    on some box pairs)."""
    try:
        return fn(*args)
    except (ArithmeticError, AssertionError) as e:
        return type(e)


# ------------------------------------------------------------ fixture writer
def h5_tables(path):
    with h5py.File(path, "r") as h5:
        return {k: h5[k][:] for k in h5.keys()}


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_write_artifacts_matches_jax(tmp_path, name):
    kw = ARTIFACTS[name]
    ref = jfix.write_artifacts(str(tmp_path / "jax"), **kw)
    got = tfix.write_artifacts(str(tmp_path / "torch"), **kw)
    assert set(got) == set(ref)
    for key in JSON_FILES:
        with open(ref[key], "rb") as a, open(got[key], "rb") as b:
            assert a.read() == b.read(), key
    for key in H5_FILES:
        a, b = h5_tables(ref[key]), h5_tables(got[key])
        assert set(a) == set(b), key
        for k in a:
            assert a[k].dtype == b[k].dtype, (key, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key} {k}")
    gt_ref = jfix.gt_as_prediction(ref["valid_path"], str(tmp_path / "a.json"))
    gt_got = tfix.gt_as_prediction(got["valid_path"], str(tmp_path / "b.json"))
    with open(gt_ref, "rb") as a, open(gt_got, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ sampling
@st.composite
def grid_case(draw):
    interval = draw(st.sampled_from([3, 6]))
    num_imgs = draw(st.integers(1, 420))
    start = draw(st.integers(1, min(num_imgs, 300)))
    end = draw(st.integers(start, num_imgs + 30))
    return start, end, num_imgs, interval


@PROPS
@given(grid_case())
def test_get_all_img_ids_matches_jax(case):
    start, end, num_imgs, interval = case
    assert tsamp.get_all_img_ids(start, end, num_imgs, interval) == \
        jsamp.get_all_img_ids(start, end, num_imgs, interval)


@PROPS
@given(grid_case(), st.floats(0, 150), st.floats(0, 30))
def test_get_ts_label_matches_jax(case, st_s, dur):
    start, end, num_imgs, interval = case
    ids, _, _ = jsamp.get_all_img_ids(start, end, num_imgs, interval)
    indices0 = np.asarray(ids) - 1
    assert tsamp.get_ts_label(st_s, st_s + dur, num_imgs, indices0) == \
        jsamp.get_ts_label(st_s, st_s + dur, num_imgs, indices0)


@st.composite
def subtitle_case(draw):
    n = draw(st.integers(1, 8))
    sents = [" ".join(draw(st.lists(st.sampled_from(["hi", "a", "cup", "so"]),
                                    min_size=1, max_size=5)))
             for _ in range(n)]
    times = sorted(draw(st.lists(st.floats(0, 60), min_size=n, max_size=n)))
    img_ids = draw(st.lists(st.integers(1, 300), min_size=1, max_size=12))
    return " <eos> ".join(sents), times, img_ids


@PROPS
@given(subtitle_case(), st.sampled_from(["nearest", "span", "larger"]))
def test_subtitle_alignment_matches_jax(case, mode):
    text, times, img_ids = case
    got = tsamp.get_aligned_sub_indices(img_ids, text, times, mode=mode)
    ref = jsamp.get_aligned_sub_indices(img_ids, text, times, mode=mode)
    assert got == ref
    assert tsamp.get_aligned_sub(text, got[0]) == \
        jsamp.get_aligned_sub(text, ref[0])


# ------------------------------------------------------------ utils
@PROPS
@given(st.lists(st.integers(0, 4), min_size=1, max_size=6),
       st.integers(-3, 3), st.sampled_from([0, 1, 2]))
def test_dissect_by_lengths_matches_jax(lengths, extra, dim):
    total = max(0, sum(lengths) + extra)
    shape = [2, 2, 2]
    shape[dim] = total
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for assert_equal in (True, False):
        try:
            ref = jmisc.dissect_by_lengths(arr, lengths, dim, assert_equal)
        except AssertionError:
            with pytest.raises(AssertionError):
                tmisc.dissect_by_lengths(arr, lengths, dim, assert_equal)
            continue
        got = tmisc.dissect_by_lengths(arr, lengths, dim, assert_equal)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        if dim == 0:
            for g, r in zip(ttvqa.rm_empty_by_copy(list(got)),
                            jtvqa.rm_empty_by_copy(list(ref))):
                np.testing.assert_array_equal(g, r)


def test_small_helpers_match_jax(tmp_path):
    lol = [[1, 2], [], [3]]
    assert tmisc.flat_list_of_lists(lol) == jmisc.flat_list_of_lists(lol)
    dicts = [{"a": 1, "b": 2}, {"b": 3}, {"c": 4}]
    assert tmisc.merge_dicts(dicts) == jmisc.merge_dicts(dicts)
    rows = [{"a": 1}, {"b": [2, 3]}]
    jio.save_jsonl(rows, str(tmp_path / "j.jsonl"))
    tio.save_jsonl(rows, str(tmp_path / "t.jsonl"))
    tio.save_jsonl(rows[:1], str(tmp_path / "t.jsonl"), append=True)
    jio.save_jsonl(rows[:1], str(tmp_path / "j.jsonl"), append=True)
    with open(tmp_path / "t.jsonl", "a") as f:
        f.write("\nnot json\n")
    assert tio.read_json_lines(str(tmp_path / "t.jsonl")) == \
        jio.read_json_lines(str(tmp_path / "j.jsonl")) == rows + rows[:1]
    with open(tmp_path / "p.pickle", "wb") as f:
        pickle.dump({"x": [1, 2]}, f)
    assert tio.load_pickle(str(tmp_path / "p.pickle")) == \
        jio.load_pickle(str(tmp_path / "p.pickle"))
    glove = tmp_path / "glove.txt"
    glove.write_text("cup 0.5 -1\nbook 2 3\n\n")
    got, ref = tio.load_glove(str(glove)), jio.load_glove(str(glove))
    assert set(got) == set(ref)
    for w in ref:
        np.testing.assert_array_equal(got[w], ref[w])
    qas = [{"vid": "x", "q": 1}, {"vid": "y"}, {"vid": "x"}]
    assert ttvqa.filter_list_dicts(qas, "vid", ["x"]) == \
        jtvqa.filter_list_dicts(qas, "vid", ["x"]) == [qas[0], qas[2]]


BOX = st.tuples(st.floats(0, 500), st.floats(0, 300), st.floats(1, 150),
                st.floats(1, 120)).map(lambda b: [b[0], b[1], b[0] + b[2],
                                                  b[1] + b[3]])


@PROPS
@given(BOX, BOX)
def test_compute_iou_xyxy_matches_jax(a, b):
    assert outcome(tmisc.compute_iou_xyxy, a, b) == \
        outcome(jmisc.compute_iou_xyxy, a, b)


@PROPS
@given(st.text(alphabet="abcdnotmylsvreCANTIDO'` 0123456789", max_size=40))
def test_match_stanford_tokenizer_matches_jax(line):
    assert tmisc.match_stanford_tokenizer(line) == \
        jmisc.match_stanford_tokenizer(line)


# ------------------------------------------------------------ labels
OBJ = st.sampled_from(["cup", "Laptop", "book"])


@st.composite
def label_case(draw):
    frm_cnt = draw(st.integers(3, 12))
    detected = [draw(st.lists(BOX, min_size=0, max_size=5))
                for _ in range(frm_cnt)]
    gt = {}
    for img in draw(st.sets(st.integers(1, frm_cnt + 2), min_size=1,
                            max_size=4)):
        gt[str(img)] = [
            {"left": b[0], "top": b[1], "width": b[2] - b[0],
             "height": b[3] - b[1], "label": draw(OBJ)}
            for b in draw(st.lists(BOX, min_size=1, max_size=3))]
        if draw(st.booleans()) and img <= frm_cnt and detected[img - 1]:
            gt[str(img)][0].update(        # an exact hit on a detection
                left=detected[img - 1][0][0], top=detected[img - 1][0][1],
                width=detected[img - 1][0][2] - detected[img - 1][0][0],
                height=detected[img - 1][0][3] - detected[img - 1][0][1])
    words = draw(st.lists(st.sampled_from(["what", "cup", "laptop", "book",
                                           "a"]), min_size=1, max_size=8))
    return gt, detected, frm_cnt, " ".join(words)


@PROPS
@given(label_case(), st.sampled_from([0.3, 0.5, 0.9]), st.booleans())
def test_iou_data_and_att_labels_match_jax(case, thd, single_box):
    gt, detected, frm_cnt, sentence = case
    iou = outcome(tlabels.build_iou_data, gt, detected, frm_cnt)
    assert iou == outcome(jlabels.build_iou_data, gt, detected, frm_cnt)
    if not isinstance(iou, dict):
        return
    cnts = [len(detected[int(k) - 1]) for k in sorted(iou, key=int)]
    ca_len = len(sentence.split()) + 1
    got = tlabels.make_att_label(iou, sentence, cnts, ca_len, thd, single_box)
    ref = jlabels.make_att_label(iou, sentence, cnts, ca_len, thd, single_box)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


VOCAB = {"<pad>": 0, "<unk>": 1, "<eos>": 2, "what": 3, "cup": 4,
         "can": 5, "not": 6, "n't": 7, "'s": 8, "am": 9, "tennis": 10,
         "court": 11, "red": 12}
WORD = st.sampled_from(["what", "Cup", "cannot", "don't", "it's", "9am",
                        "zebra", "RED", "tennis court", "court"])


@PROPS
@given(st.lists(st.tuples(st.integers(1, 6), WORD), max_size=4),
       st.lists(st.tuples(st.integers(1, 4), WORD), max_size=4),
       st.booleans())
def test_make_noun_mask_matches_jax(nq, na, eos):
    tv, jv = tlabels.Vocabulary(VOCAB), jlabels.Vocabulary(VOCAB)
    got = tlabels.make_noun_mask(nq, na, 6, 4, tv, eos=eos)
    ref = jlabels.make_noun_mask(nq, na, 6, 4, jv, eos=eos)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@PROPS
@given(st.lists(WORD, max_size=10), st.booleans(), st.booleans())
def test_vocabulary_matches_jax(words, eos, match):
    tv, jv = tlabels.Vocabulary(VOCAB), jlabels.Vocabulary(VOCAB)
    line = " ".join(words)
    assert tv.numericalize(line, eos=eos, match=match) == \
        jv.numericalize(line, eos=eos, match=match)
    frames = [words[i: i + 3] for i in range(0, len(words), 3)]
    assert tv.numericalize_hier_vcpt(frames) == \
        jv.numericalize_hier_vcpt(frames)
    assert tv.numericalize_vcpt(", ".join(words)) == \
        jv.numericalize_vcpt(", ".join(words))
    assert (len(tv), "cup" in tv, tv.get("zebra")) == \
        (len(jv), "cup" in jv, jv.get("zebra"))


def test_vocabulary_build_save_load_match_jax(tmp_path):
    sents = ["what is the cup", "the cup is red", "a red book", "what"]
    glove = tmp_path / "glove.txt"
    glove.write_text("the 1 2 3\ncup 4 5 6\n")
    tv = tlabels.Vocabulary.build(sents, glove_path=str(glove),
                                  embedding_dim=3)
    jv = jlabels.Vocabulary.build(sents, glove_path=str(glove),
                                  embedding_dim=3)
    assert tv.word2idx == jv.word2idx and tv.idx2word == jv.idx2word
    np.testing.assert_array_equal(tv.embedding, jv.embedding)
    tv.save(str(tmp_path / "w2i.json"))
    assert tlabels.Vocabulary.load(str(tmp_path / "w2i.json")).word2idx == \
        jlabels.Vocabulary.load(str(tmp_path / "w2i.json")).word2idx


def test_spatial_helpers_match_jax():
    box = {"top": 30.0, "left": 100.0, "height": 90.0, "width": 200.0}
    for boxes in ([], [box], [box, dict(box, left=400.0, top=200.0)]):
        np.testing.assert_array_equal(
            tspatial.get_bbox_target_for_single_img(boxes),
            jspatial.get_bbox_target_for_single_img(boxes))
    data = {"3": [box], "9": [], "99": [box]}
    for g, r in zip(tspatial.get_bbox_target(data, 40),
                    jspatial.get_bbox_target(data, 40)):
        np.testing.assert_array_equal(g, r)
    feats = np.arange(96, dtype=np.float32).reshape(24, 4)
    np.testing.assert_array_equal(
        tspatial.get_elements_from_indices(feats, [1, 2], resolution=4),
        jspatial.get_elements_from_indices(feats, [1, 2], resolution=4))
    assert tspatial.get_elements_from_indices([5, 6, 7], [2, 0]) == \
        jspatial.get_elements_from_indices([5, 6, 7], [2, 0])
    for g, r in zip(tspatial.get_elements_variable_length(
                        feats, [0, 2], [10, 6, 8], max_num_region=7),
                    jspatial.get_elements_variable_length(
                        feats, [0, 2], [10, 6, 8], max_num_region=7)):
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------------ the dataset
@pytest.fixture(scope="module")
def artifact_sets(tmp_path_factory):
    """The JAX writer's artifacts (the reference of the loader parity),
    plus variants that drive the loader's rarer branches."""
    out = {}
    for name, kw in ARTIFACTS.items():
        out[name] = jfix.write_artifacts(
            str(tmp_path_factory.mktemp(name)), **kw)
    # a video whose subtitle stream is shorter than its sentences: the
    # dissect fallback with rm_empty_by_copy
    root = str(tmp_path_factory.mktemp("short_sub"))
    paths = jfix.write_artifacts(root, **ARTIFACTS["short"])
    with h5py.File(paths["sub_bert_path"], "a") as h5:
        vid = sorted(h5.keys())[0]
        rows = h5[vid][:]
        del h5[vid]
        h5[vid] = rows[: len(rows) // 3]
    out["short_sub"] = paths
    # vcpt as a pickle that lacks one video: the debug filter drops its QAs
    root = str(tmp_path_factory.mktemp("pickle"))
    paths = jfix.write_artifacts(root, **ARTIFACTS["short"])
    with open(paths["vcpt_path"]) as f:
        vcpt = json.load(f)
    vcpt.pop(sorted(vcpt)[-1])
    paths["vcpt_path"] = os.path.join(root, "vcpt.pickle")
    with open(paths["vcpt_path"], "wb") as f:
        pickle.dump(vcpt, f)
    out["debug_pickle"] = paths
    return out


def both_configs(paths, **kw):
    fields = dict(paths, test_path=paths["valid_path"], bsz=4, test_bsz=4,
                  no_core_driver=True, **kw)
    jcfg = JaxConfig(**fields)
    jcfg.finalize(save=False)
    return jcfg, Config(**fields).finalize("cpu")


def datasets(artifact_sets, name, mode, **kw):
    dims = ARTIFACTS["long" if name == "long" else "short"]
    jcfg, cfg = both_configs(artifact_sets[name],
                             embedding_size=dims["bert_dim"],
                             vfeat_size=dims["vfeat_dim"],
                             num_region=dims["num_region"], **kw)
    return (jtvqa.TVQAPlusDataset(jcfg, mode=mode),
            ttvqa.TVQAPlusDataset(cfg, mode=mode), jcfg, cfg)


def assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k], ref[k]
        if k == "att_labels_dense" and b is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif k in ("qas_bert", "sub_bert", "vfeat", "qa_noun_masks") \
                and b is not None:
            assert len(a) == len(b), k
            for x, y in zip(a, b):
                assert np.asarray(x).dtype == np.asarray(y).dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif k == "sub_tokens":
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, k


def assert_collates_equal(got_items, ref_items, jcfg, cfg, train):
    spec_j = jbatch.StaticShapeSpec.from_config(jcfg, batch=len(ref_items))
    spec_t = tbatch.StaticShapeSpec.from_config(cfg, batch=len(got_items),
                                                train=train)
    ref, jmeta = jbatch.collate_static(ref_items, spec_j, skip_att=not train)
    got, meta = tbatch.collate_static(got_items, spec_t)
    want_keys = set(ref) if train else set(ref) - set(jbatch.ATT_KEYS)
    assert set(got) == want_keys
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    for k in ("qid", "vid_name", "image_indices", "boxes", "ts", "target",
              "anno_st", "sub_tok_overflow"):
        assert meta[k] == jmeta[k], k
    if train:
        assert meta["att_n_pos"] == jmeta["att_n_pos"]
    return got


CASES = {
    "default": dict(),
    "no_sup_att": dict(use_sup_att=False),
    "expanded_sub": dict(sub_dedup=False),
    "no_sup_att_expanded_sub": dict(use_sup_att=False, sub_dedup=False),
    "interval3": dict(frame_interval=3, max_num_img=100),
    "interval3_expanded_sub": dict(frame_interval=3, max_num_img=100,
                                   sub_dedup=False),
    "vcpt_stream": dict(input_streams=["sub", "vfeat", "vcpt"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["train", "valid", "test"])
@pytest.mark.parametrize("name", ["short", "long"])
def test_dataset_items_and_collate_match_jax(artifact_sets, name, mode,
                                             case):
    kw = {"use_sup_att": True, **CASES[case]}
    jds, ds, jcfg, cfg = datasets(artifact_sets, name, mode, **kw)
    assert len(ds) == len(jds) > 0
    items, ref_items = [ds[i] for i in range(len(ds))], \
        [jds[i] for i in range(len(jds))]
    for got, ref in zip(items, ref_items):
        assert_items_equal(got, ref)
    if mode == "train" and kw["use_sup_att"]:
        assert any(it["att_labels_dense"][0].sum() > 0 for it in items)
    if "vcpt" in kw.get("input_streams", ()):
        assert all(len(it["vcpt"]) == len(it["image_indices"])
                   for it in items)
    for i in range(0, len(items), 4):
        assert_collates_equal(items[i: i + 4], ref_items[i: i + 4], jcfg,
                              cfg, train=mode == "train")


@pytest.mark.parametrize("name", ["short_sub", "debug_pickle"])
def test_rare_loader_branches_match_jax(artifact_sets, name):
    kw = dict(use_sup_att=True, debug=name == "debug_pickle")
    jds, ds, jcfg, cfg = datasets(artifact_sets, name, "train", **kw)
    for mode in ("train", "valid"):
        jds.set_mode(mode)
        ds.set_mode(mode)
        assert len(ds) == len(jds)
        for i in range(len(ds)):
            assert_items_equal(ds[i], jds[i])
    with open(artifact_sets[name]["train_path"]) as f:
        n_train = len(json.load(f))
    jds.set_mode("train")
    if name == "debug_pickle":
        assert len(jds) < n_train            # the filter dropped a video
    else:
        assert len(jds) == n_train


def test_dataset_items_with_noun_indices_match_jax(artifact_sets):
    jds, ds, jcfg, cfg = datasets(artifact_sets, "short", "train",
                                  use_sup_att=True)
    entries = []
    for e in ds.cur_data:
        e = dict(e, q_noun_indices=[[3, "sheldon"], [7, "zzz"],
                                    [8, e["q"].split()[-1]]])
        for k in range(5):
            e[f"a{k}_noun_indices"] = [[2, e[f"a{k}"].split()[-1]]][: k % 2]
        entries.append(e)
    ds.cur_data, jds.cur_data = entries, [dict(e) for e in entries]
    items = [ds[i] for i in range(len(ds))]
    ref_items = [jds[i] for i in range(len(jds))]
    for got, ref in zip(items, ref_items):
        assert_items_equal(got, ref)
        assert got["qa_noun_masks"][1].sum() > got["qa_noun_masks"][0].sum()
    got = assert_collates_equal(items[:4], ref_items[:4], jcfg, cfg, True)
    assert got["qa_noun_masks"].shape == (4, 5, cfg.max_qa_l)


@pytest.mark.parametrize("name", ["short", "long"])
def test_view_set_mode_and_split_facts_match_jax(artifact_sets, name):
    jds, ds, _, _ = datasets(artifact_sets, name, "train", use_sup_att=True)
    assert ds.eval_object_word_ids == jds.eval_object_word_ids
    assert ds.eval_object_word_ids and 1 not in ds.eval_object_word_ids
    valid, jvalid = ds.view("valid"), jds.view("valid")
    assert valid.qa_bert_h5 is ds.qa_bert_h5
    assert valid.vid_h5 is ds.vid_h5 and valid.vocab is ds.vocab
    assert (ds.mode, valid.mode) == ("train", "valid")
    for a, b in ((ds, jds), (valid, jvalid)):
        assert len(a) == len(b)
        assert [e["qid"] for e in a.cur_data] == \
            [e["qid"] for e in b.cur_data]
        assert a.max_annotated_frames() == b.max_annotated_frames()
    for mode in ("valid", "test", "train"):
        ds.set_mode(mode)
        jds.set_mode(mode)
        assert (ds.mode, ds.inference, len(ds)) == \
            (jds.mode, jds.inference, len(jds))
        assert ds.max_annotated_frames() == jds.max_annotated_frames()
        assert_items_equal(ds[0], jds[0])
    assert valid.mode == "valid"             # the view kept its own mode


def test_pipeline_thread_and_valid_view_read_shared_handles(artifact_sets):
    """The pipeline's producer thread reads the train view's h5 handles
    while the main thread reads the valid view's (as validation does during
    a training epoch): every batch equals the one collated alone."""
    import sys
    import threading

    from tvqaplus_tpu_torch.data.pipeline import DataPipeline
    _, ds, _, cfg = datasets(artifact_sets, "short", "train",
                             use_sup_att=True)     # one Li bucket
    valid = ds.view("valid")
    want_valid = [valid[i] for i in range(len(valid))]
    spec = tbatch.StaticShapeSpec.from_config(cfg, batch=2, train=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            pipe = DataPipeline(ds, cfg, "cpu", batch_size=2, train=True,
                                prefetch_depth=1)
            order = np.arange(len(ds))
            np.random.default_rng((pipe.seed, pipe._epoch + 1)).shuffle(order)
            n = 0
            for batch, meta, bucket in pipe:
                for i, want in enumerate(want_valid):
                    assert_items_equal(valid[i], want)
                alone, _ = tbatch.collate_static(
                    [ds[int(j)] for j in order[2 * n: 2 * n + 2]],
                    spec.with_max_img(bucket))
                for k, v in alone.items():
                    np.testing.assert_array_equal(batch[k].numpy(), v, k)
                n += 1
            assert n == len(ds) // 2 == 4
            assert threading.active_count() < 20
    finally:
        sys.setswitchinterval(interval)

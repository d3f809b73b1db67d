"""TVQA+ dataset: the real-artifact loading path (the port's copy of
``tvqaplus_tpu/data/tvqa.py``).

Reads the exact artifact formats of the reference pipeline (reference
tvqa_dataset.py:33-222, run_main.sh:5-19):

* ``*_preprocessed.json`` QA files (qid, vid_name, q, a0..a4, answer_idx,
  ts, bbox, q_len/a{i}_len);
* BERT token-embedding HDF5s (``{qid}_q`` / ``{qid}_a{k}`` keys for QA;
  per-video concatenated subtitle tokens split back by sentence lengths);
* region-feature HDF5 (per-video concatenated Faster-R-CNN features split
  by per-frame counts);
* vcpt json/pickle (boxes / counts / object labels per frame);
* frame-count cache, word2idx, eval object vocab.

``__getitem__`` yields the ragged example dict consumed by
``data.batching.collate_static``, with dense supervised-attention labels.
The ``core`` h5 driver (whole file into RAM, reference config.py:189) is
h5py's own driver flag.  h5py is imported when a dataset is built, so the
rest of the port imports without it.
"""
from __future__ import annotations

import numpy as np

from tvqaplus_tpu_torch.data.labels import Vocabulary, build_iou_data, \
    densify_att_labels, make_att_label, make_noun_mask
from tvqaplus_tpu_torch.data.sampling import get_aligned_sub, \
    get_aligned_sub_indices, get_all_img_ids, get_ts_label
from tvqaplus_tpu_torch.utils.io import load_json, load_pickle
from tvqaplus_tpu_torch.utils.misc import dissect_by_lengths


def filter_list_dicts(list_dicts, key, values):
    values = set(values)
    return [e for e in list_dicts if e[key] in values]


def rm_empty_by_copy(list_array):
    """Replace empty chunks with their predecessor (7 malformed videos in
    the corpus, reference tvqa_dataset.py:24-29)."""
    for idx in range(len(list_array)):
        if len(list_array[idx]) == 0:
            list_array[idx] = list_array[idx - 1]
    return list_array


class TVQAPlusDataset:
    def __init__(self, cfg, mode="train"):
        import h5py

        self.cfg = cfg
        self.mode = mode
        self.inference = mode == "test"
        self.num_region = cfg.num_region
        self.use_sup_att = cfg.use_sup_att
        self.att_iou_thd = cfg.att_iou_thd
        self.sub_flag = cfg.sub_flag
        self.vfeat_flag = cfg.vfeat_flag
        self.vcpt_flag = cfg.vcpt_flag or cfg.vfeat_flag

        self.raw_train = load_json(cfg.train_path)
        self.raw_valid = load_json(cfg.valid_path)
        self.raw_test = load_json(cfg.test_path) if cfg.test_path else None
        self.sub_data = load_json(cfg.sub_path) if cfg.sub_path else None
        self.frm_cnt_dict = load_json(cfg.frm_cnt_path)

        self.qa_bert_h5 = h5py.File(cfg.qa_bert_path, "r",
                                    driver=cfg.h5driver)
        self.sub_bert_h5 = (h5py.File(cfg.sub_bert_path, "r",
                                      driver=cfg.h5driver)
                            if self.sub_flag else None)
        self.vid_h5 = (h5py.File(cfg.vfeat_path, "r", driver=cfg.h5driver)
                       if self.vfeat_flag else None)
        if self.vcpt_flag:
            self.vcpt_dict = (load_pickle(cfg.vcpt_path)
                              if cfg.vcpt_path.endswith(".pickle")
                              else load_json(cfg.vcpt_path))
            if cfg.debug:
                vids = list(self.vcpt_dict.keys())
                self.raw_train = filter_list_dicts(self.raw_train,
                                                   "vid_name", vids)
                self.raw_valid = filter_list_dicts(self.raw_valid,
                                                   "vid_name", vids)
                if self.raw_test:
                    self.raw_test = filter_list_dicts(self.raw_test,
                                                      "vid_name", vids)
        else:
            self.vcpt_dict = None

        self.vocab = Vocabulary.load(cfg.word2idx_path)
        self.eval_object_vocab = (load_json(cfg.eval_object_vocab_path)
                                  if cfg.eval_object_vocab_path else [])
        self.eval_object_word_ids = [self.vocab.get(w)
                                     for w in self.eval_object_vocab]
        self.cur_data = self.get_cur_dict()

    # ------------------------------------------------------------------
    def set_mode(self, mode):
        self.mode = mode
        self.inference = mode == "test"
        self.cur_data = self.get_cur_dict()

    def view(self, mode):
        """Shallow split view: shares every loaded artifact (h5 handles, the
        RAM-resident core-driver data, vocab) but has independent
        mode/cur_data — needed because the pipeline's producer thread reads
        the train view while validation runs on the valid view (h5py
        serialises the reads behind its own lock)."""
        import copy
        v = copy.copy(self)
        v.set_mode(mode)
        return v

    def get_cur_dict(self):
        if self.mode == "train":
            return self.raw_train
        if self.mode == "valid":
            return self.raw_valid
        if self.raw_test is None:
            raise NotImplementedError("no test split configured")
        return self.raw_test

    def __len__(self):
        return len(self.cur_data)

    def max_annotated_frames(self):
        """Max annotated-frame count over the CURRENT split.

        The serving loop sizes its grounding-window gather (``f_max``,
        ``infer/predict.py``) from this.  Cheap host pass: re-derives the
        sampled-grid window bounds (``get_all_img_ids``) each entry's
        ``__getitem__`` would compute, without touching the feature
        HDF5s."""
        best = 0
        for entry in self.cur_data:
            located = sorted(int(e) for e in entry["bbox"].keys())
            _, start_idx, end_idx = get_all_img_ids(
                located[0], located[-1], self.frm_cnt_dict[entry["vid_name"]],
                frame_interval=self.cfg.frame_interval)
            best = max(best, end_idx - start_idx + 1)
        return best

    def mk_noun_mask(self, noun_indices_q, noun_indices_a, q_l, a_l,
                     eos=True):
        """Noun-position mask over q+ca words (reference
        tvqa_dataset.py:310-328); see labels.make_noun_mask."""
        return make_noun_mask(noun_indices_q, noun_indices_a, q_l, a_l,
                              self.vocab, eos=eos)

    # ------------------------------------------------------------------
    def __getitem__(self, index):
        cfg = self.cfg
        entry = self.cur_data[index]
        vid_name = entry["vid_name"]
        qid = entry["qid"]
        frm_cnt = self.frm_cnt_dict[vid_name]
        located_img_ids = sorted(int(e) for e in entry["bbox"].keys())
        indices, start_idx, end_idx = get_all_img_ids(
            located_img_ids[0], located_img_ids[-1], frm_cnt,
            frame_interval=cfg.frame_interval)
        indices0 = np.array(indices) - 1  # image ids are 1-indexed

        items = {"vid_name": vid_name, "qid": qid, "anno_st_idx": start_idx,
                 "image_indices": (indices0 + 1).tolist()}

        if "ts" in entry:
            items["ts_label"] = get_ts_label(entry["ts"][0], entry["ts"][1],
                                             frm_cnt, indices0)
            items["ts"] = entry["ts"]
        else:
            items["ts_label"], items["ts"] = [0, 0], None

        if self.mode in ("test", "valid") and self.vfeat_flag:
            boxes = self.vcpt_dict[vid_name]["boxes"]
            lowered = [boxes[i][: self.num_region] for i in indices0]
            items["boxes"] = lowered[start_idx: end_idx + 1]
        else:
            items["boxes"] = None

        if "answer_idx" in entry:
            ca_idx = int(entry["answer_idx"])
            items["target"] = ca_idx
            ca_l = entry[f"a{ca_idx}_len"]
        else:
            items["target"] = 999

        answer_keys = ["a0", "a1", "a2", "a3", "a4"]
        items["qas"] = [self.vocab.numericalize(
            entry["q"] + " " + entry[k], eos=False) for k in answer_keys]
        if "q_noun_indices" in entry:
            # optional noun annotations ([1-indexed pos, word] lists per
            # sentence) -> per-answer noun masks over the q+ca word axis
            # (reference mk_noun_mask, tvqa_dataset.py:310-328; the eos=True
            # slot matches the qas_bert concat length q_len + a_len + 1)
            items["qa_noun_masks"] = [
                self.mk_noun_mask(entry["q_noun_indices"],
                                  entry.get(f"{k}_noun_indices", []),
                                  entry["q_len"], entry[f"{k}_len"])
                for k in answer_keys]
        items["qas_bert"] = [np.concatenate(
            [self.qa_bert_h5[f"{qid}_q"], self.qa_bert_h5[f"{qid}_{k}"]],
            axis=0) for k in answer_keys]
        items["q_l"] = entry["q_len"]

        if self.sub_flag:
            sub = self.sub_data[vid_name]
            aligned_idx, raw_n_tokens = get_aligned_sub_indices(
                indices0 + 1, sub["sub_text"], sub["sub_time"],
                mode="nearest")
            try:
                chunks = dissect_by_lengths(self.sub_bert_h5[vid_name][:],
                                            raw_n_tokens)
            except AssertionError:
                chunks = dissect_by_lengths(self.sub_bert_h5[vid_name][:],
                                            raw_n_tokens, assert_equal=False)
                chunks = rm_empty_by_copy(chunks)
            items["sub_bert"] = [
                np.concatenate([chunks[i] for i in idxs], axis=0)
                for idxs in aligned_idx]
            # dedup contract: the h5's native one-stream-per-video layout
            # plus per-frame (start, len) spans — aligned windows are
            # consecutive sentences (sampling.py find_match), so each is a
            # contiguous stream slice.  Non-consecutive windows (never
            # produced by the current modes) would fall back to the
            # expanded sub_bert in collate.
            starts = np.cumsum([0] + [len(c) for c in chunks])
            if all(list(idxs) == list(range(idxs[0], idxs[-1] + 1))
                   for idxs in aligned_idx if idxs):
                items["sub_tokens"] = np.concatenate(chunks, axis=0)
                items["sub_win_spans"] = [
                    (int(starts[idxs[0]]),
                     int(starts[idxs[-1] + 1] - starts[idxs[0]]))
                    if idxs else (0, 0) for idxs in aligned_idx]
            aligned_text = get_aligned_sub(sub["sub_text"], aligned_idx)
            items["sub"] = [self.vocab.numericalize(t, eos=False)
                            for t in aligned_text]
        else:
            items["sub_bert"] = None
            items["sub"] = None

        if self.vfeat_flag or self.vcpt_flag:
            region_counts = self.vcpt_dict[vid_name]["counts"]
            localized_counts = [min(region_counts[i], self.num_region)
                                for i in indices0][start_idx: end_idx + 1]

        if self.vcpt_flag:
            objects = self.vcpt_dict[vid_name]["object"]
            obj_labels = [objects[i][: self.num_region] for i in indices0]
            items["vcpt"] = self.vocab.numericalize_hier_vcpt(obj_labels)
            items["object_labels"] = obj_labels

        if self.vfeat_flag:
            feats = dissect_by_lengths(self.vid_h5[vid_name][:],
                                       region_counts)
            items["vfeat"] = [feats[i][: self.num_region] for i in indices0]
        else:
            items["vfeat"] = None

        if ("answer_idx" in entry and self.use_sup_att
                and not self.inference and self.vfeat_flag):
            q_ca = entry["q"] + " " + entry[f"a{ca_idx}"]
            iou_data = build_iou_data(entry["bbox"],
                                      self.vcpt_dict[vid_name]["boxes"],
                                      frm_cnt)
            # region counts + grid positions of the ANNOTATED images.  At
            # the default 0.5 fps these are consecutive grid points starting
            # at start_idx (the reference's assumption); at other frame
            # rates the annotated frames interleave with unannotated ones.
            anno_ids = sorted(iou_data.keys(), key=int)
            region_counts = self.vcpt_dict[vid_name]["counts"]
            att_cnts = [min(region_counts[int(k) - 1], self.num_region)
                        for k in anno_ids]
            positions = [indices.index(int(k)) if int(k) in indices
                         else len(indices) for k in anno_ids]
            att = make_att_label(iou_data, q_ca, att_cnts,
                                 entry["q_len"] + ca_l + 1,
                                 iou_thd=self.att_iou_thd,
                                 single_box=self.inference)
            items["att_labels_dense"] = densify_att_labels(
                att, positions, min(len(indices0), cfg.max_num_img),
                cfg.max_qa_l, self.num_region)
        else:
            items["att_labels_dense"] = None
        return items

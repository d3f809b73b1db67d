"""Attention labels and the vocabulary (the port's copy of
``tvqaplus_tpu/data/labels.py``).

The supervised-attention targets couple GT boxes to detected regions through
string-matched labels and box IoU (reference tvqa_dataset.py:331-408).  They
are emitted dense: a (num_img, num_words, num_region) float array per
example plus a validity mask, from which the collate extracts the att loss's
static entry arrays on the host.
"""
from __future__ import annotations

import numpy as np

from tvqaplus_tpu_torch import native
from tvqaplus_tpu_torch.utils.io import load_glove, load_json, save_json
from tvqaplus_tpu_torch.utils.misc import match_stanford_tokenizer

PAD, UNK, EOS = "<pad>", "<unk>", "<eos>"
PAD_ID, UNK_ID, EOS_ID = 0, 1, 2


def iou_single_gt_box(single_box, detected_boxes):
    """IoUs of one GT box (top/left/width/height dict) against detected
    xyxy boxes, rounded to 4 decimals (reference tvqa_dataset.py:331-338);
    ``utils.misc.compute_iou_xyxy`` box by box, in one native call
    (native/fastops.c ``iou_xyxy_plus1``, as the JAX package)."""
    if not detected_boxes:
        return []
    gt = [single_box["left"], single_box["top"],
          single_box["left"] + single_box["width"],
          single_box["top"] + single_box["height"]]
    return [float("{:.4f}".format(v))
            for v in native.iou_one_vs_many(gt, detected_boxes)]


def build_iou_data(gt_box_data, detected_boxes_per_frame, frm_cnt):
    """Per annotated image id: list of {iou, label, img_id} records
    (reference tvqa_dataset.py:340-359).  ``img_id`` keys are 1-indexed
    strings; ids beyond the frame count are dropped."""
    limit = frm_cnt + 1
    iou_data = {}
    img_ids = sorted(gt_box_data.keys(), key=int)
    for img_id in img_ids:
        if int(img_id) >= limit:
            continue
        detected = detected_boxes_per_frame[int(img_id) - 1]
        iou_data[img_id] = [
            {"iou": iou_single_gt_box(box, detected),
             "label": box["label"],
             "img_id": img_id}
            for box in gt_box_data[img_id]
        ]
    return iou_data


def make_att_label(iou_data, q_ca_sentence, region_cnts, ca_len,
                   iou_thd=0.5, single_box=False):
    """Soft attention targets, one (n_words, n_regions) array per annotated
    image (reference tvqa_dataset.py:361-408).

    For every QA word position, GT boxes whose label string equals the word
    mark detected regions with IoU >= ``iou_thd``; marks are accumulated over
    GT boxes and normalized to sum to 1 (attention paid evenly to overlapped
    boxes).  ``single_box`` keeps only the argmax-IoU region per GT box.

    Returns list of np.float32 arrays, length = len(region_cnts)
    (= number of annotated images).
    """
    img_ids = sorted(iou_data.keys(), key=int)
    q_ca_words = q_ca_sentence.split()
    att_label = [np.zeros((ca_len, cnt), dtype=np.float32) for cnt in region_cnts]
    for idx, img_id in enumerate(img_ids):
        records = iou_data[img_id]
        labels = [r["label"] for r in records]
        for word_idx in range(ca_len - 1):  # never the trailing <eos> slot
            word = q_ca_words[word_idx]
            box_indices = [bi for bi, lab in enumerate(labels)
                           if lab.lower() == word.lower()]
            mask = None
            for bi in box_indices:
                ious = np.asarray(records[bi]["iou"][:region_cnts[idx]])
                if single_box:
                    if mask is None:
                        mask = np.zeros(len(ious))
                    if ious.size and ious.max() >= iou_thd:
                        mask[int(ious.argmax())] = 1
                else:
                    hit = (ious >= iou_thd).astype(np.float64)
                    mask = hit if mask is None else mask + hit
            if mask is not None and mask.sum() != 0:
                att_label[idx][word_idx] = (mask / mask.sum()).astype(np.float32)
    return att_label


def densify_att_labels(att_label_list, anno_st_idx, num_img, num_words,
                       num_region):
    """Ragged per-image (n_words, n_regions) label arrays -> dense
    (num_img, num_words, num_region) labels + defined-mask.
    ``anno_st_idx`` is the grid position of the first annotated image, or a
    list of positions."""
    if isinstance(anno_st_idx, (list, tuple, np.ndarray)):
        positions = list(anno_st_idx)
    else:
        positions = [anno_st_idx + i for i in range(len(att_label_list))]
    labels = np.zeros((num_img, num_words, num_region), dtype=np.float32)
    defined = np.zeros((num_img, num_words, num_region), dtype=np.float32)
    for arr, img_idx in zip(att_label_list, positions):
        if img_idx >= num_img:
            continue
        w = min(arr.shape[0], num_words)
        r = min(arr.shape[1], num_region)
        labels[img_idx, :w, :r] = arr[:w, :r]
        defined[img_idx, :w, :r] = 1.0
    return labels, defined


def att_entries_from_dense(labels, defined, entry_cap):
    """Dense (Li, Lw, Lr) labels -> the att loss's static entry arrays
    (pure label algebra, so it runs on the host at collate).

    Returns (entry_idx, entry_valid, neg_rows, rank, group_npos, n_pos):
      entry_idx   (E,) int32  flat (img, word, region) indices of the first
                              E positives, ascending;
      entry_valid (E,)  f32   1 for real entries;
      neg_rows    (E, Lr) f32 the entry's group's sampleable negatives
                              (defined & label == 0, stage.py:652-665);
      rank        (E,) int32  the entry's rank among its group's positives
                              in increasing region order (stage.py:654);
      group_npos  (E,) int32  positives in the entry's group;
      n_pos       int         all positives before the cap.
    """
    li, lw, lr = labels.shape
    pos = (labels > 0) & (defined > 0)
    neg = ((labels == 0) & (defined > 0)).reshape(li * lw, lr)
    pos2 = pos.reshape(li * lw, lr)
    flat_all = np.nonzero(pos.reshape(-1))[0]
    flat = flat_all[:entry_cap]
    e = entry_cap
    entry_idx = np.zeros(e, np.int32)
    entry_valid = np.zeros(e, np.float32)
    neg_rows = np.zeros((e, lr), np.float32)
    rank = np.zeros(e, np.int32)
    group_npos = np.zeros(e, np.int32)
    if len(flat):
        iw = (flat // lr).astype(np.int64)
        r = (flat % lr).astype(np.int64)
        n = len(flat)
        entry_idx[:n] = flat
        entry_valid[:n] = 1.0
        neg_rows[:n] = neg[iw]
        cums = np.cumsum(pos2[iw], axis=1)
        rank[:n] = cums[np.arange(n), r] - 1
        group_npos[:n] = pos2[iw].sum(axis=1)
    return entry_idx, entry_valid, neg_rows, rank, group_npos, len(flat_all)


def make_noun_mask(noun_indices_q, noun_indices_a, q_l, a_l, vocab,
                   eos=True):
    """Noun-position mask over the q+ca word axis (reference
    tvqa_dataset.py:310-328 ``mk_noun_mask``).

    ``noun_indices_q`` / ``noun_indices_a``: lists of [1-indexed position,
    word]; entries whose word is not in the vocabulary are dropped, answer
    positions are offset by ``q_l``, and the mask gets one trailing slot
    for <eos> when ``eos``.
    """
    iq = [e[0] for e in noun_indices_q if str(e[1]).lower() in vocab]
    ia = [e[0] + q_l for e in noun_indices_a if str(e[1]).lower() in vocab]
    indices = np.array(iq + ia) - 1
    mask = np.zeros(q_l + a_l + 1 if eos else q_l + a_l, np.float32)
    if len(indices) != 0:  # seems only 1 instance has no indices (ref)
        mask[indices.astype(np.int64)] = 1
    return mask


def line_to_words(line, eos=True, downcase=True):
    words = line.lower().split() if downcase else line.split()
    return words + [EOS] if eos else words


class Vocabulary:
    """word <-> id mapping with <pad>=0 <unk>=1 <eos>=2, built from the
    train split at threshold 2 with GloVe init, or loaded from a cache
    (reference tvqa_dataset.py:70-88, 444-490)."""

    def __init__(self, word2idx=None):
        self.word2idx = dict(word2idx) if word2idx else {PAD: 0, UNK: 1, EOS: 2}
        self.idx2word = {i: w for w, i in self.word2idx.items()}
        self.embedding = None

    def __len__(self):
        return len(self.word2idx)

    def __contains__(self, w):
        return w in self.word2idx

    def get(self, w):
        return self.word2idx.get(w, UNK_ID)

    @classmethod
    def load(cls, word2idx_path):
        return cls(load_json(word2idx_path))

    def save(self, word2idx_path):
        save_json(self.word2idx, word2idx_path)

    @classmethod
    def build(cls, sentences, word_count_threshold=2, glove_path=None,
              embedding_dim=300, rng=None):
        """Build from raw sentences; OOV GloVe rows are N(0, 0.4) random
        (reference tvqa_dataset.py:474-479)."""
        vocab = cls()
        counts = {}
        for s in sentences:
            for w in line_to_words(s, eos=False):
                counts[w] = counts.get(w, 0) + 1
        for w in counts:
            if counts[w] >= word_count_threshold and w not in vocab.word2idx:
                idx = len(vocab.word2idx)
                vocab.word2idx[w] = idx
                vocab.idx2word[idx] = w
        if glove_path:
            rng = rng or np.random.default_rng(0)
            glove = load_glove(glove_path)
            mat = np.zeros((len(vocab.word2idx), embedding_dim))
            for i in range(len(vocab.idx2word)):
                w = vocab.idx2word[i]
                mat[i] = glove[w] if w in glove else rng.standard_normal(
                    embedding_dim) * 0.4
            vocab.embedding = mat
        return vocab

    def numericalize(self, sentence, eos=True, match=False):
        """Words -> ids; ``match`` first normalizes to Stanford-tokenizer
        form (reference tvqa_dataset.py:410-416)."""
        if match:
            sentence = match_stanford_tokenizer(sentence)
        return [self.get(w) for w in line_to_words(sentence, eos=eos)]

    def numericalize_hier_vcpt(self, vcpt_words_list):
        """Per-frame object label lists -> ids, keeping only the last word of
        multi-word labels like 'tennis court'
        (reference tvqa_dataset.py:418-426)."""
        return [[self.get(e.split()[-1]) for e in frame_words]
                for frame_words in vcpt_words_list]

    def numericalize_vcpt(self, vcpt_sentence):
        """Comma-separated attr-object pairs -> deduped word ids + <eos>
        (reference tvqa_dataset.py:428-442)."""
        pairs = [e.strip() for e in vcpt_sentence.lower().split(",")]
        unique_pairs = []
        for p in pairs:
            if p not in unique_pairs:
                unique_pairs.append(p)
        words = [w for p in unique_pairs for w in p.split()] + [EOS]
        return [self.get(w) for w in words]

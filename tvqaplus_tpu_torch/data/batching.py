"""Static-shape batch assembly (the port's copy of
``tvqaplus_tpu/data/batching.py``; its per-example copy loops run in
native/fastops.c, as the JAX package's do).

Every batch pads to a ``StaticShapeSpec`` picked from a few frame-count
buckets.  Batch contract (numpy; B = batch, A = 5 answers):
  qas (B, A, Lqa) int32, qas_mask (B, A, Lqa) f32, qas_bert (B, A, Lqa, De),
  q_l (B,) int32,
  sub_tokens (B, St, De) + sub_win_idx (B, Li, Ls) int32   (sub_dedup), or
  sub_bert (B, Li, Ls, De),
  sub_mask (B, Li, Ls), vid (B, Li, Lr, Dv), vid_mask (B, Li, Lr),
  target / ts_st / ts_ed / anno_st (B,) int32, ts_mask (B, Li),
  ex_mask (B,) f32,
with ``qa_noun_masks`` (B, A, Lqa) f32 when an example carries noun masks
and ``vcpt`` / ``vcpt_mask`` (B, Li, Lr) when the vcpt stream is asked for
(both shipped as the JAX collate ships them; STAGE reads neither yet),
and for training (``att_entry_cap`` > 0) the supervised-attention entry
arrays ``ATT_KEYS`` (data/labels.py ``att_entries_from_dense``).
Host metadata (qid, vid_name, image_indices, boxes, ...) rides beside.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np

from tvqaplus_tpu_torch import native

# supervised-attention batch keys (training batches only)
ATT_KEYS = ("att_entry_idx", "att_entry_valid", "att_neg_rows",
            "att_entry_rank", "att_group_npos", "att_n_pos")


@dataclass(frozen=True)
class StaticShapeSpec:
    batch: int = 16
    num_a: int = 5
    max_qa_l: int = 40
    max_img: int = 50
    max_sub_l: int = 50
    num_region: int = 25
    bert_dim: int = 768
    vfeat_dim: int = 300
    max_sub_tokens: int = 0   # > 0: dedup contract (sub_tokens+sub_win_idx)
    att_entry_cap: int = 0    # > 0: training batch with ATT_KEYS (E slots)
    vcpt: bool = False        # ship the vcpt word-id batch keys

    @classmethod
    def from_config(cls, cfg, batch=None, train=False):
        dedup = getattr(cfg, "sub_dedup", False) and cfg.sub_flag
        return cls(batch=batch or cfg.bsz, num_a=5, max_qa_l=cfg.max_qa_l,
                   max_img=cfg.max_num_img,
                   max_sub_l=cfg.max_sub_l, num_region=cfg.num_region,
                   bert_dim=cfg.embedding_size, vfeat_dim=cfg.vfeat_size,
                   max_sub_tokens=cfg.max_sub_tokens if dedup else 0,
                   att_entry_cap=cfg.att_entry_cap if train else 0,
                   vcpt=cfg.vcpt_flag)

    def with_max_img(self, max_img):
        return dataclasses.replace(self, max_img=max_img)


def pick_bucket(n_img, buckets, cap):
    """Smallest bucket >= n_img (clamped to cap)."""
    n_img = min(n_img, cap)
    for b in sorted(buckets):
        if b >= n_img:
            return min(b, cap)
    return cap


def zeros_batch(spec: StaticShapeSpec):
    s = spec
    f32 = np.float32
    if s.max_sub_tokens:
        sub_keys = {
            "sub_tokens": np.zeros((s.batch, s.max_sub_tokens, s.bert_dim),
                                   f32),
            "sub_win_idx": np.zeros((s.batch, s.max_img, s.max_sub_l),
                                    np.int32)}
    else:
        sub_keys = {"sub_bert": np.zeros(
            (s.batch, s.max_img, s.max_sub_l, s.bert_dim), f32)}
    att_keys = {}
    if s.att_entry_cap:
        e = s.att_entry_cap
        att_keys = {
            "att_entry_idx": np.zeros((s.batch, e), np.int32),
            "att_entry_valid": np.zeros((s.batch, e), f32),
            "att_neg_rows": np.zeros((s.batch, e, s.num_region), f32),
            "att_entry_rank": np.zeros((s.batch, e), np.int32),
            "att_group_npos": np.zeros((s.batch, e), f32),
            "att_n_pos": np.zeros((s.batch,), f32)}
    return {
        "qas": np.zeros((s.batch, s.num_a, s.max_qa_l), np.int32),
        "qas_mask": np.zeros((s.batch, s.num_a, s.max_qa_l), f32),
        "qas_bert": np.zeros((s.batch, s.num_a, s.max_qa_l, s.bert_dim), f32),
        "q_l": np.zeros((s.batch,), np.int32),
        **sub_keys,
        "sub_mask": np.zeros((s.batch, s.max_img, s.max_sub_l), f32),
        "vid": np.zeros((s.batch, s.max_img, s.num_region, s.vfeat_dim), f32),
        "vid_mask": np.zeros((s.batch, s.max_img, s.num_region), f32),
        "target": np.zeros((s.batch,), np.int32),
        "ts_st": np.zeros((s.batch,), np.int32),
        "ts_ed": np.zeros((s.batch,), np.int32),
        "ts_mask": np.zeros((s.batch, s.max_img), f32),
        **att_keys,
        "anno_st": np.zeros((s.batch,), np.int32),
        "ex_mask": np.zeros((s.batch,), f32),
        **({"vcpt": np.zeros((s.batch, s.max_img, s.num_region), np.int32),
            "vcpt_mask": np.zeros((s.batch, s.max_img, s.num_region), f32)}
           if s.vcpt else {}),
    }


def pad_into(arrays, max_len, out, mask=None):
    """Copy ragged (len_i, dim) arrays into the first rows of the pre-zeroed
    (>= n, max_len, dim) ``out`` and mark ``mask`` (>= n, max_len), clipping
    at max_len (native/fastops.c ``pad_batch_f32``)."""
    n = len(arrays)
    native.pad_batch(arrays, max_len, out[:n],
                     None if mask is None else mask[:n])


def collate_static(examples: List[dict], spec: StaticShapeSpec):
    """Ragged per-example dicts -> one static-shape batch (arrays, meta).
    Sequences longer than the spec are clipped (the reference's
    ``prepare_inputs`` contract, tvqa_dataset.py:631-688)."""
    s = spec
    if len(examples) > s.batch:
        raise ValueError(f"{len(examples)} examples > batch {s.batch}")
    out = zeros_batch(s)
    meta = {"qid": [], "vid_name": [], "image_indices": [], "boxes": [],
            "ts": [], "att_n_pos": [], "sub_tok_overflow": [], "target": [],
            "anno_st": [], "qas_words": []}
    for b, ex in enumerate(examples):
        out["ex_mask"][b] = 1.0
        for a in range(s.num_a):
            ids = np.asarray(ex["qas"][a], np.int32)[: s.max_qa_l]
            out["qas"][b, a, : len(ids)] = ids
            out["qas_mask"][b, a, : len(ids)] = 1.0
        pad_into(ex["qas_bert"], s.max_qa_l, out["qas_bert"][b])
        out["q_l"][b] = ex.get("q_l", 0)
        if ex.get("qa_noun_masks") is not None:
            if "qa_noun_masks" not in out:
                out["qa_noun_masks"] = np.zeros(
                    (s.batch, s.num_a, s.max_qa_l), np.float32)
            for a in range(s.num_a):
                m = np.asarray(ex["qa_noun_masks"][a],
                               np.float32)[: s.max_qa_l]
                out["qa_noun_masks"][b, a, : len(m)] = m
        if s.vcpt and ex.get("vcpt") is not None:
            for i, frame_ids in enumerate(ex["vcpt"][: s.max_img]):
                ids = np.asarray(frame_ids, np.int32)[: s.num_region]
                out["vcpt"][b, i, : len(ids)] = ids
                out["vcpt_mask"][b, i, : len(ids)] = 1.0
        if s.max_sub_tokens:
            n_sub, n_over = _collate_sub_dedup(ex, s, out, b)
        else:
            sub_list = (ex.get("sub_bert") or [])[: s.max_img]
            n_sub, n_over = len(sub_list), 0
            pad_into(sub_list, s.max_sub_l, out["sub_bert"][b],
                     out["sub_mask"][b])
        vid_list = (ex.get("vfeat") or [])[: s.max_img]
        pad_into(vid_list, s.num_region, out["vid"][b], out["vid_mask"][b])
        out["target"][b] = ex.get("target", 999)
        ts = ex.get("ts_label", [0, 0])
        n_img = len(ex.get("image_indices", [])) or max(n_sub, len(vid_list))
        n_img = min(n_img, s.max_img)
        out["ts_st"][b] = min(ts[0], n_img - 1) if n_img else 0
        out["ts_ed"][b] = min(ts[1], n_img - 1) if n_img else 0
        out["ts_mask"][b, :n_img] = 1.0
        out["anno_st"][b] = ex.get("anno_st_idx", 0)
        att = ex.get("att_labels_dense") if s.att_entry_cap else None
        n_pos = 0
        if att is not None:
            n_pos = _collate_att(att, s, out, b)
        meta["att_n_pos"].append(n_pos)
        meta["qid"].append(ex.get("qid", b))
        meta["vid_name"].append(ex.get("vid_name", ""))
        meta["image_indices"].append(ex.get("image_indices", []))
        meta["boxes"].append(ex.get("boxes"))
        meta["ts"].append(ex.get("ts"))
        meta["sub_tok_overflow"].append(n_over)
        meta["target"].append(int(out["target"][b]))
        meta["anno_st"].append(int(out["anno_st"][b]))
        meta["qas_words"].append(out["qas"][b].copy())
    return out, meta


def _collate_att(att, s, out, b):
    """The att-loss entry arrays of example ``b`` from its dense labels
    clipped to the spec (``labels.att_entries_from_dense`` in one pass,
    native/fastops.c ``att_entries_f32``); returns its positives before the
    cap."""
    labels, defined = att
    n_pos = native.att_entries(
        labels, defined, (s.max_img, s.max_qa_l, s.num_region),
        s.att_entry_cap, out["att_entry_idx"][b], out["att_entry_valid"][b],
        out["att_neg_rows"][b], out["att_entry_rank"][b],
        out["att_group_npos"][b])
    out["att_n_pos"][b] = n_pos
    return n_pos


def _collate_sub_dedup(ex, s, out, b):
    """Fill the dedup subtitle contract for example ``b``: the per-video
    token stream ``sub_tokens`` (slot 0 reserved all-zero) and per-frame
    window gather indices from ``sub_win_spans`` (start, len); examples with
    only expanded ``sub_bert`` windows get a stream made by concatenating
    them.  Returns (n_windows, n_overflow_tokens)."""
    stream = ex.get("sub_tokens")
    win_spans = ex.get("sub_win_spans")
    if stream is None or win_spans is None:
        wins = [np.asarray(w)[: s.max_sub_l] for w in
                (ex.get("sub_bert") or [])[: s.max_img]]
        if not wins:
            return 0, 0
        stream = np.concatenate(wins, axis=0)
        starts = np.cumsum([0] + [len(w) for w in wins[:-1]])
        win_spans = [(int(st), len(w)) for st, w in zip(starts, wins)]
    win_spans = win_spans[: s.max_img]
    cap = s.max_sub_tokens - 1                 # slot 0 = zero token
    n_tok = min(len(stream), cap)
    out["sub_tokens"][b, 1: 1 + n_tok] = stream[:n_tok]
    if not win_spans:
        return 0, 0
    n = len(win_spans)
    n_over = native.fill_sub_windows(win_spans, s.max_sub_l, n_tok,
                                     out["sub_win_idx"][b, :n],
                                     out["sub_mask"][b, :n])
    return n, n_over


def expand_sub_windows(arrays):
    """The expanded (B, Li, Ls, De) ``sub_bert`` rebuilt on the host from a
    sub_dedup batch's ``sub_tokens`` and ``sub_win_idx`` (JAX
    batching.py:316), for consumers of the reference layout.  Exact: padded
    slots index the zero token."""
    tok = np.asarray(arrays["sub_tokens"])
    idx = np.asarray(arrays["sub_win_idx"])
    b, li, ls = idx.shape
    flat = tok[np.arange(b)[:, None], idx.reshape(b, -1)]
    return flat.reshape(b, li, ls, tok.shape[-1])

"""Synthetic TVQA+-shaped data (the port's copy of
``tvqaplus_tpu/data/synthetic.py``): ``SyntheticTVQADataset`` gives the
same examples from the same seed, index for index; ``CachedDataset`` and
``SharedVideoDataset`` are the serving measurement's adapters.

For tests, debug runs and benchmarks.

Serves the role of the reference's ``--debug`` 100-video subset
(run_main.sh:22-27) in an environment without the ~30 GB feature artifacts:
generates examples with the exact ragged structure the real loaders produce,
at realistic shapes, with an optional *planted signal* so training runs can
demonstrate convergence:

* the correct answer's BERT token embeddings share a low-rank component with
  the in-span subtitle/video features;
* the GT temporal span is where that component is strongest;
* attention labels mark the regions carrying the component.
"""
from __future__ import annotations

import numpy as np

from tvqaplus_tpu_torch.data.labels import densify_att_labels


class CachedDataset:
    """A dataset's examples made once, up front, so a measurement times the
    system (collate, upload, device, prediction assembly) and not the
    generator; production serving reads precomputed features, which this
    models more honestly than per-item synthesis."""

    def __init__(self, ds):
        self._ds = ds
        self.examples = [ds[i] for i in range(len(ds))]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        return self.examples[i]

    def set_mode(self, mode):
        # the mode changes the examples: make them again if it changes
        if mode != getattr(self._ds, "mode", mode):
            self._ds.set_mode(mode)
            self.examples = [self._ds[i] for i in range(len(self._ds))]

    def __getattr__(self, name):
        # everything else (mode, max_annotated_frames, ...) is the wrapped
        # dataset's
        return getattr(self._ds, name)


class SharedVideoDataset:
    """QA examples that share clips as the real dataset's do: TVQA+ has
    about 7 QAs per clip and its splits iterate in clip order, which
    batch-level video dedup (``Config.video_dedup``) exploits.  Example
    ``i`` takes every video-level field from its group leader
    ``(i // qas_per_video) * qas_per_video`` and keeps its own QA fields,
    with its span label and boxes clamped to the leader clip's frames.  The
    QA annotations lose their planted alignment with the clip: for
    throughput and format runs, not training-quality tests."""

    _VIDEO_FIELDS = ("vid_name", "sub_bert", "sub_tokens", "sub_win_spans",
                     "vfeat", "image_indices")

    def __init__(self, ds, qas_per_video=7):
        self._ds = ds
        self.g = max(1, qas_per_video)

    def __len__(self):
        return len(self._ds)

    def set_mode(self, mode):
        self._ds.set_mode(mode)

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __getitem__(self, i):
        ex = dict(self._ds[i])
        lead_i = (i // self.g) * self.g
        if lead_i != i:
            lead = self._ds[lead_i]
            for k in self._VIDEO_FIELDS:
                if k in lead:
                    ex[k] = lead[k]
            n_img = len(lead["image_indices"])
            st, ed = ex["ts_label"]
            ed = min(ed, n_img - 1)
            ex["ts_label"] = [min(st, ed), ed]
            ex["boxes"] = ex["boxes"][:n_img]
        return ex


class SyntheticTVQADataset:
    """Generates reference-structured examples deterministically by index."""

    def __init__(self, cfg, n_examples=256, mode="train", planted_signal=True,
                 seed=None):
        self.cfg = cfg
        self.n = n_examples
        self.mode = mode
        self.inference = mode == "test"
        self.planted = planted_signal
        self.seed = cfg.seed if seed is None else seed
        self.bert_dim = cfg.embedding_size
        self.vfeat_dim = cfg.vfeat_size
        self.num_region = cfg.num_region
        self.max_img = cfg.max_num_img
        # shared low-rank "concept" dictionary for the planted signal
        master = np.random.default_rng(self.seed)
        self.n_concepts = 16
        self.concept_bert = master.standard_normal(
            (self.n_concepts, self.bert_dim)).astype(np.float32)
        self.concept_vid = master.standard_normal(
            (self.n_concepts, self.vfeat_dim)).astype(np.float32)

    def __len__(self):
        return self.n

    def set_mode(self, mode):
        self.mode = mode
        self.inference = mode == "test"

    def max_annotated_frames(self):
        """Serving sizes its grounding-window gather from this (the
        ``InferenceRunner`` asks every dataset for it); synthetic examples
        annotate every sampled frame from index 0."""
        return self.max_img

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.default_rng(
            (self.seed, {"train": 1, "valid": 2, "test": 3}[self.mode], index))
        n_img = int(rng.integers(min(4, self.max_img), self.max_img + 1))
        q_l = int(rng.integers(min(3, cfg.max_q_l), cfg.max_q_l + 1))
        a_ls = rng.integers(min(2, cfg.max_a_l), cfg.max_a_l + 1, size=5)
        target = int(rng.integers(0, 5))
        concept = int(rng.integers(0, self.n_concepts))
        st = int(rng.integers(0, n_img))
        ed = int(rng.integers(st, n_img))

        sig_b = self.concept_bert[concept]
        sig_v = self.concept_vid[concept]

        def bert_tokens(n, planted=False):
            x = rng.standard_normal((n, self.bert_dim)).astype(np.float32)
            if planted and self.planted:
                x = x + 2.0 * sig_b
            return x

        qas, qas_bert = [], []
        q_ids = rng.integers(3, 1000, size=q_l)
        q_bert = bert_tokens(q_l, planted=True)
        for a in range(5):
            a_ids = rng.integers(3, 1000, size=int(a_ls[a]))
            qas.append(np.concatenate([q_ids, a_ids]).tolist())
            qas_bert.append(np.concatenate(
                [q_bert, bert_tokens(int(a_ls[a]), planted=(a == target))], axis=0))

        # subtitle SENTENCE STREAM + aligned windows, mirroring the real
        # pipeline (tvqa_dataset.py:164-185): one token stream per video,
        # each frame's window = the 2 nearest sentences (consecutive), so
        # adjacent frames share sentences — the structure sub_dedup exploits.
        video_len_s = n_img * 2.0                      # 0.5 fps grid
        n_sent = max(2, int(video_len_s / 3.5) + 1)
        sent_times = np.sort(rng.uniform(0.0, video_len_s, size=n_sent))
        sent_toks = []
        for si in range(n_sent):
            n_tok = int(rng.integers(4, 17))
            x = rng.standard_normal((n_tok, self.bert_dim)).astype(np.float32)
            # planted signal rides sentences whose start time falls in the
            # GT span (frames st..ed cover [st*2, (ed+1)*2) seconds)
            if self.planted and st * 2.0 <= sent_times[si] < (ed + 1) * 2.0:
                x = x + 2.0 * sig_b
            sent_toks.append(x)
        sent_starts = np.cumsum([0] + [len(t) for t in sent_toks])
        sub_tokens = np.concatenate(sent_toks, axis=0)
        sub_bert, sub_win_spans = [], []
        for i in range(n_img):
            t_frame = (i + 0.5) * 2.0
            s0 = int(np.argmin(np.abs(sent_times - t_frame)))
            lo, hi = (s0 - 1, s0) if (s0 > 0 and (
                s0 == n_sent - 1
                or abs(sent_times[s0 - 1] - t_frame)
                <= abs(sent_times[s0 + 1] - t_frame))) else (s0, min(
                    s0 + 1, n_sent - 1))
            start = int(sent_starts[lo])
            length = min(int(sent_starts[hi + 1]) - start, cfg.max_sub_l)
            sub_win_spans.append((start, length))
            sub_bert.append(sub_tokens[start: start + length])

        region_cnts = rng.integers(5, self.num_region + 1, size=n_img)
        vfeat, att_imgs = [], []
        n_words = q_l + int(a_ls[target]) + 1
        for i in range(n_img):
            cnt = int(region_cnts[i])
            x = rng.standard_normal((cnt, self.vfeat_dim)).astype(np.float32)
            att = np.zeros((n_words, cnt), dtype=np.float32)
            if self.planted and st <= i <= ed:
                pos_region = int(rng.integers(0, cnt))
                x[pos_region] = x[pos_region] + 2.0 * sig_v
                pos_word = int(rng.integers(0, max(1, n_words - 1)))
                att[pos_word, pos_region] = 1.0
            vfeat.append(x)
            att_imgs.append(att)

        att_dense = densify_att_labels(
            att_imgs, anno_st_idx=0, num_img=min(n_img, cfg.max_num_img),
            num_words=cfg.max_qa_l, num_region=self.num_region)

        image_indices = (np.arange(n_img) * 6 + 3).tolist()  # 1-indexed-ish
        boxes = [[[float(rng.integers(0, 320)), float(rng.integers(0, 180)),
                   float(rng.integers(320, 640)), float(rng.integers(180, 360))]
                  for _ in range(int(region_cnts[i]))] for i in range(n_img)]

        return {
            "qid": index,
            "vid_name": f"synthetic_{self.mode}_{index:05d}",
            "qas": qas,
            "qas_bert": qas_bert,
            "q_l": q_l,
            "sub_bert": sub_bert,
            "sub_tokens": sub_tokens,
            "sub_win_spans": sub_win_spans,
            "vfeat": vfeat,
            "target": target if not self.inference else 999,
            "ts_label": [st, ed],
            # seconds consistent with the grid (first img id 3 -> offset 1s)
            "ts": [st * 2.0 + 1.0, (ed + 1) * 2.0 + 1.0],
            "anno_st_idx": 0,
            "att_labels_dense": att_dense,
            "image_indices": image_indices,
            "boxes": boxes,
        }

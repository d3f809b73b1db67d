"""Reference-format artifact fixture writer (the port's copy of
``tvqaplus_tpu/data/fixtures.py``: the same seed and arguments write the
same files).

Generates a synthetic TVQA+ feature drop in the EXACT on-disk formats the
reference pipeline consumes (reference run_main.sh:5-19):

* ``{train,valid}.json`` — QA lists with qid/vid_name/q/a0..a4/answer_idx/
  ts/bbox (+ precomputed ``q_len``/``a{i}_len``, tvqa_dataset.py:147,158);
* ``sub.json`` — per-video " <eos> "-joined sentences + start times;
* ``qa_bert.h5`` — ``{qid}_q`` / ``{qid}_a{k}`` -> (L, De) token embeddings;
* ``sub_bert.h5`` — ``vid_name`` -> (sum tokens, De) per-video stream;
* ``vid.h5`` — ``vid_name`` -> (sum region counts, Dv) region features;
* ``vcpt.json`` — per-frame boxes/counts/object labels at full frame res;
* ``frm_cnt.json``, ``word2idx.json``, ``eval_object_vocab.json``.

``python -m tvqaplus_tpu_torch.main`` and ``python -m
tvqaplus_tpu_torch.inference`` read them through ``data/tvqa.py``, and
``evaluation/tvqa_metrics.py`` scores the predictions against
``valid.json``.

A planted signal (shared low-rank component between the correct answer's
tokens, the in-span subtitle/video features, and the GT boxes' regions)
makes short training runs move the metrics, so a run exercises real
learning, not noise.
"""
from __future__ import annotations

import json
import os

import numpy as np

# small object vocabulary for GT boxes / vcpt labels (all single-word,
# evaluator cleans+lowercases labels, eval_tvqa_plus.py:9-10)
OBJECTS = ["cup", "laptop", "book", "phone", "towel", "chair", "desk",
           "plate", "glass", "remote", "pillow", "jacket", "bottle",
           "door", "window", "bag"]
FILLER = ["what", "is", "holding", "doing", "there", "where", "did", "who",
          "the", "a", "on", "in", "say", "look", "that", "this", "why",
          "how", "room", "table"]


def _question(rng, obj):
    return f"what is sheldon holding near the {obj}"


def write_artifacts(root, n_videos=8, qa_per_video=2, frames_per_video=60,
                    bert_dim=768, vfeat_dim=300, num_region=12, seed=0,
                    signal=2.0, split="disjoint"):
    """Write the full artifact set under ``root``; returns the path dict.

    Videos are ``fx_ep{i}_clip{i}`` with ``frames_per_video`` frames at
    3 fps.  Every QA pair gets a GT temporal span and GT boxes (label = an
    object word that also appears in the correct answer) on the 0.5 fps
    grid images inside the span — the structure the attention loss and the
    grounding evaluator consume.
    """
    import h5py

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    concept = {o: rng.standard_normal(bert_dim).astype(np.float32)
               for o in OBJECTS}
    concept_v = {o: rng.standard_normal(vfeat_dim).astype(np.float32)
                 for o in OBJECTS}

    vids = {f"fx_ep{i}_clip{i}": frames_per_video for i in range(n_videos)}
    sub, vcpt, frm_cnt = {}, {}, {}
    train_qa, valid_qa = [], []
    qa_bert = {}
    sub_bert = {}
    vid_feat = {}
    qid = 1000

    for vi, (vid, n_frames) in enumerate(vids.items()):
        frm_cnt[vid] = n_frames
        dur = n_frames / 3.0
        # subtitles: sentences every ~3.5 s
        n_sent = max(2, int(dur / 3.5))
        times = np.sort(rng.uniform(0, dur, n_sent)).tolist()
        sents = [" ".join(rng.choice(FILLER, rng.integers(4, 10)))
                 for _ in range(n_sent)]
        sub[vid] = {"sub_text": " <eos> ".join(sents), "sub_time": times}
        stream = rng.standard_normal(
            (sum(len(s.split()) for s in sents), bert_dim)).astype(np.float32)

        # vcpt regions per frame
        counts = rng.integers(max(2, num_region - 4), num_region + 1,
                              size=n_frames)
        boxes, objects = [], []
        for c in counts:
            boxes.append([[float(x), float(y), float(x + w), float(y + h)]
                          for x, y, w, h in zip(
                              rng.uniform(0, 500, c), rng.uniform(0, 260, c),
                              rng.uniform(40, 140, c),
                              rng.uniform(40, 100, c))])
            objects.append(list(rng.choice(OBJECTS, c)))
        feats = rng.standard_normal(
            (int(counts.sum()), vfeat_dim)).astype(np.float32)

        # QA pairs over this video — distinct answer objects so the
        # span-conditional signals of co-hosted QAs don't alias; distractor
        # answers and question objects exclude ALL of this video's QA
        # objects (their concepts live in the shared video features, so a
        # colliding distractor would look video-supported)
        qa_objs = rng.choice(OBJECTS, size=qa_per_video, replace=False)
        other = [o for o in OBJECTS if o not in set(qa_objs)]
        # per-QA QUESTION objects (distinct within the video): the temporal
        # signal is planted in the question object's concept, keeping span
        # learnability orthogonal to answer discrimination (a dense
        # answer-concept video signal measurably degrades QA learning —
        # the model leans on the noisy video match instead of the clean
        # answer-token match)
        q_objs = rng.choice(other, size=qa_per_video, replace=False)
        for k in range(qa_per_video):
            qid += 1
            obj = str(qa_objs[k])
            qobj = str(q_objs[k])
            ans_idx = int(rng.integers(0, 5))
            answers = [f"a {str(rng.choice(other))}" for _ in range(5)]
            answers[ans_idx] = f"a {obj}"
            q = _question(rng, qobj)
            # GT spans SNAPPED to the 0.5 fps slot grid so the ts LABEL and
            # the prediction-seconds map agree.  The reference uses two
            # different slot conventions (replicated here): get_ts_label
            # searchsorts 3*seconds against 0-indexed frame numbers 6k+2
            # (slot k "at" 2k+0.667 s, tvqa_dataset.py:242-252), while
            # spans_to_seconds maps slot k back to [2k+1, 2k+3]
            # (inference.py:38-42).  A GT span must sit where BOTH place
            # slots [a, b]: st in (2a-1.33, 2a+0.667], ed in
            # [2b+0.667, 2b+2.667) — off-grid or exactly-on-image-time
            # spans land one slot off in the label, capping the reachable
            # temporal IoU and making the e2e bars chaotic (a perfectly
            # memorized model measured miou 0.077: every span exactly one
            # slot late).  st=2a+0.6 / ed=2b+2.6 give a perfectly
            # memorized model IoU 0.82 (1 slot) - 0.875 (2 slots).
            b_max = max(1, int((dur - 2.61) // 2))
            a_slot = int(rng.integers(0, b_max))
            b_slot = min(b_max, a_slot + int(rng.integers(1, 3)))
            st_s = 2.0 * a_slot + 0.6
            ed_s = 2.0 * b_slot + 2.6
            # grid images (1-indexed, interval 6, phase 3) inside the span
            grid = [i for i in range(3, n_frames + 1, 6)]
            span_imgs = [i for i in grid if st_s * 3 <= i <= ed_s * 3] or \
                [min(grid, key=lambda g: abs(g - st_s * 3))]
            bbox = {}
            offsets = np.cumsum([0] + counts.tolist())
            # span-conditional TEMPORAL signal: every region of every
            # in-span frame carries the QUESTION object's concept, so the
            # residual temporal predictor has a learnable start/end
            # boundary (the st/ed CE of reference stage.py:549-555 needs
            # per-frame separability, not just the single GT-box region
            # the grounding loss uses).  Question-conditional, NOT
            # answer-conditional — see q_objs above.
            for fi in range(n_frames):
                if st_s * 3.0 <= fi + 1 <= ed_s * 3.0:
                    feats[offsets[fi]:offsets[fi + 1]] += \
                        0.5 * signal * concept_v[qobj]
            # GT boxes: pick an existing vcpt region per span image, relabel
            # it to the answer object, plant the signal in its features
            for img_id in span_imgs:
                fi = img_id - 1
                ri = int(rng.integers(0, counts[fi]))
                objects[fi][ri] = obj
                feats[offsets[fi] + ri] += signal * concept_v[obj]
                x1, y1, x2, y2 = boxes[fi][ri]
                bbox[str(img_id)] = [{
                    "img_id": img_id, "label": obj, "top": y1, "left": x1,
                    "width": x2 - x1, "height": y2 - y1}]
            # plant the answer-token signal
            q_toks = rng.standard_normal(
                (len(q.split()), bert_dim)).astype(np.float32)
            # answer concept keys the QA signal; question-object concept
            # keys the temporal signal (matches the in-span video regions)
            qa_bert[f"{qid}_q"] = (q_toks + 0.5 * signal * concept[obj]
                                   + 0.5 * signal * concept[qobj])
            for a in range(5):
                t = rng.standard_normal(
                    (len(answers[a].split()), bert_dim)).astype(np.float32)
                if a == ans_idx:
                    t = t + signal * concept[obj]
                qa_bert[f"{qid}_a{a}"] = t
            # in-span subtitle sentences get the signal too
            tok_starts = np.cumsum([0] + [len(s.split()) for s in sents])
            for si, t0 in enumerate(times):
                if st_s - 2.0 <= t0 <= ed_s + 2.0:
                    stream[tok_starts[si]: tok_starts[si + 1]] += \
                        0.5 * signal * concept[obj]

            entry = {
                "qid": qid, "vid_name": vid, "q": q,
                **{f"a{a}": answers[a] for a in range(5)},
                "q_len": len(q.split()),
                **{f"a{a}_len": len(answers[a].split()) for a in range(5)},
                "answer_idx": ans_idx, "ts": [st_s, ed_s], "bbox": bbox,
            }
            if split == "overlap":
                # MEMORIZATION split (pipeline-regression teeth): the tail
                # videos' QAs appear in BOTH sets, so small CPU runs can
                # assert high bars on seen data instead of noise-dominated
                # few-QA generalization (that role belongs to the
                # full-dims harness, scripts/ref_eval_e2e.py --full)
                train_qa.append(entry)
                if vi >= n_videos - max(1, n_videos // 4):
                    valid_qa.append(entry)
            else:
                (valid_qa if vi >= n_videos - max(1, n_videos // 4)
                 else train_qa).append(entry)

        sub_bert[vid] = stream
        vid_feat[vid] = feats
        vcpt[vid] = {"counts": counts.tolist(), "boxes": boxes,
                     "object": objects}

    paths = {
        "train_path": os.path.join(root, "train.json"),
        "valid_path": os.path.join(root, "valid.json"),
        "sub_path": os.path.join(root, "sub.json"),
        "frm_cnt_path": os.path.join(root, "frm_cnt.json"),
        "vcpt_path": os.path.join(root, "vcpt.json"),
        "qa_bert_path": os.path.join(root, "qa_bert.h5"),
        "sub_bert_path": os.path.join(root, "sub_bert.h5"),
        "vfeat_path": os.path.join(root, "vid.h5"),
        "word2idx_path": os.path.join(root, "word2idx.json"),
        "eval_object_vocab_path": os.path.join(root,
                                               "eval_object_vocab.json"),
    }
    for key, table in (("train_path", train_qa), ("valid_path", valid_qa),
                       ("sub_path", sub), ("frm_cnt_path", frm_cnt),
                       ("vcpt_path", vcpt)):
        _dump(table, paths[key])
    for h5_path, table in ((paths["qa_bert_path"], qa_bert),
                           (paths["sub_bert_path"], sub_bert),
                           (paths["vfeat_path"], vid_feat)):
        with h5py.File(h5_path, "w") as h5:
            for k, v in table.items():
                h5[k] = v
    words = ["<pad>", "<unk>", "<eos>"] + OBJECTS + FILLER + ["sheldon",
                                                              "near"]
    _dump({w: i for i, w in enumerate(words)}, paths["word2idx_path"])
    _dump(OBJECTS, paths["eval_object_vocab_path"])
    return paths


def _dump(data, path):
    with open(path, "w") as f:
        json.dump(data, f)


def gt_as_prediction(gt_path, out_path):
    """Convert a GT json into the evaluator's *prediction* format (the
    ``--no_preproc_pred`` input: the structure
    ``evaluation.tvqa_metrics.load_tvqa_plus_annotation`` returns,
    eval_tvqa_plus.py:149-171): the evaluator's documented ≈1.0 self-check
    (reference eval/readme.txt:9-18)."""
    with open(gt_path) as f:
        gt = json.load(f)
    ts_answer, bbox = {}, {}
    for e in gt:
        ts_answer[str(e["qid"])] = [e["ts"], int(e["answer_idx"])]
        for frm_id, box_list in e["bbox"].items():
            key = "{}_{}_{:05d}".format(e["vid_name"], int(e["qid"]),
                                        int(frm_id))
            bbox.setdefault(key, []).extend(
                [[b["label"].lower(), 1.0,
                  [b["left"], b["top"], b["left"] + b["width"],
                   b["top"] + b["height"]]] for b in box_list])
    _dump({"ts_answer": ts_answer, "bbox": bbox}, out_path)
    return out_path

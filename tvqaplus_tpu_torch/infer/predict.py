"""Inference: ``{mode}_inference_predictions.json`` in the reference
evaluator's format (port of ``tvqaplus_tpu/infer/predict.py``).

Answer choice, the greedy best-span scan over all five answers and the
grounding compaction (threshold, ascending stable sort, per-row counts) run
on the device; the host turns the compacted rows into records with two
slices each (``assemble_att_predictions``).  ``eval_steps_per_dispatch``
same-bucket batches go to the device at once (dispatch.py): one CUDA-graph
replay on ``cuda``.

On a mesh (``mesh``, parallel/mesh.py) each data row serves its rows of
every global ``test_bsz`` batch and assembles their records; the rows'
records are gathered over the data group and merged in global row order,
so every rank holds the single-process predictions (rank 0 writes them,
inference.py).  The global batch decides the Li bucket, so ``li_total`` is
the same on every rank.  Under a ctx axis each rank runs the step on its
frames and the model gathers the whole Li before its head
(models/stage.py), with the raw vid scores the grounding reads; the span
search and the grounding compaction then run on every ctx rank alike.  On
a model axis the runner places the model (``place_model``: its large
dense weights split by columns).
"""
from __future__ import annotations

import torch

from tvqaplus_tpu_torch import dispatch, resolve_device
from tvqaplus_tpu_torch.data.pipeline import DataPipeline
from tvqaplus_tpu_torch.models import spans
from tvqaplus_tpu_torch.ops.masking import safe_softmax
from tvqaplus_tpu_torch.parallel import mesh as dp

# grounding-record acceptance threshold (reference stage.py:787-804)
SCORE_THD = 0.2


def spans_to_seconds(st, ed, first_img_id, py2_offset_div=False,
                     frame_interval=6):
    """Span grid indices -> seconds (reference inference.py:68-72)."""
    step = frame_interval / 3
    if py2_offset_div:
        offset = (first_img_id % frame_interval) // 3
    else:
        offset = (first_img_id % frame_interval) / 3
    return [st * step + offset, (ed + 1) * step + offset]


def assemble_att_predictions(sc_sorted, idx_sorted, n_acc, n_valid, words,
                             object_word_ids, qids, vid_names, img_indices,
                             boxes, start_indices, li_total):
    """Grounding records (reference get_att_prediction, stage.py:748-806)
    from the device-compacted rows, per (example, answer, window frame,
    word): sc_sorted / idx_sorted (B, 5, F, Lqa, Lr) scores ascending with
    invalid regions as +inf at the tail and their region indices; n_acc
    (B, 5, F, Lqa) accepted counts; n_valid (B, F) valid-region counts.
    The accepted entries are the last ``n_acc`` of the first ``n_valid``
    sorted positions.  A frame whose box count differs from its valid-region
    count keeps only indices below the box count."""
    object_word_ids = set(int(w) for w in object_word_ids)
    att_predictions = []
    for b in range(len(sc_sorted)):
        start_idx = int(start_indices[b])
        ex_boxes = boxes[b] or []
        frames = []
        for img_local in range(len(ex_boxes)):
            img_global = img_local + start_idx
            if img_global >= li_total:
                continue
            cur = ex_boxes[img_local]
            frames.append((img_local, int(img_indices[b][img_global]), cur,
                           len(cur), int(n_valid[b, img_local])))
        q_preds = {}
        for ans_idx in range(5):
            q_preds[ans_idx] = []
            obj_words = [(wi, int(w))
                         for wi, w in enumerate(words[b][ans_idx].tolist())
                         if w in object_word_ids]
            if not obj_words or not frames:
                continue
            sc_a, ix_a = sc_sorted[b, ans_idx], idx_sorted[b, ans_idx]
            na_a = n_acc[b, ans_idx]
            for img_local, img_id, cur_img_boxes, n_boxes, nv in frames:
                for word_idx, w in obj_words:
                    n = int(na_a[img_local, word_idx])
                    ix = ix_a[img_local, word_idx, nv - n:nv]
                    sc = sc_a[img_local, word_idx, nv - n:nv]
                    if n_boxes != nv:
                        keep = ix < n_boxes
                        ix, sc = ix[keep], sc[keep]
                    q_preds[ans_idx].append({
                        "pred": sc.tolist(),
                        "bbox": [cur_img_boxes[i] for i in ix],
                        "word": w,
                        "qid": int(qids[b]),
                        "vid_name": vid_names[b],
                        "img_idx": img_id,
                    })
        att_predictions.append(q_preds)
    return att_predictions


def grounding_compaction(raw, vid_mask, anno_st, f_max):
    """Threshold + ascending stable sort + counts of the raw vid scores
    (B, A, Li, Lqa, Lr) in the annotated window [anno_st, anno_st + f_max)
    (rows past Li clamp to the last frame; the host guard skips them).
    Returns the ``assemble_att_predictions`` inputs as device tensors."""
    bsz, num_a, li, lqa, lr = raw.shape
    idx = torch.clamp(anno_st.long()[:, None]
                      + torch.arange(f_max, device=raw.device), max=li - 1)
    win = torch.gather(raw, 2, idx[:, None, :, None, None].expand(
        bsz, num_a, f_max, lqa, lr)).float()           # (B, A, F, Lqa, Lr)
    vmask = torch.gather(vid_mask, 1,
                         idx[..., None].expand(bsz, f_max, lr)) > 0
    vm = vmask[:, None, :, None, :]
    masked = torch.where(vm, win, torch.full_like(win, float("inf")))
    scores, order = torch.sort(masked, dim=-1, stable=True)
    return {
        "grd_scores": scores,
        "grd_idx": order.to(torch.int8 if lr <= 127 else torch.int32),
        "grd_nacc": ((win >= SCORE_THD) & vm).sum(-1).to(torch.uint8),
        "grd_nvalid": vmask.sum(-1).to(torch.uint8),
    }


def expand_video_dedup(batch):
    """Per-unique-clip uploads -> per-example arrays, one device gather
    each (JAX infer/predict.py:201-218): ``vid_u`` (U, Li, Lr, Dv),
    ``sub_tokens_u`` (U, St, De) / ``sub_bert_u`` taken at ``ex_vid`` (B,)
    int32.  A batch without ``ex_vid`` comes back as it is."""
    if "ex_vid" not in batch:
        return batch
    batch = dict(batch)
    rows = batch.pop("ex_vid")
    for k in ("vid", "sub_tokens", "sub_bert"):
        if k + "_u" in batch:
            batch[k] = torch.index_select(batch.pop(k + "_u"), 0, rows)
    return batch


class InferenceRunner:
    """Runs the eval-mode model over a dataset split and assembles the
    predictions dict (reference inference.py:38-75).  One dispatch stays in
    flight: dispatch i's device->host copy and record assembly run while
    dispatch i+1 executes on the device.  ``device`` defaults to ``cuda``;
    the model is moved there.  ``mesh``: this rank of a data-parallel
    run."""

    def __init__(self, cfg, model, device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = dp.place_model(mesh, model.to(self.device).eval())
        self.graphs = (dispatch.StepGraphs(self.device)
                       if self.device.type == "cuda" else None)

    @torch.inference_mode()
    def step(self, batch, with_grounding, f_max):
        """The device part of one batch: the dedup expansion, forward,
        answer argmax, span search and (``with_grounding``) the grounding
        compaction."""
        batch = expand_video_dedup(batch)
        out = self.model(batch, need_sub_raw=False,
                         need_vid_raw=with_grounding)
        t_probs = safe_softmax(out["t_scores"].float(), dim=2)
        st, ed, _ = spans.find_max_pair(t_probs[..., 0], t_probs[..., 1])
        result = {"pred_ids": out["answer_scores"].argmax(-1),
                  "span_st": st, "span_ed": ed}
        if with_grounding:
            result.update(grounding_compaction(
                out["vid_raw_s"], dp.gather_ctx(self.mesh, batch["vid_mask"],
                                                1),
                batch["anno_st"], f_max))
        return result

    @torch.inference_mode()
    def dispatch_infer(self, batch, with_grounding, f_max):
        """``step`` over the K batches of a (stacked) batch in one dispatch:
        each output stacked on a leading K axis.  On cuda the outputs are
        a graph's: read (``_to_host``) before the next dispatch."""
        def steps(b):
            outs = [self.step(bi, with_grounding, f_max)
                    for bi in dispatch.unstack(b)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        if self.graphs is None:
            return steps(batch)
        return self.graphs((with_grounding, f_max), steps, batch)

    def _to_host(self, result):
        """Start the device->host copies; returns (host tensors, event)."""
        if self.device.type != "cuda":
            return result, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in result.items()}
        for k, v in result.items():
            host[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def run(self, dataset, mode="valid", object_word_ids=(), debug=False):
        dataset.set_mode(mode)
        pipeline = DataPipeline(
            dataset, self.cfg, self.device, batch_size=self.cfg.test_bsz,
            prefetch_depth=self.cfg.prefetch_depth,
            group=max(1, self.cfg.eval_steps_per_dispatch),
            video_dedup=self.cfg.video_dedup, mesh=self.mesh)
        with_grounding = bool(object_word_ids) and self.cfg.vfeat_flag
        f_max = max(1, int(dataset.max_annotated_frames()))
        chunks = []     # per dispatch, per batch: (ts items, bbox records)

        def collate_host(host, event, meta, li):
            """One dispatch's K batches, batch i with the meta entries
            [i B, (i + 1) B) (only a stack's last batch can be partial)."""
            if event is not None:
                event.synchronize()
            stack = {k: v.numpy() for k, v in host.items()}
            b = stack["pred_ids"].shape[1]
            chunks.append([
                collate_one({k: v[i] for k, v in stack.items()},
                            {k: v[i * b:(i + 1) * b]
                             for k, v in meta.items()}, li)
                for i in range(stack["pred_ids"].shape[0])])

        def collate_one(out, meta, li):
            n = len(meta["qid"])
            bbox = []
            if "grd_scores" in out and any(
                    bx is not None for bx in meta["boxes"]):
                bbox = assemble_att_predictions(
                    out["grd_scores"][:n], out["grd_idx"][:n],
                    out["grd_nacc"][:n], out["grd_nvalid"][:n],
                    meta["qas_words"], object_word_ids, meta["qid"],
                    meta["vid_name"], meta["image_indices"], meta["boxes"],
                    meta["anno_st"], li_total=li)
            ts = []
            for j in range(n):
                a = int(out["pred_ids"][j])
                img_ids = meta["image_indices"][j]
                ts.append((str(meta["qid"][j]), [
                    spans_to_seconds(int(out["span_st"][j, a]),
                                     int(out["span_ed"][j, a]),
                                     img_ids[0] if img_ids else 1,
                                     self.cfg.py2_offset_div,
                                     self.cfg.frame_interval), a]))
            return ts, bbox

        pending = None
        for batch, meta, _ in pipeline:
            # the whole Li (a ctx rank's batch holds its frames)
            li = batch["ts_mask"].shape[-1] * (1 if self.mesh is None
                                               else self.mesh.ctx)
            host, event = self._to_host(self.dispatch_infer(
                batch, with_grounding, min(li, f_max)))
            if pending is not None:
                collate_host(*pending)
            pending = (host, event, meta, li)
            if debug:
                break
        if pending is not None:
            collate_host(*pending)
        # global row order: each dispatch's batches, each batch's rows rank
        # after rank
        predictions = {"ts_answer": {}, "raw_bbox": []}
        ranks = dp.gather_objects(self.mesh, chunks)
        for d, batches in enumerate(chunks):
            for i in range(len(batches)):
                for rank_chunks in ranks:
                    ts, bbox = rank_chunks[d][i]
                    predictions["raw_bbox"].extend(bbox)
                    predictions["ts_answer"].update(ts)
        return predictions

"""STAGE: Spatio-Temporal Answerer with Grounded Evidence (port of
``tvqaplus_tpu/models/stage.py``): the eval and the training forward.

The five answers and the Li frames are batch axes throughout.  Three fused
kernels carry the forward (ops/): ``qa_ctx_attention`` at both attention
sites, ``tri_bridge`` at ``concat_fc`` and the encoder kernel with the
masked word-max at ``cls_encoder``.  The MLP bridges are plain PyTorch, as
the JAX package leaves them to XLA, and so is the k=7 input encoder unless
``merge_input_streams`` is set: then the three streams share one call of
the encoder kernel's full-output mode with a zero mask
(``_merged_input_encode``).  The
kernels are differentiable through their backward kernels (on CUDA) or
through the plain versions (on the CPU), so ``forward(train=True)`` is the
training forward: dropout at every reference site (``drop``, a
``layers.Dropout``) and the GT-anchored proposals.

Under a mesh (parallel/mesh.py ``place_model`` sets ``mesh``) with a ctx axis
the batch holds this rank's frames of Li: the per-frame chain runs on them, and
one all-gather over the ctx group after the cls encoder (``gather_ctx``) hands
the head, the losses and the span search the whole Li, replicated on every ctx
rank; the raw scores a caller asks for are gathered too.  With a model axis
that splits the kernels' weights (hsz >= 256), each forward gathers each of
them whole once, before its first use (``forward``, parallel/mesh.py
``gather_weight``).  Dropout on Li-sharded tensors draws through
``drop.frames``, which folds the ctx rank in; the replicated work (the QA
stream, the per-token subtitle stream, the head) through ``drop``, alike on
every ctx rank of a data row.

Noun masks (the batch's ``qa_noun_masks``) and void vectors
(``non_visual > 0``, the vid site) are not inputs of the fused attention
kernel, in this package as in the JAX one: an attention site that gets
either runs the unfused ``structured_attention`` and ``c2q_down_projection``
instead (``fused_attention`` says which sites do).

Encoders with attention heads (``*_encoder_n_heads > 0``) or another conv
depth than 2 run the plain encoder chain (models/layers.py
``EncoderBlock.fused``), as the JAX package's predicate routes them, and
heads in the input encoder keep its three streams separate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn

from tvqaplus_tpu_torch.models import spans
from tvqaplus_tpu_torch.models.attention import (
    l2_normalize,
    structured_attention,
)
from tvqaplus_tpu_torch.models.layers import (
    ConvLinear,
    DownProjection,
    InputEmbedding,
    LayerNorm,
    LinearWrapper,
    MLPBridge,
    StackedEncoder,
    TriMLPBridge,
    apply_dropout,
    frame_dropout,
    kernel_dropout,
)
from tvqaplus_tpu_torch.ops.masking import mask_logits
from tvqaplus_tpu_torch.ops.qa_ctx_attention import qa_ctx_attention
from tvqaplus_tpu_torch.parallel import mesh as tp
from tvqaplus_tpu_torch.parallel.mesh import gather_ctx


@dataclass(frozen=True)
class ModelConfig:
    """Static model hyper-parameters (the JAX ModelConfig's fields that the
    eval forward reads)."""
    hsz: int = 128
    bridge_hsz: int = 300
    embedding_size: int = 768
    vfeat_size: int = 300
    dropout: float = 0.1
    scale: float = 10.0
    t_iter: int = 0
    t_layer_type: str = "linear"
    extra_span_length: int = 3
    add_local: bool = False
    sub_flag: bool = True
    vfeat_flag: bool = True
    non_visual: int = 0
    add_non_visual: bool = False
    max_num_proposal: int = 1
    input_encoder_n_blocks: int = 1
    input_encoder_n_conv: int = 2
    input_encoder_kernel_size: int = 7
    input_encoder_n_heads: int = 0
    cls_encoder_n_blocks: int = 1
    cls_encoder_n_conv: int = 2
    cls_encoder_kernel_size: int = 5
    cls_encoder_n_heads: int = 0
    compute_dtype: str = "float32"
    merge_input_streams: bool = False

    @classmethod
    def from_config(cls, cfg):
        names = set(cls.__dataclass_fields__) - {"bridge_hsz"}
        return cls(**{n: getattr(cfg, n) for n in names})

    @property
    def dtype(self):
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


class STAGE(nn.Module):

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = cfg
        dt = c.dtype
        if not (c.sub_flag or c.vfeat_flag):
            raise NotImplementedError("need at least one of sub/vfeat streams")
        self.cfg = cfg
        self.bert_word_encoding_fc = MLPBridge(c.embedding_size,
                                               c.bridge_hsz, c.dropout, dt)
        if c.vfeat_flag:
            self.vid_fc = MLPBridge(c.vfeat_size, c.bridge_hsz, c.dropout,
                                    dt)
        if c.sub_flag and c.vfeat_flag:
            self.concat_fc = TriMLPBridge(c.hsz, c.dropout, dt)
        self.input_embedding = InputEmbedding(c.bridge_hsz, c.hsz, c.dropout,
                                              dt)
        # the input encoder goes through the encoder kernel iff the streams
        # are merged (JAX stage.py:139-143); the separate k=7 sites stay
        # plain PyTorch
        self.input_encoder = StackedEncoder(
            c.input_encoder_n_blocks, c.input_encoder_n_conv,
            c.input_encoder_kernel_size, c.input_encoder_n_heads, c.hsz,
            c.dropout, dt, use_kernel=c.merge_input_streams)
        self.c2q_down_projection = DownProjection(3 * c.hsz, c.hsz,
                                                  c.dropout, dt)
        self.cls_encoder = StackedEncoder(
            c.cls_encoder_n_blocks, c.cls_encoder_n_conv,
            c.cls_encoder_kernel_size, c.cls_encoder_n_heads, c.hsz,
            c.dropout, dt)
        self.cls_projection_layers = nn.ModuleList(
            [LinearWrapper(c.hsz, c.hsz, True, c.dropout, dt)]
            + [ConvLinear(c.hsz, c.hsz, 3, c.dropout, dt)
               for _ in range(c.t_iter)])
        self.temporal_scoring_st_layers = nn.ModuleList(
            LinearWrapper(c.hsz, 1, False, c.dropout, dt)
            for _ in range(c.t_iter + 1))
        self.temporal_scoring_ed_layers = nn.ModuleList(
            LinearWrapper(c.hsz, 1, False, c.dropout, dt)
            for _ in range(c.t_iter + 1))
        self.classifier = LinearWrapper(
            2 * c.hsz if c.add_local else c.hsz, 1, False, c.dropout, dt)
        if c.non_visual > 0:
            # learned "no visual evidence" slots appended to the regions
            # (reference context_query_attention.py:51-79), float32
            self.non_visual_vectors = nn.Parameter(
                torch.empty(c.non_visual, c.hsz))
        else:
            self.non_visual_vectors = None
        self._zero_masks = {}
        self._group_maps = {}
        self.mesh = None       # parallel/mesh.py place_model
        self.shards = {}
        self.whole_layers = []

    def head_parameters(self):
        """The parameters after the ctx gather (the temporal heads and the
        classifier): their gradient is whole on every ctx rank."""
        return [p for mod in (self.cls_projection_layers,
                              self.temporal_scoring_st_layers,
                              self.temporal_scoring_ed_layers,
                              self.classifier) for p in mod.parameters()]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Weights drawn from ``generator``: LeCun-normal for every linear
        and conv weight (flax's default), zero biases, unit LayerNorms, and
        normal(0.02) void vectors (JAX stage.py:162-167)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                w = mod.weight
                fan_in = w[0].numel()
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if self.non_visual_vectors is not None:
            self.non_visual_vectors.normal_(0.0, 0.02, generator=generator)
        return self

    # ------------------------------------------------------------------
    def base_encoder(self, data, mask, init_encoder, drop=None):
        """init bridge -> downsize -> stacked conv encoder
        (reference stage.py:350-363); ``mask`` is the stream's, which only
        an encoder with attention heads reads."""
        x = self.input_embedding(init_encoder(data, drop), drop)
        return self.input_encoder(x, drop=drop, mask=mask)

    def _sub_encode(self, batch, drop=None):
        """The subtitle stream's own encoder call: from the per-unique-token
        stream of a sub_dedup batch (bridge and ``input_embedding`` once
        per token, then the window gather), else from ``sub_bert``."""
        if "sub_tokens" not in batch:
            return self.base_encoder(batch["sub_bert"], batch["sub_mask"],
                                     self.bert_word_encoding_fc,
                                     frame_dropout(drop))
        tok = self.input_embedding(
            self.bert_word_encoding_fc(batch["sub_tokens"], drop), drop)
        return self.input_encoder(
            self._gather_sub_windows(tok, batch["sub_win_idx"]),
            drop=frame_dropout(drop), mask=batch["sub_mask"])

    @staticmethod
    def _gather_sub_windows(tok, idx):
        """Frame-aligned subtitle windows from the per-unique-token stream
        (the sub_dedup contract; stage.py:193-195) as an index gather:
        tok (B, St, h), idx (B, Li, Ls) -> (B, Li, Ls, h)."""
        bsz, li, ls = idx.shape
        flat = idx.reshape(bsz, li * ls, 1).long().expand(-1, -1,
                                                          tok.shape[-1])
        return torch.gather(tok, 1, flat).reshape(bsz, li, ls, tok.shape[-1])

    def _merged_input_encode(self, qa_pre, sub_pre, vid_pre, drop=None):
        """One ``input_encoder`` call over the qa/sub/vid streams (JAX
        stage.py:198-229).  The three post-bridge embeddings are zero-padded
        on L to the longest stream and concatenated on the group axis:
        (B, A, Lqa, h) + (B, Li, Ls, h) + (B, Li, Lr, h) ->
        (B, A + 2 Li, Lmax, h).  A static (G, L) zero mask re-zeroes each
        conv's input past a stream's true length, so every tap reads what
        per-stream padding would give and the three slices equal the
        separate calls.  The slices are made contiguous here, once (the
        attention kernel takes contiguous inputs).  Under context
        parallelism the frame groups are this rank's, and the call draws
        through ``drop``, alike on every ctx rank: the QA rows must (they
        are replicated work), and the frame rows key their masks at their
        global frames through the kernel's group map
        (``merged_group_map``), so each takes the mask one process draws
        for it."""
        streams = (qa_pre, sub_pre, vid_pre)
        lmax = max(x.shape[2] for x in streams)
        merged = torch.cat([nn.functional.pad(x, (0, 0, 0, lmax - x.shape[2]))
                            for x in streams], dim=1)
        zm = self.merged_zero_mask(tuple(x.shape[1:3] for x in streams),
                                   merged.device)
        enc = self.input_encoder(
            merged, drop=drop, zero_mask=zm,
            groups=self.merged_group_map(qa_pre.shape[1], sub_pre.shape[1],
                                         merged.device))
        outs, g0 = [], 0
        for x in streams:
            outs.append(enc[:, g0:g0 + x.shape[1], :x.shape[2]].contiguous())
            g0 += x.shape[1]
        return outs

    def merged_group_map(self, num_a, li, device):
        """The merged input encoder's group map under context parallelism
        (ops/encoder.py): the A QA groups as they are, then this rank's li
        sub frames and li vid frames at their global frame indices, over
        A + 2 ctx li groups; None without a ctx axis.  Built once per shape
        and device and kept, as ``merged_zero_mask``."""
        if self.mesh is None or self.mesh.ctx == 1:
            return None
        key = (num_a, li, torch.device(device))
        if key not in self._group_maps:
            whole = li * self.mesh.ctx
            f0 = self.mesh.c * li
            frames = torch.arange(f0, f0 + li)
            gmap = torch.cat([torch.arange(num_a), num_a + frames,
                              num_a + whole + frames]).to(torch.int32)
            with torch.inference_mode(False):
                self._group_maps[key] = (gmap.to(device), num_a + 2 * whole)
        return self._group_maps[key]

    def merged_zero_mask(self, streams, device):
        """The (G, Lmax) float32 zero mask of the merged input encoder for
        streams of (groups, length) ``streams``: 1 where a position lies
        inside its stream's length.  Built once per shape and device and
        kept, so a step copies nothing from the host (a copy from pageable
        memory cannot be captured in a CUDA graph)."""
        key = (streams, torch.device(device))
        if key not in self._zero_masks:
            lmax = max(length for _, length in streams)
            lens = torch.cat([torch.full((groups,), length)
                              for groups, length in streams])
            with torch.inference_mode(False):   # serves training steps too
                self._zero_masks[key] = (torch.arange(lmax)[None, :]
                                         < lens[:, None]).float().to(device)
        return self._zero_masks[key]

    def fused_attention(self, site, batch):
        """Whether the attention site ``site`` ("sub" or "vid") runs the
        fused kernel on ``batch`` (the port's form of JAX's ``kernel_ok``,
        stage.py:248-251): not when the batch carries ``qa_noun_masks``
        (both sites), nor at the vid site with void vectors.  Those inputs
        take the unfused route, the JAX package's own (stage.py:281-303)."""
        return batch.get("qa_noun_masks") is None and not (
            site == "vid" and self.non_visual_vectors is not None)

    def qa_ctx_attention(self, qa_embed, ctx_embed, qa_mask, ctx_mask,
                         need_raw, drop=None, targets=None, fused=True,
                         void=None, noun_mask=None):
        """Structured attention + [qa; att; qa*att] down-projection
        (reference stage.py:365-387): fused (JAX kernel path
        stage.py:250-279) when ``fused``, else through
        ``structured_attention`` with the ``void`` vectors and the
        ``noun_mask`` (JAX stage.py:281-303).  qa_embed (B, A, Lqa, D),
        ctx_embed (B, Li, Lc, D); masks (B, A, Lqa) / (B, Li, Lc).
        ``need_raw``: True (every answer), "target" (the ``targets`` answer
        only) or False.  In training the similarity dropout acts on the
        normalised inputs here and the projection dropout inside the kernel
        (or in ``c2q_down_projection``).  Returns mixed (B, A, Li, Lqa, D),
        its mask (B, A, Li, Lqa), the raw scores (or None) and the
        normalised scores (the unfused route only, else None)."""
        if not fused:
            return self._unfused_attention(qa_embed, ctx_embed, qa_mask,
                                           ctx_mask, need_raw, drop, targets,
                                           void, noun_mask)
        dp = self.c2q_down_projection
        raw_mode = {True: "full", False: "none", "target": "target"}[need_raw]
        cn = apply_dropout(drop, l2_normalize(qa_embed))
        qn = apply_dropout(frame_dropout(drop), l2_normalize(ctx_embed))
        rate, seed = kernel_dropout(frame_dropout(drop))
        out = qa_ctx_attention(
            cn, qa_embed, qn, ctx_embed, qa_mask, ctx_mask, dp[0].weight,
            dp[0].bias, tp.whole_weight(dp[2]).t(), dp[2].bias,
            self.cfg.scale,
            raw_mode, targets, rate, seed)
        mixed, raw = out if raw_mode != "none" else (out, None)
        any_region = (ctx_mask.sum(-1) > 0).float()              # (B, Li)
        mixed_mask = qa_mask[:, :, None, :] * any_region[:, None, :, None]
        return mixed, mixed_mask, raw, None

    def _unfused_attention(self, qa_embed, ctx_embed, qa_mask, ctx_mask,
                           need_raw, drop, targets, void, noun_mask):
        """The JAX package's unfused branch (stage.py:281-303).  In bf16
        the concat promotes to float32 as ``jnp.concatenate`` does (the
        attended sum is float32); ``c2q_down_projection`` casts back."""
        u_a, raw, s_mask, s_norm = structured_attention(
            qa_embed[:, :, None], ctx_embed[:, None], qa_mask[:, :, None],
            ctx_mask[:, None], self.cfg.scale, drop, noun_mask, void,
            self.cfg.add_non_visual)
        qa_b = qa_embed[:, :, None].expand(-1, -1, ctx_embed.shape[1], -1, -1)
        dt = torch.promote_types(qa_b.dtype, u_a.dtype)
        qa_b, u_a = qa_b.to(dt), u_a.to(dt)
        mixed = self.c2q_down_projection(
            torch.cat([qa_b, u_a, qa_b * u_a], dim=-1), frame_dropout(drop))
        mixed_mask = (s_mask.sum(-1) != 0).float()
        if need_raw == "target":
            raw = raw[torch.arange(raw.shape[0], device=raw.device),
                      targets.long()]
        elif not need_raw:
            raw = None
        return mixed, mixed_mask, raw, s_norm

    def forward(self, batch, train=False, need_sub_raw=True,
                need_vid_raw=True, drop=None):
        """See ``_forward``.  Under a model axis that splits the kernels'
        weights, each of them is all-gathered whole once here (both
        attention sites share the attention's), and dropped after."""
        for m in self.whole_layers:
            m.whole = tp.gather_weight(m)
        try:
            return self._forward(batch, train, need_sub_raw, need_vid_raw,
                                 drop)
        finally:
            for m in self.whole_layers:
                m.whole = None

    def _forward(self, batch, train=False, need_sub_raw=True,
                 need_vid_raw=True, drop=None):
        """Forward over a static-shape batch dict of tensors
        (data/batching.py).  ``train`` needs ``drop`` (a
        ``layers.Dropout``; rate 0 for none) and the batch's target and
        span labels.  ``need_vid_raw="target"`` emits ``vid_raw_target_s``
        (B, Li, Lqa, Lr) at the target answer, all the att loss reads.
        Returns answer_scores ((B, P, A) in training with add_local, else
        (B, A)), proposal_weights ((B, P) / (B, 1)), t_scores
        (B, A, Li, 2) and, as asked, sub_raw_s / vid_raw_s
        (B, A, Li, Lqa, Lc), with sub_normalized_s / vid_normalized_s
        beside them from a site that ran unfused (``fused_attention``)."""
        if train and drop is None:
            raise ValueError("a training forward needs drop (layers.Dropout)")
        if not train:
            drop = None
        c = self.cfg
        noun_mask = batch.get("qa_noun_masks")
        out = {}
        # all three streams through one input_encoder call (JAX
        # stage.py:342-367); without sub_dedup batches the flag keeps the
        # separate calls below, through the kernel with no zero mask; so
        # do attention heads in the input encoder, whose mask the merged
        # view would lose (JAX stage.py:336-339)
        merged = (c.merge_input_streams and c.sub_flag and c.vfeat_flag
                  and c.input_encoder_n_heads == 0 and "sub_tokens" in batch)
        sub_embed = vid_embed = None
        if merged:
            qa_pre = self.input_embedding(
                self.bert_word_encoding_fc(batch["qas_bert"], drop), drop)
            tok = self.input_embedding(
                self.bert_word_encoding_fc(batch["sub_tokens"], drop), drop)
            fdrop = frame_dropout(drop)
            vid_pre = self.input_embedding(
                self.vid_fc(l2_normalize(batch["vid"]), fdrop), fdrop)
            a_embed, sub_embed, vid_embed = self._merged_input_encode(
                qa_pre, self._gather_sub_windows(tok, batch["sub_win_idx"]),
                vid_pre, drop)
        else:
            a_embed = self.base_encoder(batch["qas_bert"], batch["qas_mask"],
                                        self.bert_word_encoding_fc, drop)
        a_mask = batch["qas_mask"]
        attended = []
        if c.sub_flag:
            if not merged:
                sub_embed = self._sub_encode(batch, drop)
            mixed, mask, raw, norm = self.qa_ctx_attention(
                a_embed, sub_embed, a_mask, batch["sub_mask"], need_sub_raw,
                drop, fused=self.fused_attention("sub", batch),
                noun_mask=noun_mask)
            attended.append((mixed, mask))
            if need_sub_raw:
                out["sub_raw_s"] = gather_ctx(self.mesh, raw, 2)
                if norm is not None:
                    out["sub_normalized_s"] = gather_ctx(self.mesh, norm, 2)
        if c.vfeat_flag:
            if not merged:
                vid_embed = self.base_encoder(l2_normalize(batch["vid"]),
                                              batch["vid_mask"], self.vid_fc,
                                              frame_dropout(drop))  # :256
            mixed, mask, raw, norm = self.qa_ctx_attention(
                a_embed, vid_embed, a_mask, batch["vid_mask"], need_vid_raw,
                drop, batch.get("target"),
                fused=self.fused_attention("vid", batch),
                void=self.non_visual_vectors, noun_mask=noun_mask)
            attended.append((mixed, mask))
            if need_vid_raw == "target":
                out["vid_raw_target_s"] = gather_ctx(self.mesh, raw, 1)
            elif need_vid_raw:
                out["vid_raw_s"] = gather_ctx(self.mesh, raw, 2)
                if norm is not None:
                    out["vid_normalized_s"] = gather_ctx(self.mesh, norm, 2)
        if len(attended) == 2:
            statement = self.concat_fc(attended[0][0], attended[1][0],
                                       frame_dropout(drop))
            statement_mask = attended[1][1]
        else:
            statement, statement_mask = attended[0]
        scores, weights, t_scores = self.classifier_head_multi_proposal(
            statement, statement_mask, batch, train, drop)
        out["answer_scores"] = scores
        out["proposal_weights"] = weights
        out["t_scores"] = t_scores
        return out

    # ------------------------------------------------------------------
    def residual_temporal_predictor(self, layer_idx, x, drop=None):
        """x += proj(x); score st/ed heads (reference stage.py:469-482)."""
        x = x + self.cls_projection_layers[layer_idx](x, drop)
        st = self.temporal_scoring_st_layers[layer_idx](x, drop)
        ed = self.temporal_scoring_ed_layers[layer_idx](x, drop)
        return x, torch.cat([st, ed], dim=-1)

    def classifier_head_multi_proposal(self, statement, statement_mask,
                                       batch, train=False, drop=None):
        """Answer scoring over (local span + global) pooled statements
        (reference stage.py:484-537).  statement (B, A, Li, Lqa, D);
        statement_mask (B, A, Li, Lqa): this rank's frames under context
        parallelism, gathered into the whole Li after the cls encoder."""
        c = self.cfg
        # encoder + masked word-max in one kernel (stage.py:500-505); with
        # heads the plain chain, the statement mask as the attention mask
        # (JAX stage.py:466-468)
        x = self.cls_encoder(statement, reduce_mask=statement_mask,
                             drop=frame_dropout(drop), mask=statement_mask)
        max_statement_mask = (statement_mask.sum(-1) != 0).float()[..., None]
        ts_mask = batch["ts_mask"]
        if self.mesh is not None and self.mesh.ctx > 1:
            # the whole Li for what reduces over it: the pools, the span
            # scores' softmax and proposals, the losses (one gather of the
            # statement, one of the two masks)
            x = gather_ctx(self.mesh, x, 2)
            masks = gather_ctx(self.mesh, torch.cat(
                [max_statement_mask[..., 0], ts_mask[:, None].float()],
                dim=1), 2)
            max_statement_mask = masks[:, :-1, :, None]
            ts_mask = masks[:, -1]
        bsz, _, num_img, _ = max_statement_mask.shape
        # the reference's ensemble quirk (stage.py:515-516) makes the span
        # scores ALWAYS layer 0's; layers i > 0 only extend the chain
        t0 = stacked = None
        for i in range(c.t_iter + 1):
            x, t = self.residual_temporal_predictor(i, x, drop)
            if i == 0:
                t0, stacked = t, x
        t_scores = mask_logits(t0, ts_mask.reshape(bsz, 1, num_img, 1))
        global_pool = mask_logits(stacked, max_statement_mask).amax(dim=2)
        weights = torch.ones((bsz, 1), dtype=torch.float32,
                             device=t_scores.device)
        if not c.add_local:
            pooled = global_pool
        elif train:
            # GT-anchored proposals from the correct answer's span scores,
            # detached as in the reference (stage.py:408-418, 511-527)
            t_ca = t_scores[torch.arange(bsz, device=t_scores.device),
                            batch["target"].long()].detach()
            st, ed_excl, weights = spans.training_proposals(
                t_ca, batch["ts_st"], batch["ts_ed"],
                max_num_proposal=c.max_num_proposal)
            wmask = spans.expand_window_mask(st, ed_excl, num_img,
                                             extra=c.extra_span_length)
            wmask = wmask[:, :, None, :] * max_statement_mask[:, None, ..., 0]
            local = mask_logits(stacked[:, None], wmask[..., None]).amax(dim=3)
            pooled = torch.cat([local, global_pool[:, None].expand_as(local)],
                               dim=-1)                         # (B, P, A, 2D)
        else:
            st, ed_excl = spans.eval_proposals(t_scores)
            wmask = spans.expand_window_mask(
                st, ed_excl, num_img, extra=c.extra_span_length) \
                * max_statement_mask[..., 0]
            local = mask_logits(stacked, wmask[..., None]).amax(dim=2)
            pooled = torch.cat([local, global_pool], dim=-1)
        scores = self.classifier(pooled, drop)[..., 0]
        return scores, weights, t_scores

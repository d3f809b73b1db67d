"""Weight bridge between the JAX package's flax parameter tree and the
reference PyTorch state_dict, which is the port's own ``state_dict``
(the port's copy of ``tvqaplus_tpu/interop/torch_weights.py``).

Layouts differ only by transposes:
  flax Dense kernel (in, out)     <-> torch Linear weight (out, in)
  flax depthwise (k, D)           <-> torch grouped Conv1d (D, 1, k)
  flax pointwise kernel (in, out) <-> torch Conv1d (out, in, 1)
and the void vectors (non_visual, hsz) keep theirs.

``cfg`` is anything with the Config/ModelConfig attributes vfeat_flag,
sub_flag, t_iter and the encoder block/conv/head counts.

Encoders with attention heads: the JAX block's ``attn_ln`` and ``attn``
{q, k, v, out} map to ``attn_layer_norm`` and ``attn.linears.{0,1,2,3}``
(the Annotated-Transformer order that reference self_attention.py keeps).
These names are the port's own: the JAX package's bridge maps no
attention leaf and no reference checkpoint with heads was at hand, so a
reference ``.pth`` with heads is unverified.

The JAX package's flax checkpoints (``train/state.py`` ``save_checkpoint``
and ``save_params``, msgpack) are read without flax
(``interop/flax_msgpack.py``): ``state_dict_from_flax_checkpoint`` for
the weights, ``adam_state_from_flax`` for the optimizer's moments.
"""
from __future__ import annotations

import numpy as np
import torch

from tvqaplus_tpu_torch.interop import flax_msgpack
from tvqaplus_tpu_torch.parallel.mesh import check_whole

# fixed sinusoid buffers of the reference's encoders: the port recomputes
# them (models/layers.py PositionEncoding), so a reference checkpoint's copy
# is dropped on load
_PE_SUFFIX = "position_encoding.pe"


def _np(x):
    return np.asarray(x)


def _ln_to_sd(sd, prefix, ln):
    sd[f"{prefix}.weight"] = _np(ln["scale"])
    sd[f"{prefix}.bias"] = _np(ln["bias"])


def _ln_from_sd(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _dense_to_sd(sd, prefix, dense):
    sd[f"{prefix}.weight"] = _np(dense["kernel"]).T
    sd[f"{prefix}.bias"] = _np(dense["bias"])


def _dense_from_sd(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _dsconv_to_sd(sd, prefix, p):
    sd[f"{prefix}.depthwise_conv.weight"] = _np(p["depthwise"]).T[:, None, :]
    sd[f"{prefix}.depthwise_conv.bias"] = _np(p["depthwise_bias"])
    sd[f"{prefix}.pointwise_conv.weight"] = \
        _np(p["pointwise"]["kernel"]).T[:, :, None]
    sd[f"{prefix}.pointwise_conv.bias"] = _np(p["pointwise"]["bias"])


def _dsconv_from_sd(sd, prefix):
    return {"depthwise": sd[f"{prefix}.depthwise_conv.weight"][:, 0, :].T,
            "depthwise_bias": sd[f"{prefix}.depthwise_conv.bias"],
            "pointwise": {
                "kernel": sd[f"{prefix}.pointwise_conv.weight"][:, :, 0].T,
                "bias": sd[f"{prefix}.pointwise_conv.bias"]}}


_ATTN = ("q", "k", "v", "out")     # attn.linears.0-3


def _encoder_names(cfg, name):
    n_blocks = getattr(cfg, f"{name}_n_blocks")
    n_conv = getattr(cfg, f"{name}_n_conv")
    n_heads = getattr(cfg, f"{name}_n_heads")
    return [(b, f"{name}.stacked_encoderBlocks.{b}") for b in range(n_blocks)
            ], n_conv, n_heads


def _bridges(cfg):
    names = ["bert_word_encoding_fc"]
    if cfg.vfeat_flag:
        names.append("vid_fc")
    if cfg.vfeat_flag and cfg.sub_flag:
        names.append("concat_fc")
    return names


def _wrappers(cfg):
    """(flax name, state_dict prefix, is_conv_linear) of the LinearWrapper /
    ConvLinear heads."""
    out = [("cls_projection_layers_0", "cls_projection_layers.0", False)]
    out += [(f"cls_projection_layers_{i}", f"cls_projection_layers.{i}",
             True) for i in range(1, cfg.t_iter + 1)]
    for i in range(cfg.t_iter + 1):
        out += [(f"temporal_scoring_st_layers_{i}",
                 f"temporal_scoring_st_layers.{i}", False),
                (f"temporal_scoring_ed_layers_{i}",
                 f"temporal_scoring_ed_layers.{i}", False)]
    return out + [("classifier", "classifier", False)]


def params_from_flax(params, cfg):
    """flax parameter tree (numpy leaves) -> the port's state_dict
    (float32 tensors, reference keys)."""
    sd = {}
    for name in _bridges(cfg):
        p = params[name]
        _ln_to_sd(sd, f"{name}.0", p["ln_in"])
        _dense_to_sd(sd, f"{name}.2", p["fc"])
        _ln_to_sd(sd, f"{name}.4", p["ln_out"])
    ie = params["input_embedding"]
    _dense_to_sd(sd, "input_embedding.1", ie["fc"])
    _ln_to_sd(sd, "input_embedding.3", ie["ln_out"])
    for enc in ("input_encoder", "cls_encoder"):
        blocks, n_conv, n_heads = _encoder_names(cfg, enc)
        for b, tb in blocks:
            blk = params[enc][f"block_{b}"]
            for i in range(n_conv):
                _ln_to_sd(sd, f"{tb}.layer_norm.{i}", blk[f"ln_{i}"])
                _dsconv_to_sd(sd, f"{tb}.conv.{i}", blk[f"conv_{i}"])
            if n_heads:
                _ln_to_sd(sd, f"{tb}.attn_layer_norm", blk["attn_ln"])
                for i, leaf in enumerate(_ATTN):
                    _dense_to_sd(sd, f"{tb}.attn.linears.{i}",
                                 blk["attn"][leaf])
            _ln_to_sd(sd, f"{tb}.final_layer_norm", blk["final_ln"])
    c2q = params["c2q_down_projection"]
    _ln_to_sd(sd, "c2q_down_projection.0",
              {"scale": c2q["ln_scale"], "bias": c2q["ln_bias"]})
    _dense_to_sd(sd, "c2q_down_projection.2", c2q)
    for fname, prefix, is_conv in _wrappers(cfg):
        p = params[fname]
        _ln_to_sd(sd, f"{prefix}.conv.0", p["ln"])
        if is_conv:
            _dsconv_to_sd(sd, f"{prefix}.conv.2", p["conv"])
        else:
            _dense_to_sd(sd, f"{prefix}.conv.2", p["fc"])
    if "non_visual_vectors" in params:          # non_visual > 0
        sd["non_visual_vectors"] = _np(params["non_visual_vectors"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def flax_from_params(state_dict, cfg):
    """The port's (or a reference) state_dict -> flax parameter tree with
    numpy leaves; the inverse of ``params_from_flax``."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in state_dict.items()}
    params = {}
    for name in _bridges(cfg):
        params[name] = {"ln_in": _ln_from_sd(sd, f"{name}.0"),
                        "fc": _dense_from_sd(sd, f"{name}.2"),
                        "ln_out": _ln_from_sd(sd, f"{name}.4")}
    params["input_embedding"] = {
        "fc": _dense_from_sd(sd, "input_embedding.1"),
        "ln_out": _ln_from_sd(sd, "input_embedding.3")}
    for enc in ("input_encoder", "cls_encoder"):
        blocks, n_conv, n_heads = _encoder_names(cfg, enc)
        params[enc] = {}
        for b, tb in blocks:
            blk = {}
            for i in range(n_conv):
                blk[f"ln_{i}"] = _ln_from_sd(sd, f"{tb}.layer_norm.{i}")
                blk[f"conv_{i}"] = _dsconv_from_sd(sd, f"{tb}.conv.{i}")
            if n_heads:
                blk["attn_ln"] = _ln_from_sd(sd, f"{tb}.attn_layer_norm")
                blk["attn"] = {leaf: _dense_from_sd(
                    sd, f"{tb}.attn.linears.{i}")
                    for i, leaf in enumerate(_ATTN)}
            blk["final_ln"] = _ln_from_sd(sd, f"{tb}.final_layer_norm")
            params[enc][f"block_{b}"] = blk
    ln = _ln_from_sd(sd, "c2q_down_projection.0")
    dn = _dense_from_sd(sd, "c2q_down_projection.2")
    params["c2q_down_projection"] = {
        "ln_scale": ln["scale"], "ln_bias": ln["bias"],
        "kernel": dn["kernel"], "bias": dn["bias"]}
    for fname, prefix, is_conv in _wrappers(cfg):
        p = {"ln": _ln_from_sd(sd, f"{prefix}.conv.0")}
        if is_conv:
            p["conv"] = _dsconv_from_sd(sd, f"{prefix}.conv.2")
        else:
            p["fc"] = _dense_from_sd(sd, f"{prefix}.conv.2")
        params[fname] = p
    if "non_visual_vectors" in sd:
        params["non_visual_vectors"] = sd["non_visual_vectors"]
    return params


def reference_state_dict(sd):
    """A reference-format state_dict as the port's: the reference's fixed
    sinusoid buffers are dropped."""
    return {k: v for k, v in sd.items() if not k.endswith(_PE_SUFFIX)}


def load_reference_checkpoint(path):
    """A reference-format ``best_valid.pth`` (a state_dict) as the port's
    state_dict, on the CPU."""
    return reference_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


def _float32_tree(tree):
    """A checkpoint tree's array leaves as float32 numpy (bfloat16 bits
    widened exactly)."""
    if isinstance(tree, dict):
        return {k: _float32_tree(v) for k, v in tree.items()}
    return flax_msgpack.as_float32(tree)


def state_dict_from_flax_tree(tree, cfg):
    """The port's state_dict from a loaded flax checkpoint tree: the
    ``params`` of a ``save_checkpoint`` tree (one with ``state``), else
    the tree itself (a ``save_params`` file)."""
    params = tree["state"]["params"] if "state" in tree else tree
    return params_from_flax(_float32_tree(params), cfg)


def state_dict_from_flax_checkpoint(path, cfg):
    """``state_dict_from_flax_tree`` of a JAX flax checkpoint file."""
    return state_dict_from_flax_tree(flax_msgpack.load(path), cfg)


def adam_state_from_flax(opt_state, cfg, model):
    """torch Adam state from the JAX optimizer state of a
    ``save_checkpoint`` file (optax clip_by_global_norm ->
    inject_hyperparams(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate)): ``{parameter name: {"step", "exp_avg",
    "exp_avg_sq"}}`` for ``model``'s parameters, and the learning rate.
    ``mu`` / ``nu`` go through ``params_from_flax``'s transposes; Adam's
    ``count`` becomes ``step`` (optax corrects the next update's bias with
    count + 1, torch with step + 1)."""
    try:
        inject = opt_state["1"]
        adam = inject["inner_state"]["1"]
        mu, nu, count = adam["mu"], adam["nu"], int(adam["count"])
        lr = float(inject["hyperparams"]["learning_rate"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"not the JAX trainer's optimizer state (clip, "
                         f"then injected Adam): missing {e}") from None
    exp_avg = params_from_flax(_float32_tree(mu), cfg)
    exp_avg_sq = params_from_flax(_float32_tree(nu), cfg)
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(exp_avg):
        raise ValueError(f"the checkpoint's moments do not match the model: "
                         f"{sorted(set(names) ^ set(exp_avg))}")
    return {name: {"step": torch.tensor(float(count)),
                   "exp_avg": exp_avg[name], "exp_avg_sq": exp_avg_sq[name]}
            for name in names}, lr


def flax_checkpoint_tree(model, optimizer, step, extra, cfg):
    """The tree the JAX trainer's ``save_checkpoint`` writes, for ``model``
    and its Adam (``flax_msgpack.dumps`` turns it into the file): the
    inverse of ``adam_state_from_flax`` and ``params_from_flax``, with
    optax's layout of the clip and injected-Adam states and Adam's step as
    both counts.  A model split over a mesh's model axis is written inside
    ``parallel.mesh.full_state``, which makes its weights whole."""
    check_whole(model)
    named = dict(model.named_parameters())
    moments = {k: {name: optimizer.state[p][k] for name, p in named.items()}
               for k in ("exp_avg", "exp_avg_sq")}
    count = np.asarray(int(optimizer.state[next(iter(named.values()))][
        "step"]), np.int32)
    lr = np.asarray(float(optimizer.param_groups[0]["lr"]), np.float32)
    adam = {"count": count, "mu": flax_from_params(moments["exp_avg"], cfg),
            "nu": flax_from_params(moments["exp_avg_sq"], cfg)}
    inject = {"count": count, "hyperparams": {"learning_rate": lr},
              "hyperparams_states": {},
              "inner_state": {"0": {}, "1": adam, "2": {}}}
    return {"extra": dict(extra),
            "state": {"opt_state": {"0": {}, "1": inject},
                      "params": flax_from_params(model.state_dict(), cfg),
                      "step": np.asarray(int(step), np.int32)}}

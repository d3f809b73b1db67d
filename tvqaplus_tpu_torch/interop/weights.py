"""Weight bridge between the JAX package's flax parameter tree and the
reference PyTorch state_dict, which is the port's own ``state_dict``
(the port's copy of ``tvqaplus_tpu/interop/torch_weights.py``).

Layouts differ only by transposes:
  flax Dense kernel (in, out)     <-> torch Linear weight (out, in)
  flax depthwise (k, D)           <-> torch grouped Conv1d (D, 1, k)
  flax pointwise kernel (in, out) <-> torch Conv1d (out, in, 1)
and the void vectors (non_visual, hsz) keep theirs.

``cfg`` is anything with the Config/ModelConfig attributes vfeat_flag,
sub_flag, t_iter and the encoder block/conv counts.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _encoder_names(cfg, name):
    n_blocks = getattr(cfg, f"{name}_n_blocks")
    n_conv = getattr(cfg, f"{name}_n_conv")
    return [(b, f"{name}.stacked_encoderBlocks.{b}") for b in range(n_blocks)
            ], n_conv


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
        blocks, n_conv = _encoder_names(cfg, enc)
        for b, tb in blocks:
            blk = params[enc][f"block_{b}"]
            for i in range(n_conv):
                _ln_to_sd(sd, f"{tb}.layer_norm.{i}", blk[f"ln_{i}"])
                _dsconv_to_sd(sd, f"{tb}.conv.{i}", blk[f"conv_{i}"])
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
        blocks, n_conv = _encoder_names(cfg, enc)
        params[enc] = {}
        for b, tb in blocks:
            blk = {}
            for i in range(n_conv):
                blk[f"ln_{i}"] = _ln_from_sd(sd, f"{tb}.layer_norm.{i}")
                blk[f"conv_{i}"] = _dsconv_from_sd(sd, f"{tb}.conv.{i}")
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


def load_reference_checkpoint(path):
    """A reference-format ``best_valid.pth`` (a state_dict) as the port's
    state_dict, on the CPU; the reference's fixed sinusoid buffers are
    dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.endswith(_PE_SUFFIX)}

"""The port's generator side as the JAX package's serving npz.

``save_serving_npz`` writes the ``v_front`` / ``gen`` / ``post`` state dicts
(unfolded, as training leaves them) in the format of
``vcagan/io/serving_npz.py:33-62``: one compressed npz of the flax trees'
leaves keyed ``params/<mod>/...`` and ``stats/<mod>/...``, fp16, or with
``quantize="q8"`` symmetric int8 with an fp32 scale per output channel (the
last axis of the flax leaf) for params of more than 4096 elements, the
BatchNorm statistics fp16 either way.  ``vcagan_torch.io.weights.
load_serving_npz`` and the JAX package's ``load_serving_npz`` read it.

The port -> flax mapping is that of ``tools/convert_torch_ckpt.py``'s
``convert_visual_front`` / ``convert_decoder`` / ``convert_postnet``
(``:168-252``), kept here in numpy (the port imports nothing outside
itself): conv OIDHW/OIHW/OIW -> DHWIO/HWIO/WIO, dense and GRU (out, in) ->
(in, out), BatchNorm weight/bias/running stats -> scale/bias + mean/var,
the attention ``q``'s input rows from the reference c-major to the JAX
f-major flatten order.  Quantisation is done in the flax layout, so the
scales are per output channel of the JAX leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

GENERATOR_SIDE = ("v_front", "gen", "post")
Tree = Dict[str, Any]


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def _conv(w) -> np.ndarray:  # (O, I, spatial...) -> (spatial..., I, O)
    w = _t(w)
    return w.transpose(*range(2, w.ndim), 1, 0)


def _dense(sd, p: str) -> Tree:
    out = {"kernel": _t(sd[f"{p}.weight"]).T}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def _conv_bias(sd, p: str) -> Tree:
    out = {"kernel": _conv(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def _bn(sd, p: str) -> tuple[Tree, Tree]:
    return ({"scale": _t(sd[f"{p}.weight"]), "bias": _t(sd[f"{p}.bias"])},
            {"mean": _t(sd[f"{p}.running_mean"]), "var": _t(sd[f"{p}.running_var"])})


def _perm_cf_to_fc(c: int, f: int) -> np.ndarray:
    """perm[f*C + c] = c*F + f: the reference (c-major) row of each JAX
    (f-major) row of a flattened (F, C) input."""
    idx = np.arange(c * f)
    return (idx % c) * f + idx // c


def _res_blk(sd, p: str, norms: bool) -> tuple[Tree, Tree]:
    """A generator or postnet residual block: conv1, conv2 (with biases), an
    optional 1x1 shortcut, and in the generator norm1/norm2."""
    params = {conv: _conv_bias(sd, f"{p}.{conv}") for conv in ("conv1", "conv2", "conv1x1")
              if f"{p}.{conv}.weight" in sd}
    stats = {}
    if norms:
        for norm in ("norm1", "norm2"):
            params[norm], stats[norm] = _bn(sd, f"{p}.{norm}")
    return params, stats


def visual_front_tree(sd) -> tuple[Tree, Tree]:
    params = {"stem_conv": {"kernel": _conv(sd["frontend.0.weight"])},
              "stem_act": {"alpha": _t(sd["frontend.2.weight"])}, "fc": _dense(sd, "fc")}
    stats = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "frontend.1")
    resnet_p, resnet_s = {}, {}
    for stage in range(1, 5):
        for block in range(2):
            p, name = f"resnet.layer{stage}.{block}", f"layer{stage}_{block}"
            bp, bs = {}, {}
            for i in (1, 2):
                bp[f"conv{i}"] = {"kernel": _conv(sd[f"{p}.conv{i}.weight"])}
                bp[f"bn{i}"], bs[f"bn{i}"] = _bn(sd, f"{p}.bn{i}")
                bp[f"act{i}"] = {"alpha": _t(sd[f"{p}.relu{i}.weight"])}
            if f"{p}.downsample.0.weight" in sd:
                bp["down_conv"] = {"kernel": _conv(sd[f"{p}.downsample.0.weight"])}
                bp["down_bn"], bs["down_bn"] = _bn(sd, f"{p}.downsample.1")
            resnet_p[name], resnet_s[name] = bp, bs
    params["resnet"], stats["resnet"] = resnet_p, resnet_s
    gru = {}
    layer = 0
    while f"sentence_encoder.weight_ih_l{layer}" in sd:
        lp = {}
        for suffix, ours in (("", "fwd"), ("_reverse", "bwd")):
            p = f"sentence_encoder.{{}}_l{layer}{suffix}"
            lp[f"{ours}_w_i"] = _t(sd[p.format("weight_ih")]).T
            lp[f"{ours}_w_h"] = _t(sd[p.format("weight_hh")]).T
            lp[f"{ours}_b_i"] = _t(sd[p.format("bias_ih")])
            lp[f"{ours}_b_h"] = _t(sd[p.format("bias_hh")])
        gru[f"l{layer}"] = lp
        layer += 1
    params["sentence_encoder"] = gru
    return params, stats


def decoder_tree(sd, base_bins: int = 20) -> tuple[Tree, Tree]:
    params, stats = {}, {}
    for stage in ("decode", "g1", "g2", "g3"):
        for i in range(3):
            params[f"{stage}_{i}"], stats[f"{stage}_{i}"] = _res_blk(sd, f"{stage}.{i}", True)
    for att, f_dim in (("att1", base_bins), ("att2", 2 * base_bins)):
        a = {name: _dense(sd, f"{att}.{name}") for name in ("k", "v", "mel")}
        q = _dense(sd, f"{att}.q")
        c_dim = q["kernel"].shape[0] // f_dim
        a["q"] = {"kernel": q["kernel"][_perm_cf_to_fc(c_dim, f_dim)], "bias": q["bias"]}
        params[att] = a
    for i in (1, 2):
        params[f"attconv{i}"] = _conv_bias(sd, f"attconv{i}")
    for i in (1, 2, 3):
        norm_p, norm_s = _bn(sd, f"to_mel{i}.0")
        params[f"to_mel{i}"] = {"norm": norm_p, "conv": _conv_bias(sd, f"to_mel{i}.2")}
        stats[f"to_mel{i}"] = {"norm": norm_s}
    return params, stats


def postnet_tree(sd) -> tuple[Tree, Tree]:
    params = {"conv_in": _conv_bias(sd, "postnet.0"),
              "conv_out": {"kernel": _conv(sd["postnet.6.weight"])}}
    stats = {}
    params["bn_in"], stats["bn_in"] = _bn(sd, "postnet.1")
    for i, idx in enumerate((3, 4, 5), start=1):
        params[f"res{i}"], _ = _res_blk(sd, f"postnet.{idx}", False)
    return params, stats


TREES = {"v_front": visual_front_tree, "gen": decoder_tree, "post": postnet_tree}


def _leaves(tree: Tree, path: str):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{path}/{key}")
        else:
            yield f"{path}/{key}", value


def serving_leaves(states, quantize: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The npz's entries for the ``v_front`` / ``gen`` / ``post`` state dicts
    of ``states`` (other modules are left out)."""
    if quantize not in (None, "q8"):
        raise ValueError(f"quantize={quantize!r}: None or 'q8'")
    flat: Dict[str, np.ndarray] = {}
    for mod in GENERATOR_SIDE:
        params, stats = TREES[mod](states[mod])
        for kind, tree in (("params", params), ("stats", stats)):
            for key, leaf in _leaves(tree, f"{kind}/{mod}"):
                arr = np.asarray(leaf, np.float32)
                if quantize == "q8" and kind == "params" and arr.size > 4096:
                    scale = np.max(np.abs(arr), axis=tuple(range(arr.ndim - 1)))
                    scale = np.maximum(scale, 1e-12) / 127.0
                    flat["q8:" + key] = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
                    flat["q8s:" + key] = scale.astype(np.float32)
                else:
                    flat[key] = arr.astype(np.float16)
    return flat


def save_serving_npz(states, path: str, quantize: Optional[str] = None) -> None:
    """Write the generator side of ``states`` (``{"v_front": state_dict,
    "gen": ..., "post": ...}``, unfolded; e.g. ``modules.state_dicts()``)
    as the JAX package's serving npz, compressed."""
    np.savez_compressed(path, **serving_leaves(states, quantize))

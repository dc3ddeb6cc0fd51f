"""Weights the benchmark hands to both sides.

``serving_states`` reads the trained generator side from a serving npz
(flat ``params/<module>/...`` and ``stats/<module>/...`` leaves in the flax
layout, fp16 or int8 with a float32 scale a output channel) into float32
state dicts under the reference's parameter names, which are the
program's.  ``seeded_states`` draws all seven modules' weights on the
device from a seed, in one normal and one uniform call.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from benchmark.reference import model

States = Dict[str, Dict[str, torch.Tensor]]


def _tree(path: str):
    trees = {"params": {}, "stats": {}}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("q8s:"):
                continue
            name = key[3:] if key.startswith("q8:") else key
            arr = z[key].astype(np.float32)
            if key.startswith("q8:"):
                arr = arr * z["q8s:" + name]
            kind, *parts = name.split("/")
            node = trees[kind]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arr
    return trees["params"], trees["stats"]


def _conv(w):  # (spatial..., I, O) -> (O, I, spatial...)
    return w.transpose(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))


def _cf_rows(c: int, f: int) -> np.ndarray:
    """For each c-major row c*F + f of a flattened (C, F) map, its f-major row."""
    idx = np.arange(c * f)
    return (idx % f) * c + idx // f


def _put_bn(sd, prefix, p, s):
    sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
               f"{prefix}.running_mean": s["mean"], f"{prefix}.running_var": s["var"],
               f"{prefix}.num_batches_tracked": np.zeros((), np.int64)})


def _put_conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _put_dense(sd, prefix, p, rows=None):
    k = p["kernel"] if rows is None else p["kernel"][rows]
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = k.T, p["bias"]


def _visual_front(p, s):
    sd = {}
    _put_conv(sd, "frontend.0", p["stem_conv"])
    _put_bn(sd, "frontend.1", p["stem_bn"], s["stem_bn"])
    sd["frontend.2.weight"] = p["stem_act"]["alpha"]
    for name, bp in p["resnet"].items():
        bs, prefix = s["resnet"][name], "resnet." + name.replace("_", ".")
        for i in (1, 2):
            _put_conv(sd, f"{prefix}.conv{i}", bp[f"conv{i}"])
            _put_bn(sd, f"{prefix}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
            sd[f"{prefix}.relu{i}.weight"] = bp[f"act{i}"]["alpha"]
        if "down_conv" in bp:
            _put_conv(sd, f"{prefix}.downsample.0", bp["down_conv"])
            _put_bn(sd, f"{prefix}.downsample.1", bp["down_bn"], bs["down_bn"])
    for layer, lp in p["sentence_encoder"].items():
        for ours, sfx in (("fwd", ""), ("bwd", "_reverse")):
            k = layer[1:]
            sd[f"sentence_encoder.weight_ih_l{k}{sfx}"] = lp[f"{ours}_w_i"].T
            sd[f"sentence_encoder.weight_hh_l{k}{sfx}"] = lp[f"{ours}_w_h"].T
            sd[f"sentence_encoder.bias_ih_l{k}{sfx}"] = lp[f"{ours}_b_i"]
            sd[f"sentence_encoder.bias_hh_l{k}{sfx}"] = lp[f"{ours}_b_h"]
    _put_dense(sd, "fc", p["fc"])
    return sd


def _decoder(p, s):
    sd = {}
    for stage in ("decode", "g1", "g2", "g3"):
        for i in range(3):
            bp, bs = p[f"{stage}_{i}"], s[f"{stage}_{i}"]
            for conv in ("conv1", "conv2", "conv1x1"):
                if conv in bp:
                    _put_conv(sd, f"{stage}.{i}.{conv}", bp[conv])
            for norm in ("norm1", "norm2"):
                _put_bn(sd, f"{stage}.{i}.{norm}", bp[norm], bs[norm])
    for att, f in (("att1", 20), ("att2", 40)):
        ap = p[att]
        c = ap["q"]["kernel"].shape[0] // f
        _put_dense(sd, f"{att}.q", ap["q"], rows=_cf_rows(c, f))
        for dense in ("k", "v", "mel"):
            _put_dense(sd, f"{att}.{dense}", ap[dense])
    for i in (1, 2):
        _put_conv(sd, f"attconv{i}", p[f"attconv{i}"])
    for i in (1, 2, 3):
        _put_bn(sd, f"to_mel{i}.0", p[f"to_mel{i}"]["norm"], s[f"to_mel{i}"]["norm"])
        _put_conv(sd, f"to_mel{i}.2", p[f"to_mel{i}"]["conv"])
    return sd


def _postnet(p, s):
    sd = {}
    _put_conv(sd, "postnet.0", p["conv_in"])
    _put_bn(sd, "postnet.1", p["bn_in"], s["bn_in"])
    for i, idx in enumerate((3, 4, 5), start=1):
        for conv in ("conv1", "conv2", "conv1x1"):
            if conv in p[f"res{i}"]:
                _put_conv(sd, f"postnet.{idx}.{conv}", p[f"res{i}"][conv])
    sd["postnet.6.weight"] = _conv(p["conv_out"]["kernel"])
    return sd


def serving_states(path: str) -> States:
    """The serving npz's unfolded v_front, gen and post as float32 CPU
    tensors."""
    p, s = _tree(path)
    states = {"v_front": _visual_front(p["v_front"], s["v_front"]),
              "gen": _decoder(p["gen"], s["gen"]), "post": _postnet(p["post"], s["post"])}
    return {m: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
            for m, sd in states.items()}


def seeded_states(names, widths: model.Widths, seed: int, device) -> States:
    """Weights for the modules of ``names`` drawn on ``device``: every
    convolution and dense kernel normal with std 1 / sqrt(fan_in) and bias
    0, the GRU's weights and biases uniform in +-1 / sqrt(hidden),
    BatchNorm 1 / 0 with statistics 0 / 1, PReLU slopes 0.25.  All kernels
    come from one normal draw and the GRU from one uniform draw of a CUDA
    (or CPU) generator seeded with ``seed``."""
    modules = model.build(names, widths)
    kernels, grus, states = [], [], {}
    for name, mod in modules.items():
        sd = states[name] = {}
        for mname, m in mod.named_modules():
            pre = f"{mname}." if mname else ""
            for pname, p in m.named_parameters(recurse=False):
                key = pre + pname
                if isinstance(m, model.BiGRU):
                    grus.append((name, key, p.shape, 1.0 / math.sqrt(m.hidden)))
                elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                    sd[key] = torch.full(p.shape, 1.0 if pname == "weight" else 0.0, device=device)
                elif isinstance(m, nn.PReLU):
                    sd[key] = torch.full(p.shape, 0.25, device=device)
                elif pname == "bias":
                    sd[key] = torch.zeros(p.shape, device=device)
                else:
                    kernels.append((name, key, p.shape, 1.0 / math.sqrt(p[0].numel())))
            for bname, buf in m.named_buffers(recurse=False):
                val = {"running_var": 1.0}.get(bname, 0.0)
                sd[pre + bname] = torch.full(buf.shape, val, dtype=buf.dtype, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    for draws, fill in ((kernels, "normal"), (grus, "uniform")):
        flat = torch.empty(sum(math.prod(s) for _, _, s, _ in draws), device=device)
        if fill == "normal":
            flat.normal_(generator=gen)
        else:
            flat.uniform_(-1.0, 1.0, generator=gen)
        at = 0
        for name, key, shape, scale in draws:
            n = math.prod(shape)
            states[name][key] = flat[at:at + n].view(shape) * scale
            at += n
    return states

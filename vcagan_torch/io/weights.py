"""Weights from the JAX package's formats into the port's state dicts.

``from_jax`` maps numpy flax trees of the generator side (``v_front``,
``gen``, ``post``) and, where the trees hold them, of the discriminators
(``dis1..3``, ``s_dis``) onto the port's modules, whose state-dict keys are
the reference PyTorch names that ``tools/convert_torch_ckpt.py`` reads; the
converter's ``convert_visual_front/decoder/postnet/discriminator/
sync_discriminator`` are its exact inverse.
``asr_from_jax`` does the same for the ASR models, the inverse of
``convert_grid_asr`` / ``convert_lrw_asr``.
Layouts: conv HWIO/DHWIO/WIO -> OIHW/OIDHW/OIW (the audio fronts'
time-major kernels (W, H, I, O) -> OIHW), dense (in, out) -> (out, in),
GRU (in, 3H) -> (3H, in), BatchNorm scale/bias + mean/var -> weight/bias +
running stats, and the input rows of the attention ``q`` and of the audio
fronts' ``Linear`` from the JAX f-major to the reference c-major flatten
order.  Trees folded by the JAX package's
``fold_generator_side`` (no paired BatchNorm nodes, a ``bias`` on their
convolutions, empty ``v_front``/``post`` statistics) give the folded state
dicts, the same that ``vcagan_torch/nn/fold.py`` makes of the unfolded ones.

``load_serving_npz`` reads the flat ``params/<mod>/...`` and
``stats/<mod>/...`` file of ``vcagan/io/serving_npz.py`` (fp16 leaves, or
int8 ``q8:`` leaves with fp32 per-output-channel ``q8s:`` scales), and, as
that reader does (``:101-103``), raises on a leaf that no module reads.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vcagan_torch.nn.discriminator import PHASE_BLOCKS

Tree = Dict[str, Any]


def _conv(w) -> np.ndarray:  # (spatial..., I, O) -> (O, I, spatial...)
    w = np.asarray(w)
    return w.transpose(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))


def _conv_swapped(w) -> np.ndarray:  # time-major (W, H, I, O) -> (O, I, H, W)
    return np.asarray(w).transpose(3, 2, 1, 0)


def _linear(w) -> np.ndarray:  # (in, out) -> (out, in)
    return np.asarray(w).T


def _perm_cf_to_fc(c: int, f: int) -> np.ndarray:
    """perm[f*C + c] = c*F + f: the reference (c-major) row of each JAX
    (f-major) row of a flattened (F, C) input."""
    idx = np.arange(c * f)
    return (idx % c) * f + idx // c


def _bn(sd: Dict, prefix: str, p: Tree, s: Tree) -> None:
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]
    sd[f"{prefix}.running_mean"] = s["mean"]
    sd[f"{prefix}.running_var"] = s["var"]
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_bias(sd: Dict, prefix: str, p: Tree, conv=_conv) -> None:
    sd[f"{prefix}.weight"] = conv(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _conv_then_bn(sd: Dict, conv: str, bn: str, p: Tree, s: Tree, conv_name: str,
                  bn_name: str) -> None:
    """A convolution and the BatchNorm after it; a folded tree has no
    BatchNorm node and carries the affine in the convolution's bias."""
    _conv_bias(sd, conv, p[conv_name])
    if bn_name in p:
        _bn(sd, bn, p[bn_name], s[bn_name])


def _dense(sd: Dict, prefix: str, p: Tree, rows=None) -> None:
    kernel = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = _linear(kernel if rows is None else kernel[rows])
    sd[f"{prefix}.bias"] = p["bias"]


def _gru(sd: Dict, prefix: str, p: Tree) -> None:
    """A BiGRU's layers ``l{k}`` -> ``nn.GRU`` keys (``_reverse``: backward)."""
    for layer, lp in p.items():
        k = layer[1:]
        for ours, suffix in (("fwd", ""), ("bwd", "_reverse")):
            sd[f"{prefix}.weight_ih_l{k}{suffix}"] = _linear(lp[f"{ours}_w_i"])
            sd[f"{prefix}.weight_hh_l{k}{suffix}"] = _linear(lp[f"{ours}_w_h"])
            sd[f"{prefix}.bias_ih_l{k}{suffix}"] = lp[f"{ours}_b_i"]
            sd[f"{prefix}.bias_hh_l{k}{suffix}"] = lp[f"{ours}_b_h"]


def _gen_res_blk(sd: Dict, prefix: str, p: Tree, s: Tree) -> None:
    for conv in ("conv1", "conv2", "conv1x1"):
        if conv in p:
            _conv_bias(sd, f"{prefix}.{conv}", p[conv])
    for norm in ("norm1", "norm2"):
        _bn(sd, f"{prefix}.{norm}", p[norm], s[norm])


def visual_front_state(p: Tree, s: Tree) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _conv_then_bn(sd, "frontend.0", "frontend.1", p, s, "stem_conv", "stem_bn")
    sd["frontend.2.weight"] = p["stem_act"]["alpha"]
    for name, bp in p["resnet"].items():  # layer{stage}_{block}
        bs = s.get("resnet", {}).get(name, {})
        prefix = "resnet." + name.replace("_", ".")
        for i in (1, 2):
            _conv_then_bn(sd, f"{prefix}.conv{i}", f"{prefix}.bn{i}", bp, bs,
                          f"conv{i}", f"bn{i}")
            sd[f"{prefix}.relu{i}.weight"] = bp[f"act{i}"]["alpha"]
        if "down_conv" in bp:
            _conv_then_bn(sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1", bp, bs,
                          "down_conv", "down_bn")
    _gru(sd, "sentence_encoder", p["sentence_encoder"])
    _dense(sd, "fc", p["fc"])
    return sd


def attention_state(p: Tree, f_dim: int) -> Dict[str, np.ndarray]:
    """One AVAttention: k, v, mel as they are, q's input rows from the JAX
    f-major to the reference c-major order."""
    sd: Dict[str, np.ndarray] = {}
    c_dim = np.asarray(p["q"]["kernel"]).shape[0] // f_dim
    _dense(sd, "q", p["q"], rows=np.argsort(_perm_cf_to_fc(c_dim, f_dim)))
    for dense in ("k", "v", "mel"):
        _dense(sd, dense, p[dense])
    return sd


def decoder_state(p: Tree, s: Tree, base_bins: int = 20) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for stage in ("decode", "g1", "g2", "g3"):
        for i in range(3):
            name = f"{stage}_{i}"
            _gen_res_blk(sd, f"{stage}.{i}", p[name], s[name])
    for att, f_dim in (("att1", base_bins), ("att2", 2 * base_bins)):
        sd.update({f"{att}.{k}": v for k, v in attention_state(p[att], f_dim).items()})
    for i in (1, 2):
        _conv_bias(sd, f"attconv{i}", p[f"attconv{i}"])
    for i in (1, 2, 3):
        head = f"to_mel{i}"
        _bn(sd, f"{head}.0", p[head]["norm"], s[head]["norm"])
        _conv_bias(sd, f"{head}.2", p[head]["conv"])
    return sd


def postnet_state(p: Tree, s: Tree) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _conv_then_bn(sd, "postnet.0", "postnet.1", p, s, "conv_in", "bn_in")
    for i, idx in enumerate((3, 4, 5), start=1):
        for conv in ("conv1", "conv2", "conv1x1"):
            if conv in p[f"res{i}"]:
                _conv_bias(sd, f"postnet.{idx}.{conv}", p[f"res{i}"][conv])
    sd["postnet.6.weight"] = _conv(p["conv_out"]["kernel"])
    return sd


def discriminator_state(p: Tree, phase: str) -> Dict[str, np.ndarray]:
    """One mel discriminator (norm-free, no statistics)."""
    sd: Dict[str, np.ndarray] = {}
    _conv_bias(sd, "main.0", p["conv_in"])
    for i in range(PHASE_BLOCKS[phase]):
        for conv in ("conv1", "conv2", "conv1x1"):
            if conv in p[f"block{i}"]:
                _conv_bias(sd, f"main.{i + 1}.{conv}", p[f"block{i}"][conv])
    _conv_bias(sd, "uncond.1", p["uncond_conv"])
    _dense(sd, "uncond.4", p["uncond_out"])
    _conv_bias(sd, "cond.1", p["cond_conv1"])
    _conv_bias(sd, "cond.3", p["cond_conv2"])
    _dense(sd, "cond.6", p["cond_out"])
    return sd


def audio_front_state(p: Tree, s: Tree, prelu_block: bool = False) -> Dict[str, np.ndarray]:
    """An audio front (``vcagan_torch/nn/audio_front.py``; the sync critic's
    encoder): time-major kernels back to the reference (freq, time) layout,
    the projection's rows back to the c-major flatten of (C, F), C the
    second convolution's output channels.  ``prelu_block``: the block's
    activations are PReLUs with slopes (the GRID ASR front), not ReLUs."""
    sd: Dict[str, np.ndarray] = {}
    for i, (conv, bn, act) in enumerate((("conv1", "bn1", "act1"), ("conv2", "bn2", "act2"))):
        _conv_bias(sd, f"frontend.{3 * i}", p[conv], _conv_swapped)
        _bn(sd, f"frontend.{3 * i + 1}", p[bn], s[bn])
        sd[f"frontend.{3 * i + 2}.weight"] = p[act]["alpha"]
    for i in (1, 2):
        _conv_bias(sd, f"Res_block.0.conv{i}", p["res"][f"conv{i}"], _conv_swapped)
        _bn(sd, f"Res_block.0.bn{i}", p["res"][f"bn{i}"], s["res"][f"bn{i}"])
        if prelu_block:
            sd[f"Res_block.0.relu{i}.weight"] = p["res"][f"act{i}"]["alpha"]
    c_dim = np.asarray(p["conv2"]["kernel"]).shape[-1]
    f_dim = np.asarray(p["proj"]["kernel"]).shape[0] // c_dim
    _dense(sd, "Linear", p["proj"], rows=np.argsort(_perm_cf_to_fc(c_dim, f_dim)))
    return sd


class _ReadTree(dict):
    """A weight tree that adds the path of every leaf read from it to
    ``read`` (subtrees are wrapped the same way)."""

    def __init__(self, tree: Tree, path: str, read: set):
        super().__init__({
            key: _ReadTree(value, f"{path}/{key}", read) if isinstance(value, dict) else value
            for key, value in tree.items()
        })
        self._path, self._read = path, read

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if not isinstance(value, dict):
            self._read.add(f"{self._path}/{key}")
        return value


def _leaf_paths(tree: Tree, path: str):
    """The ``path/...`` names of every leaf of a tree."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaf_paths(value, f"{path}/{key}")
        else:
            yield f"{path}/{key}"


def from_jax(params: Tree, batch_stats: Tree,
             read: set | None = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{v_front, gen, post} numpy flax trees, unfolded or folded, and those
    of dis1..3 and s_dis where ``params`` has them -> the port's state dicts,
    unfolded or folded.  ``read``: a set that gets the name of every leaf
    read (``params/gen/att1/q/kernel``, ``stats/...``)."""
    if read is not None:
        params = _ReadTree(params, "params", read)
        batch_stats = _ReadTree(batch_stats, "stats", read)
    states = {
        "v_front": visual_front_state(params["v_front"], batch_stats.get("v_front", {})),
        "gen": decoder_state(params["gen"], batch_stats["gen"]),
        "post": postnet_state(params["post"], batch_stats.get("post", {})),
    }
    for phase in "123":
        if f"dis{phase}" in params:
            states[f"dis{phase}"] = discriminator_state(params[f"dis{phase}"], phase)
    if "s_dis" in params:
        # the sync critic: an audio front with a ReLU block
        states["s_dis"] = audio_front_state(params["s_dis"], batch_stats["s_dis"])
    return {mod: as_tensors(sd) for mod, sd in states.items()}


# The ASR models' front has a PReLU block in the GRID recognizer, a ReLU
# block in the LRW classifier (``vcagan/eval/asr_models.py:31-33, 46-48``).
ASR_PRELU_BLOCK = {"grid": True, "lrw": False}


def asr_from_jax(variables: Tree, kind: str) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """A ``GridASR`` (``kind="grid"``) or ``LRWClassifier`` (``"lrw"``) flax
    variables tree ({params, batch_stats}, numpy) -> the port's front and
    back state dicts, the exact inverse of ``convert_grid_asr`` /
    ``convert_lrw_asr`` (``tools/convert_torch_ckpt.py:311-383``).  Raises
    ``KeyError`` naming the leaves that no module reads."""
    if kind not in ASR_PRELU_BLOCK:
        raise ValueError(f"kind {kind!r}: one of {sorted(ASR_PRELU_BLOCK)}")
    read: set = set()
    params = _ReadTree(variables["params"], "params", read)
    stats = _ReadTree(variables["batch_stats"], "stats", read)
    front = audio_front_state(params["audio_front"], stats["audio_front"],
                              prelu_block=ASR_PRELU_BLOCK[kind])
    back: Dict[str, np.ndarray] = {}
    _gru(back, "gru", params["gru"])
    _dense(back, "fc", params["fc"])
    extra = sorted({*_leaf_paths(variables["params"], "params"),
                    *_leaf_paths(variables["batch_stats"], "stats")} - read)
    if extra:
        more = " ..." if len(extra) > 5 else ""
        raise KeyError(f"{kind} ASR variables have unmatched leaves: {extra[:5]}{more}")
    return as_tensors(front), as_tensors(back)


def as_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state dict -> contiguous CPU tensors, for ``load_state_dict``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def read_serving_npz(path: str) -> Tuple[Tree, Tree]:
    """The serving npz as fp32 numpy (params, stats) trees of v_front, gen
    and post, int8 leaves dequantised as ``q * scale``."""
    trees: Dict[str, Tree] = {"params": {}, "stats": {}}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("q8s:"):
                continue
            if key.startswith("q8:"):
                name = key[3:]
                arr = z[key].astype(np.float32) * z["q8s:" + name]
            else:
                name = key
                arr = z[key].astype(np.float32)
            kind, *path_parts = name.split("/")
            node = trees[kind]
            for part in path_parts[:-1]:
                node = node.setdefault(part, {})
            node[path_parts[-1]] = arr
    return trees["params"], trees["stats"]


def load_serving_npz(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The serving npz as the port's state dicts; raises ``KeyError`` naming
    the leaves that no module reads (a ``q8s:`` scale is read with its
    ``q8:`` leaf)."""
    params, stats = read_serving_npz(path)
    read: set = set()
    serving = ("v_front", "gen", "post")  # the file's modules; any other tree is unmatched
    states = from_jax({k: v for k, v in params.items() if k in serving}, stats, read)
    extra = sorted({*_leaf_paths(params, "params"), *_leaf_paths(stats, "stats")} - read)
    if extra:
        more = " ..." if len(extra) > 5 else ""
        raise KeyError(f"{path} has unmatched leaves: {extra[:5]}{more}")
    return states

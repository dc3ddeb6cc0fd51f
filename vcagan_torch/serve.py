"""The serving path: video -> visual front -> decoder -> postnet ->
Griffin-Lim + de-emphasis -> waveform.

The same composition as the JAX package's benchmark path (``bench.py:52-76``
with the modules of ``vcagan/train/models.py:41-81``): the raw postnet
output, swapped to (B, T, 321), is the linear spectrogram that
``MelPipeline.inverse_spec`` vocodes.

``Synthesizer(ModelConfig(use_bfloat16=True))`` is the JAX package's bf16
serving mode (``bench.py:29``, ``VCAGANModules.create(ModelConfig(
use_bfloat16=True))``): parameters fp32, each module computing in the dtype
the JAX module gives it (see ``vcagan_torch/nn``), so ``phon``, ``mel1..3``
and the postnet's output are bf16 and ``sent`` fp32; the spectrogram is
cast to fp32 before Griffin-Lim, which stays fp32 (``bench.py:74``)
unless ``gl_dtype`` says otherwise: on the card the Griffin-Lim kernel
(``vcagan_torch/kernels/griffin_lim.py``), off it the FFT form.  Otherwise
fp32 throughout.

``Synthesizer(fold_bn=True, fused_blocks=True)`` is the counterpart of
``VCAGANModules.create(fold_bn=True, fused_blocks=True)``: the serving
variant whose conv -> BatchNorm pairs are folded at load and whose five
identity-shortcut ResNet blocks each run as one fused kernel launch.

A call is traced (``vcagan_torch.tracing``) as the span ``serve`` and, in
turn, ``serve.inputs``, ``serve.v_front``, ``serve.decoder``,
``serve.postnet`` and ``serve.vocoder`` inside it.
"""

from __future__ import annotations

from typing import Dict

import torch

from vcagan_torch.configs import AudioConfig, ModelConfig
from vcagan_torch.dsp.pipeline import MelPipeline
from vcagan_torch.io.weights import from_jax, load_serving_npz
from vcagan_torch.nn.common import init_like_jax
from vcagan_torch.nn.fold import fold_generator_side
from vcagan_torch.nn.generator import Decoder, Postnet
from vcagan_torch.nn.visual_front import VisualFront
from vcagan_torch.runtime import resolve_device, use_full_fp32
from vcagan_torch.tracing import span


def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()


class Synthesizer:
    """Lip video -> waveform.  Runs on CUDA unless ``device="cpu"`` is
    passed; without weights the modules hold the JAX package's
    initialisation drawn from seed 0 (``init_like_jax``; the folded biases
    0).  ``fold_bn``: eval-only modules with the BatchNorms folded
    into their convolutions; weights are given unfolded and folded once at
    load.  ``fused_blocks`` (needs ``fold_bn``): the trunk's stride-1 blocks
    run as single launches of the fused block kernel.  ``gl_dtype``: the
    compute dtype of Griffin-Lim on the card, None fp32 (``MelPipeline``:
    fp32 vocodes with the Griffin-Lim kernel, bf16 with ``griffin_lim_mxu``)."""

    def __init__(self, config: ModelConfig | None = None, device=None,
                 fold_bn: bool = False, fused_blocks: bool = False,
                 gl_dtype: torch.dtype | None = None):
        if fused_blocks and not fold_bn:
            raise ValueError("fused_blocks requires fold_bn=True (serving mode)")
        self.fold_bn = fold_bn
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.config = config or ModelConfig()
        with torch.random.fork_rng(devices=[]):  # construction draws PyTorch's init
            self.v_front = VisualFront(self.config, fold_bn=fold_bn, fused=fused_blocks)
            self.gen = Decoder(self.config)
            self.post = Postnet(self.config, n_mels=AudioConfig().n_mels, fold_bn=fold_bn)
        generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            init_like_jax(m, generator).to(self.device).eval()
        self.pipe = MelPipeline(gl_dtype=gl_dtype)
        self.generator = torch.Generator(self.device).manual_seed(0)

    def modules(self):
        return (self.v_front, self.gen, self.post)

    def load_state_dicts(self, states: Dict[str, Dict[str, torch.Tensor]]) -> "Synthesizer":
        """Unfolded {v_front, gen, post} state dicts (folded ones pass through
        a folding synthesizer unchanged)."""
        if self.fold_bn:
            states = fold_generator_side(states)
        for name, module in zip(("v_front", "gen", "post"), self.modules()):
            module.load_state_dict(states[name], strict=True)
        return self

    @classmethod
    def from_jax(cls, params, batch_stats, config=None, device=None):
        """Weights from the JAX package's {v_front, gen, post} trees."""
        return cls(config, device).load_state_dicts(from_jax(params, batch_stats))

    @classmethod
    def from_serving_npz(cls, path: str, config=None, device=None,
                         fold_bn: bool = False, fused_blocks: bool = False, gl_dtype=None):
        """Weights from a serving npz (``vcagan/io/serving_npz.py`` format)."""
        synth = cls(config, device, fold_bn, fused_blocks, gl_dtype)
        return synth.load_state_dicts(load_serving_npz(path))

    @torch.inference_mode()
    def __call__(
        self,
        video,
        lengths,
        noise=None,
        init_phase=None,
        generator: torch.Generator | None = None,
    ) -> Dict[str, torch.Tensor]:
        """video (B, T, H, W, 1); lengths (B,) valid frames; ``noise``
        (B, 20, T, 128) and ``init_phase`` (B, 4T, 321) replace the draws
        from ``generator`` (default: this synthesizer's own).

        Returns ``wav`` (B, 160*(4T-1)) and the intermediates ``phon``,
        ``sent`` (B, T, 512), ``mel1..3`` (B, F, T') and ``spec``
        (B, 4T, 321); ``wav`` and ``spec`` are fp32, the others of the
        dtypes the JAX modules give them."""
        gen = self.generator if generator is None else generator
        with span("serve"):
            with span("serve.inputs"):
                video = _tensor(video, self.device, torch.float32)
                lengths = _tensor(lengths, self.device, torch.int32)
                if noise is not None:
                    noise = _tensor(noise, self.device, torch.float32)
                if init_phase is not None:
                    init_phase = _tensor(init_phase, self.device, torch.float32)
            with span("serve.v_front"):
                phon, sent = self.v_front(video)
            with span("serve.decoder"):
                mel1, mel2, mel3 = self.gen(sent, phon, lengths, noise=noise, generator=gen)
            with span("serve.postnet"):
                spec = self.post(mel3).transpose(1, 2).float()  # (B, 4T, 321)
            with span("serve.vocoder"):
                wav = self.pipe.inverse_spec(spec, init_phase=init_phase, generator=gen)
        return {
            "wav": wav, "phon": phon, "sent": sent,
            "mel1": mel1, "mel2": mel2, "mel3": mel3, "spec": spec,
        }

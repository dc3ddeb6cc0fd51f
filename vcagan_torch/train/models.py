"""The seven VCA-GAN modules in one bundle, initialised from a seed.

Port of ``vcagan/train/models.py``: v_front / gen / post (the generator
side) and dis1..3 / s_dis (the discriminator side), as the reference builds
them (``train.py:70-76``).  PyTorch modules carry their parameters and
BatchNorm statistics, so the bundle is the state that the JAX package keeps
in its params and batch-stats trees.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import torch
from torch import nn

from vcagan_torch.configs import AudioConfig, ModelConfig
from vcagan_torch.nn.common import init_like_jax
from vcagan_torch.nn.discriminator import Discriminator, SyncDiscriminator
from vcagan_torch.nn.generator import Decoder, Postnet
from vcagan_torch.nn.visual_front import VisualFront

GENERATOR_SIDE = ("v_front", "gen", "post")
DISCRIMINATOR_SIDE = ("dis1", "dis2", "dis3", "s_dis")


@dataclasses.dataclass(frozen=True)
class VCAGANModules:
    v_front: VisualFront
    gen: Decoder
    post: Postnet
    dis1: Discriminator
    dis2: Discriminator
    dis3: Discriminator
    s_dis: SyncDiscriminator

    @classmethod
    def create(cls, config: ModelConfig | None = None, seed: int = 0) -> "VCAGANModules":
        """All seven modules on the CPU, unfolded (the training modules),
        initialised as the JAX package's (``init_like_jax``), drawn from
        ``seed`` alone in module order (the global generator is left as it
        was).  With ``use_bfloat16`` every module
        computes in bf16 where the JAX package's does
        (``vcagan/train/models.py:56-101``); the parameters stay fp32.  The
        folded and fused serving variant is ``Synthesizer``'s."""
        m = config or ModelConfig()
        with torch.random.fork_rng(devices=[]):  # construction draws PyTorch's init
            modules = cls(
                v_front=VisualFront(m),
                gen=Decoder(m),
                post=Postnet(m, n_mels=AudioConfig().n_mels),
                dis1=Discriminator("1", m),
                dis2=Discriminator("2", m),
                dis3=Discriminator("3", m),
                s_dis=SyncDiscriminator(m),
            )
        generator = torch.Generator().manual_seed(seed)
        for _, module in modules.named():
            init_like_jax(module, generator)
        return modules

    def named(self, names: Sequence[str] = GENERATOR_SIDE + DISCRIMINATOR_SIDE
              ) -> Iterator[tuple[str, nn.Module]]:
        for name in names:
            yield name, getattr(self, name)

    def parameters(self, names: Sequence[str]) -> List[nn.Parameter]:
        """The parameters of ``names``' modules, in module order."""
        return [p for _, module in self.named(names) for p in module.parameters()]

    def to(self, device) -> "VCAGANModules":
        for _, module in self.named():
            module.to(device)
        return self

    def train(self, mode: bool = True) -> "VCAGANModules":
        for _, module in self.named():
            module.train(mode)
        return self

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: module.state_dict() for name, module in self.named()}

    def load_state_dicts(self, states: Dict[str, Dict[str, torch.Tensor]]) -> "VCAGANModules":
        """Strict loads of the modules named in ``states`` (e.g. ``from_jax``'s
        output); the others keep their weights."""
        for name, state in states.items():
            getattr(self, name).load_state_dict(state, strict=True)
        return self

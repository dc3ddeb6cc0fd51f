"""Plain PyTorch reference of the serving path: video -> visual front ->
decoder -> postnet -> Griffin-Lim and de-emphasis -> waveform, in eval
mode with the BatchNorms' running statistics, on the inputs and draws the
benchmark hands it."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import dsp


@torch.no_grad()
def forward(mods: Dict[str, torch.nn.Module], video, lengths, noise, init_phase
            ) -> Dict[str, torch.Tensor]:
    phon, sent = mods["v_front"](video)
    mel1, mel2, mel3 = mods["gen"](sent, phon, lengths, noise)
    spec = mods["post"](mel3).transpose(1, 2)
    return {"phon": phon, "sent": sent, "mel1": mel1, "mel2": mel2, "mel3": mel3,
            "spec": spec, "wav": dsp.vocode(spec, init_phase)}

from vcagan_torch.dsp.audio import deemphasis, mel_denormalize, mel_normalize
from vcagan_torch.dsp.griffin_lim import griffin_lim, griffin_lim_mxu
from vcagan_torch.dsp.mel import mel_filterbank
from vcagan_torch.dsp.pipeline import MelPipeline
from vcagan_torch.dsp.stft import STFTParams, istft_complex, stft, stft_magnitude

__all__ = [
    "MelPipeline",
    "STFTParams",
    "deemphasis",
    "griffin_lim",
    "griffin_lim_mxu",
    "istft_complex",
    "mel_denormalize",
    "mel_filterbank",
    "mel_normalize",
    "stft",
    "stft_magnitude",
]

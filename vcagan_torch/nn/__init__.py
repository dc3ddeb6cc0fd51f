from vcagan_torch.nn.attention import AVAttention
from vcagan_torch.nn.audio_front import AudioFront
from vcagan_torch.nn.discriminator import Discriminator, SyncDiscriminator
from vcagan_torch.nn.generator import Decoder, GenResBlk, Postnet, ResBlk1D
from vcagan_torch.nn.gru import BiGRU
from vcagan_torch.nn.losses import gan_loss, r1_penalty
from vcagan_torch.nn.resnet import BasicBlock, ResNetTrunk
from vcagan_torch.nn.visual_front import VisualFront

__all__ = [
    "AVAttention",
    "AudioFront",
    "BasicBlock",
    "BiGRU",
    "Decoder",
    "Discriminator",
    "GenResBlk",
    "Postnet",
    "ResBlk1D",
    "ResNetTrunk",
    "SyncDiscriminator",
    "VisualFront",
    "gan_loss",
    "r1_penalty",
]

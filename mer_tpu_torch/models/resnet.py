"""ResNet18 mel-spectrogram encoder, stage 1c (counterpart of ``mer_tpu/models/resnet.py``).

The reference's extractor is torchvision's resnet18 (no pretrained weights,
its 1000-way fc kept) -> ReLU -> Linear(1000, 300) -> L2 normalise
(audio_mel/model.py:10-23). This module has torchvision's structure and
``state_dict`` names (``resnet18.*``, ``projector.1.*``), so a reference
``best_weights.pth`` loads with ``strict=True`` and ``mer_tpu``'s
``convert_torch_mel_extractor`` reads the port's checkpoints. Input is NCHW
[B, 3, frames, mels]. Convolutions, pooling and BatchNorm are stock PyTorch
(cuDNN on the card), as ``mer_tpu`` leaves them to XLA.

BatchNorm (``bn_mode``): the reference calls ``model.eval()`` before its
training loop and never ``model.train()`` (audio_mel/train.py:231), so its
BatchNorm always normalises with the running statistics and never updates
them. ``"eval"`` (the default) keeps that: the BatchNorm layers stay in eval
mode whatever ``train()`` says. ``"train"`` lets them follow ``train()``.

Under bf16 autocast the projection's output is cast to float32 before the
L2 norm, as ``mer_tpu`` normalises in f32.
"""

from __future__ import annotations

import torch
from torch import nn


class BasicBlock(nn.Module):
    """torchvision BasicBlock: conv3x3-bn-relu-conv3x3-bn + skip, relu."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNet18(nn.Module):
    """torchvision resnet18 topology with its fc head, NCHW."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512, num_classes)
        for m in self.modules():  # torchvision's initialisation
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(self.avgpool(x), 1))


class AudioMelFeatureExtractor(nn.Module):
    """ResNet18 -> ReLU -> Linear(1000, 300) -> L2 normalise in f32."""

    def __init__(self, embedding_size: int = 300, bn_mode: str = "eval"):
        super().__init__()
        if bn_mode not in ("eval", "train"):
            raise ValueError(f"bn_mode must be 'eval' or 'train', got {bn_mode!r}")
        self.embedding_size = embedding_size
        self.bn_mode = bn_mode
        self.resnet18 = ResNet18()
        self.projector = nn.Sequential(nn.ReLU(), nn.Linear(1000, embedding_size))

    def train(self, mode: bool = True) -> "AudioMelFeatureExtractor":
        super().train(mode)
        if self.bn_mode == "eval":
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.projector(self.resnet18(x)).float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def mel_extractor_from_seed(seed: int, bn_mode: str = "eval") -> AudioMelFeatureExtractor:
    """An extractor with torchvision's random initialisation drawn from
    ``seed`` (the global generators are left as they were)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AudioMelFeatureExtractor(bn_mode=bn_mode)

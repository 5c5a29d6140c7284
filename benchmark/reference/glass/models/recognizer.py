"""Text recognizer: a recognizer CNN -> BiLSTM x 2 -> ASTER or CTC decoder.

Counterpart of ``glass_tpu/models/recognizer.py`` with the module names of
the reference ``RecognizerRCNNHeadV3`` (``backbone``, ``encoder.
bilsm_stack.{i}.{rnn,linear}``, ``decoder.recognizer.decoder.*``; the CTC
head's linear is ``decoder.fc``).  ``RECOGNIZER_BACKBONES`` is glass_tpu's
table of recognizer CNNs.  glass_tpu builds CNN_V1_1's parameter tree for
every backbone name (``init_recognizer``), so each CNN here is built with
those shapes and runs the convolutions it is given: CNN_V1_RECT's ``conv1``
is the (2, 1) kernel at stride 1 (output height 7), and CNN_V2's ``conv3``
is one only a checkpoint supplies in glass_tpu.

``aster_decode_greedy`` reproduces ``AttentionRecognitionHead.sample``
including its batch-global early exit: steps are zero-filled only after
*every* row has emitted ``eos`` (index 0, the [GO] token, as in the
reference) at some step.  The rows are the whole fixed-capacity detection
set, invalid rows included, as in glass_tpu.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .context import conv_norm


class CNN_V1_1(nn.Module):
    """[2,1]-strided conv halving the height + residual 3x3 conv (also
    registered as CNN_V1)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.conv1 = conv_norm(channels, channels, (2, 1), (2, 1), 0, relu=True)
        self.conv2 = conv_norm(channels, channels, 3, 1, 1, relu=True)

    def forward(self, x):
        """(N, C, 8, 32) -> (N, C, 4, 32)."""
        x1 = self.conv1(x)
        return self.conv2(x1) + x1


class CNN_V1_RECT(CNN_V1_1):
    """conv1 at stride 1 + residual 3x3 conv (reference
    recognizer_backbone.py:216-266); with glass_tpu's (2, 1) ``conv1``
    kernel, (N, C, 8, 32) -> (N, C, 7, 32)."""

    def __init__(self, channels: int = 256):
        super().__init__(channels)
        self.conv1.stride = (1, 1)


class CNN_V2(CNN_V1_1):
    """[2,1]-strided conv + two residual 3x3 stages (reference
    recognizer_backbone.py:85-164,267-328; also CNN_V2_1)."""

    def __init__(self, channels: int = 256):
        super().__init__(channels)
        self.conv3 = conv_norm(channels, channels, 3, 1, 1, relu=True)

    def forward(self, x):
        x12 = super().forward(x)
        return x12 + self.conv3(x12)


RECOGNIZER_BACKBONES = {
    "CNN_V1_1": CNN_V1_1,
    "CNN_V1": CNN_V1_1,
    "CNN_V1_RECT": CNN_V1_RECT,
    "CNN_V2": CNN_V2,
    "CNN_V2_1": CNN_V2,
    "Identity": lambda channels: nn.Identity(),
}


class BiLSTMLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.rnn = nn.LSTM(channels, channels, bidirectional=True, batch_first=True)
        self.linear = nn.Linear(2 * channels, channels)

    def forward(self, x):
        return L.linear(L.bilstm(x, self.rnn), self.linear.weight, self.linear.bias)


class BiLSTMBlockV2(nn.Module):
    def __init__(self, channels: int = 256, num_layers: int = 2):
        super().__init__()
        self.bilsm_stack = nn.Sequential(*[BiLSTMLayer(channels) for _ in range(num_layers)])

    def forward(self, x):
        """(N, C, H, W) -> (N, W, C): mean over height, then the stack."""
        return self.bilsm_stack(x.mean(dim=2).transpose(1, 2))


class AttentionUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, att_dim: int):
        super().__init__()
        self.sEmbed = nn.Linear(s_dim, att_dim)
        self.xEmbed = nn.Linear(x_dim, att_dim)
        self.wEmbed = nn.Linear(att_dim, 1)


class DecoderUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, y_dim: int, att_dim: int):
        super().__init__()
        self.attention_unit = AttentionUnit(s_dim, x_dim, att_dim)
        self.tgt_embedding = nn.Embedding(y_dim, att_dim)
        self.gru = nn.GRU(x_dim + att_dim, s_dim, batch_first=True)
        self.fc = nn.Linear(s_dim, y_dim)

    def step(self, x, x_proj, state, y_prev):
        """One decode step: (logits (N, V), new state (N, S))."""
        au = self.attention_unit
        s_proj = L.linear(state, au.sEmbed.weight, au.sEmbed.bias)
        v = L.linear(torch.tanh(s_proj[:, None, :] + x_proj), au.wEmbed.weight, au.wEmbed.bias)
        alpha = torch.softmax(v[..., 0], dim=1)
        context = L.einsum("nt,ntc->nc", alpha, x)
        y_emb = self.tgt_embedding.weight.to(x.dtype)[y_prev]
        new_state = L.gru_cell(torch.cat([y_emb, context], dim=-1), state, self.gru)
        return L.linear(new_state, self.fc.weight, self.fc.bias), new_state


class AttentionRecognitionHead(nn.Module):
    def __init__(self, num_classes: int, in_planes: int, s_dim: int, att_dim: int):
        super().__init__()
        self.decoder = DecoderUnit(s_dim, in_planes, num_classes, att_dim)


class ASTERDecoder(nn.Module):
    """ASTER_V2 wrapper; the ``recognizer`` child reproduces the reference's
    ``decoder.recognizer.decoder.*`` names."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        self.recognizer = AttentionRecognitionHead(num_classes, in_channels, in_channels, in_channels)


class CTCDecoder(nn.Module):
    """The CTC head: one linear over every encoder step (blank = index 0)."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, num_classes)


def ctc_logits(decoder: CTCDecoder, x: torch.Tensor) -> torch.Tensor:
    """Encoder states (N, T, C) -> per-step logits (N, T, V)."""
    return L.linear(x, decoder.fc.weight, decoder.fc.bias)


class RecognizerHead(nn.Module):
    """``RECOGNIZER_HEAD.BACKBONE`` (a ``RECOGNIZER_BACKBONES`` name) ->
    BiLSTM encoder -> ``RECOGNIZER_HEAD.DECODER`` ("CTC", else the ASTER
    decoder, as glass_tpu reads it)."""

    def __init__(self, channels: int = 256, vocab: int = 97, backbone: str = "CNN_V1_1",
                 decoder: str = "ASTER_V2"):
        super().__init__()
        if backbone not in RECOGNIZER_BACKBONES:
            raise KeyError(f"RECOGNIZER_HEAD.BACKBONE {backbone!r}; known: {sorted(RECOGNIZER_BACKBONES)}")
        self.backbone = RECOGNIZER_BACKBONES[backbone](channels)
        self.encoder = BiLSTMBlockV2(channels)
        self.ctc = decoder == "CTC"
        self.decoder = CTCDecoder(vocab, channels) if self.ctc else ASTERDecoder(vocab, channels)

    def encode(self, fused: torch.Tensor) -> torch.Tensor:
        """fused (N, C, 8, 32) -> encoder states (N, 32, C)."""
        return self.encoder(self.backbone(fused))

    @property
    def aster(self) -> "DecoderUnit":
        """The ASTER decoder's step module."""
        return self.decoder.recognizer.decoder


def aster_decode_train(decoder: DecoderUnit, x: torch.Tensor, targets: torch.Tensor,
                       num_steps: int) -> torch.Tensor:
    """Teacher-forced decode: logits (N, num_steps, V).  Step 0 feeds token
    0 ([GO]); step i > 0 feeds ``targets[:, i]``, whose encoding carries the
    leading GO slot (the reference's indexing, glass_tpu's
    ``aster_decode_train``)."""
    n = x.shape[0]
    sdim = decoder.gru.weight_hh_l0.shape[1]
    xe = decoder.attention_unit.xEmbed
    x_proj = L.linear(x, xe.weight, xe.bias)
    state = torch.zeros((n, sdim), dtype=x.dtype, device=x.device)
    y_inputs = torch.cat([torch.zeros_like(targets[:, :1]), targets[:, 1:num_steps]], dim=1).long()
    steps = []
    for i in range(num_steps):
        logits, state = decoder.step(x, x_proj, state, y_inputs[:, i])
        steps.append(logits)
    return torch.stack(steps, dim=1)


def aster_decode_greedy(decoder: DecoderUnit, x: torch.Tensor, num_steps: int,
                        eos_index: int = 0, group: int | None = None) -> torch.Tensor:
    """Greedy decode: per-step softmax probabilities (N, num_steps, V).

    Runs all ``num_steps`` steps with no host synchronisation; steps after
    the break produce zero rows.  The break is global over each ``group``
    of consecutive rows (default: all N), once every row of the group has
    emitted eos: the rows of one image, as glass_tpu's decoder under
    ``jax.vmap`` breaks per image.
    """
    n = x.shape[0]
    group = group or max(n, 1)
    sdim = decoder.gru.weight_hh_l0.shape[1]
    xe = decoder.attention_unit.xEmbed
    x_proj = L.linear(x, xe.weight, xe.bias)
    state = torch.zeros((n, sdim), dtype=x.dtype, device=x.device)
    y_prev = torch.zeros((n,), dtype=torch.int64, device=x.device)
    done = torch.zeros((n // group, group), dtype=torch.bool, device=x.device)
    broke = torch.zeros((n // group, 1, 1), dtype=torch.bool, device=x.device)
    steps = []
    for _ in range(num_steps):
        logits, state = decoder.step(x, x_proj, state, y_prev)
        probs = torch.softmax(logits, dim=-1)
        y_prev = torch.argmax(probs, dim=-1)
        grouped = probs.view(n // group, group, probs.shape[-1])
        steps.append(torch.where(broke, torch.zeros_like(grouped), grouped).view(probs.shape))
        done = done | (y_prev == eos_index).view(n // group, group)
        broke = broke | torch.all(done, dim=1)[:, None, None]
    return torch.stack(steps, dim=1)

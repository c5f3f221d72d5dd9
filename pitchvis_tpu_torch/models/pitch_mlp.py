"""Pitch-recognition model: Conv1d + MLP -> 128 MIDI sigmoid outputs.

Port of ``pitchvis_tpu/models/pitch_mlp.py`` (itself the flax port of the
reference's model, pitchvis_train/train.py:67-106): Conv1d(1->16, kernel 5,
stride 2, no padding) -> ReLU -> max-pool 2 -> channel-major flatten ->
Linear(mlp_size) -> ReLU -> [Linear + ReLU + Dropout] * mlp_layers ->
Linear(128) -> sigmoid. The input is a window of T consecutive VQT frames
flattened to (B, 1, T * n_buckets).

The parameters have torch's layouts (``conv.weight`` (16, 1, 5), a Linear
weight (out, in)); ``convert.pitch_mlp_params_from_numpy`` carries a flax
tree across. They are initialised as flax initialises them: lecun-normal
kernels (a normal truncated at two standard deviations, variance 1/fan_in)
and zero biases, drawn on the host from a seeded ``torch.Generator`` and
then moved to the device, so one seed gives the same weights on the CPU and
on the card.

The convolution is a product of the input's stride-2 windows (``unfold``)
with the (5, 16) kernel: ``torch.matmul`` stays f32 under torch's default
``torch.backends.cuda.matmul.allow_tf32 = False``, where ``F.conv1d`` on the
card would run in TF32 under cuDNN's default.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.device import resolve_device

DEFAULT_T = 5
DEFAULT_N_BUCKETS = 7 * 36  # train config: 7 octaves, 36 buckets/octave
N_MIDI = 128
CONV_CHANNELS = 16
CONV_KERNEL = 5
CONV_STRIDE = 2

# flax's truncated_normal initializer divides the std by the std of a unit
# normal truncated to [-2, 2], so that the truncated draw has variance 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def pooled_width(input_bins: int) -> int:
    """Positions after the stride-2 convolution and the 2-wide pool
    (train.py:76-79: O_conv = (L-5)/2 + 1, O_pool = (O_conv-2)/2 + 1)."""
    return ((input_bins - CONV_KERNEL) // CONV_STRIDE + 1) // 2


class PitchMLP(nn.Module):
    def __init__(
        self,
        input_bins: int = DEFAULT_T * DEFAULT_N_BUCKETS,
        mlp_size: int = 1024,
        mlp_layers: int = 2,
        output_size: int = N_MIDI,
        dropout: float = 0.1,
        *,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.input_bins = input_bins
        self.mlp_size = mlp_size
        self.mlp_layers = mlp_layers
        self.output_size = output_size
        self.dropout = dropout
        # made on the meta device, so torch's own initialisation draws nothing
        # from the global generator
        self.conv = nn.Conv1d(1, CONV_CHANNELS, CONV_KERNEL, stride=CONV_STRIDE, device="meta")
        widths = [CONV_CHANNELS * pooled_width(input_bins)] + [mlp_size] * (mlp_layers + 1) + [output_size]
        self.dense = nn.ModuleList(nn.Linear(a, b, device="meta") for a, b in zip(widths[:-1], widths[1:]))
        self.to_empty(device="cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            lecun_normal_(self.conv.weight, CONV_KERNEL, gen)
            self.conv.bias.zero_()
            for layer in self.dense:
                lecun_normal_(layer.weight, layer.in_features, gen)
                layer.bias.zero_()
        self.to(resolve_device(device))

    def logits(self, x: torch.Tensor, *, train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """The last layer's outputs before the sigmoid. x: (B, 1, input_bins)
        or (B, input_bins). Dropout applies only with ``train=True``
        (whatever the module's ``.training``), with masks from ``generator``
        (the global generator when None)."""
        if x.dim() == 3:
            x = x[:, 0]
        if x.shape[-1] != self.input_bins:
            # every layer shape derives from the actual input, so a
            # t_window/n_buckets mismatch would otherwise only surface as a
            # cryptic shape error in the first Linear
            raise ValueError(f"input has {x.shape[-1]} bins, model configured for {self.input_bins}")
        b = x.shape[0]
        # Conv1d(1, 16, k=5, s=2, VALID) as (B, O, 5) windows @ (5, 16)
        w = self.conv.weight[:, 0, :]  # (16, 5)
        h = torch.matmul(x.unfold(-1, CONV_KERNEL, CONV_STRIDE), w.t()) + self.conv.bias
        # max-pool 2 (a trailing odd position is dropped), then ReLU: the two
        # commute, and pooling first halves the ReLU's work
        p = h.shape[1] // 2
        h = torch.relu(h[:, : 2 * p].reshape(b, p, 2, CONV_CHANNELS).amax(dim=2))
        h = h.transpose(1, 2).reshape(b, -1)  # channel-major flatten like torch's Conv1d
        h = torch.relu(self.dense[0](h))
        for layer in self.dense[1:-1]:
            h = torch.relu(layer(h))
            if train and self.dropout > 0.0:
                # flax's Dropout: keep with probability 1 - rate, scale the kept
                keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - self.dropout
                h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        return self.dense[-1](h)

    def forward(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 128) MIDI strengths in (0, 1)."""
        return torch.sigmoid(self.logits(x, train=train, generator=generator))


def apply(model: PitchMLP, params, x: torch.Tensor) -> torch.Tensor:
    """``model``'s forward under ``params`` (a state_dict, as
    ``convert.pitch_mlp_params_from_numpy`` returns it), or under its own
    weights when ``params`` is None: the counterpart of flax's
    ``model.apply(params, x)``. The module is not changed."""
    if params is None:
        return model(x)
    return torch.func.functional_call(model, params, (x,))


def infer_window(params, model: PitchMLP, vqt_frames: torch.Tensor) -> torch.Tensor:
    """Inference hook mirroring ml_system::infer (pitchvis_viewer/src/
    ml_system.rs:24-38): T history frames (B, T, n_buckets) -> (B, 128)
    MIDI base-pitch strengths."""
    b = vqt_frames.shape[0]
    return apply(model, params, vqt_frames.reshape(b, 1, -1))

"""Recurrent operators: LSTM, GRU and the vanilla RNN.

PyTorch counterpart of ``flexflow_tpu/ops/recurrent.py``. Gate orders are
torch's (i, f, g, o for the LSTM; r, z, n for the GRU) and the weights keep
the JAX layout: ``kernel`` (in, gates*H), ``recurrent_kernel``
(H, gates*H), ``bias`` and ``recurrent_bias`` (gates*H,). The input
projection of the whole sequence is one hoisted ``torch.matmul``; a Python
loop over the time steps then runs the body of the JAX op's ``lax.scan``.
Inputs are ``[x]`` or ``[x, h0]`` (``[x, h0, c0]`` for the LSTM), zeros
where a state is not given; the outputs are the sequence (or, without
``return_sequences``, the last hidden state), then the final h (and c)
with ``return_state``.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, OpType
from ..runtime.initializer import DefaultBiasInitializer, DefaultWeightInitializer
from .linear import relu


class _RecurrentBase(Op):
    """Shared shape and weight logic; subclasses give the cell."""

    num_gates = 1
    has_cell_state = False

    def __init__(self, layer, input_shapes):
        super().__init__(layer, input_shapes)
        self.hidden: int = layer.attrs["hidden_size"]
        self.return_sequences: bool = layer.attrs.get("return_sequences", True)
        self.return_state: bool = layer.attrs.get("return_state", False)
        self.batch, self.seq, self.in_dim = input_shapes[0].sizes

    def infer_output_shapes(self):
        dt = self.input_shapes[0].dtype
        state = ((self.batch, self.hidden), dt)
        outs = [((self.batch, self.seq, self.hidden), dt) if self.return_sequences else state]
        if self.return_state:
            outs += [state] * (2 if self.has_cell_state else 1)
        return outs

    def weight_specs(self) -> List[WeightSpec]:
        gh = self.num_gates * self.hidden
        dt = self.input_shapes[0].dtype
        return [
            WeightSpec("kernel", (self.in_dim, gh), dt,
                       self.attrs.get("kernel_initializer") or DefaultWeightInitializer()),
            WeightSpec("recurrent_kernel", (self.hidden, gh), dt,
                       self.attrs.get("recurrent_initializer") or DefaultWeightInitializer()),
            WeightSpec("bias", (gh,), dt, DefaultBiasInitializer(), weight_decay=False),
            WeightSpec("recurrent_bias", (gh,), dt, DefaultBiasInitializer(),
                       weight_decay=False),
        ]

    def _state(self, inputs, i: int) -> torch.Tensor:
        """Input ``i`` (h0 at 1, c0 at 2), or zeros in the input's dtype."""
        x = inputs[0]
        if len(inputs) > i:
            return inputs[i]
        return torch.zeros((x.shape[0], self.hidden), dtype=x.dtype, device=x.device)

    def _pack_outputs(self, hs: List[torch.Tensor], h, c=None):
        outs = [torch.stack(hs, dim=1) if self.return_sequences else h]
        if self.return_state:
            outs.append(h)
            if self.has_cell_state:
                outs.append(c)
        return outs

    def flops(self) -> float:
        return (2.0 * self.batch * self.seq * (self.in_dim + self.hidden)
                * self.num_gates * self.hidden)


@register_op
class LSTM(_RecurrentBase):
    op_type = OpType.LSTM
    num_gates = 4
    has_cell_state = True

    def forward(self, ctx, inputs, weights):
        H = self.hidden
        # hoisted input projection: one (B*S, D) x (D, 4H) product
        xw = (torch.matmul(inputs[0], weights["kernel"]) + weights["bias"]
              + weights["recurrent_bias"])
        wh = weights["recurrent_kernel"]
        h, c = self._state(inputs, 1), self._state(inputs, 2)
        hs = []
        for t in range(xw.shape[1]):
            z = xw[:, t] + h @ wh
            i = torch.sigmoid(z[:, :H])
            f = torch.sigmoid(z[:, H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            o = torch.sigmoid(z[:, 3 * H:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs.append(h)
        return self._pack_outputs(hs, h, c)


@register_op
class GRU(_RecurrentBase):
    """The recurrent bias stays separate: nn.GRU's ``r * (W_hn h + b_hn)``."""

    op_type = OpType.GRU
    num_gates = 3

    def forward(self, ctx, inputs, weights):
        H = self.hidden
        xw = torch.matmul(inputs[0], weights["kernel"]) + weights["bias"]
        wh, bh = weights["recurrent_kernel"], weights["recurrent_bias"]
        h = self._state(inputs, 1)
        hs = []
        for t in range(xw.shape[1]):
            xt = xw[:, t]
            hw = h @ wh + bh
            r = torch.sigmoid(xt[:, :H] + hw[:, :H])
            z = torch.sigmoid(xt[:, H:2 * H] + hw[:, H:2 * H])
            n = torch.tanh(xt[:, 2 * H:] + r * hw[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            hs.append(h)
        return self._pack_outputs(hs, h)


@register_op
class RNN(_RecurrentBase):
    """Elman RNN: h' = act(x Wx + h Wh + b), act tanh (default) or ReLU."""

    op_type = OpType.RNN

    def forward(self, ctx, inputs, weights):
        act = torch.tanh if self.attrs.get("activation", ActiMode.TANH) is ActiMode.TANH \
            else relu
        xw = (torch.matmul(inputs[0], weights["kernel"]) + weights["bias"]
              + weights["recurrent_bias"])
        wh = weights["recurrent_kernel"]
        h = self._state(inputs, 1)
        hs = []
        for t in range(xw.shape[1]):
            h = act(xw[:, t] + h @ wh)
            hs.append(h)
        return self._pack_outputs(hs, h)

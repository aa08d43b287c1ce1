"""Recurrent wake-word classifiers (counterpart of ``howl_tpu/models/rnn.py``):
lstm, seq-lstm, gru and las, on ``nn.LSTM`` and ``nn.GRU``.

The JAX modules run flax cells under ``lax.scan``, which XLA lowers; here
the recurrences are PyTorch's own RNN modules. On a card they take cuDNN's
kernels for float32 weights. PyTorch does not hand bf16 recurrences to
cuDNN (``torch.backends.cudnn.is_acceptable`` is false for bf16 tensors): a
bf16 engine casts the weights as the JAX engine casts its variables
(``inference/config.cast_compute_dtype``) and its recurrences run on
PyTorch's native CUDA RNN, a matrix product and a fused cell kernel a time
step. :func:`recurrence_backend` names the one a tensor takes.

Parameter names are the reference howl torch modules' (``lstm.*`` and
``dnn.*``; gru's ``conv_encoder.*`` and ``lstm_encoder.*``; las's
``encoder.*``, ``attn.*`` and ``fc.*``), the names
``howl_tpu/compat.py`` reads, so a port state dict also loads into the JAX
package through it. The mapping to the JAX tree (``compat.py``):

  * an LSTM is the same cell: torch's gate stack [i, f, g, o] holds the
    flax cell's per-gate kernels, and torch's two biases sum to flax's one
    (the port puts it in ``bias_hh`` and zeros in ``bias_ih``);
  * a GRU is the same cell too: the r and z biases fold into flax's input
    side, and only the candidate keeps two, r multiplying W_hn h + b_hn;
  * carries are torch's: (h, c), each (1, B, H), for an LSTM (flax's is
    (c, h)), h (1, B, H) for a GRU; None starts from zeros;
  * gru and las convolve their (B, C, F, T) features as they come, frequency
    as H and time as W, as the reference modules do;
  * las flattens a frame's conv features channel-major (c * F' + f), the
    reference's order, where flax flattens frequency-major (f * C + c):
    the bridge permutes the input columns of the LSTM's weights.

``lengths`` (true input frames) work as in the JAX modules: an RNN's carry
is the one at the last valid frame (a packed sequence here), gru and las map
the lengths through their convs and pools, and las's attention masks the
frames past them. The sequence outputs past a length differ: zeros from a
packed sequence here, where flax runs on over the padding; las's mask adds
-100 to those frames' scores, so they weigh e^-100 on both sides.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from howl_tpu_torch.models.base import HowlModel, register_model
from howl_tpu_torch.models.cnn import _affine_bn


def recurrence_backend(x: torch.Tensor) -> str:
    """"cudnn" when PyTorch hands a recurrence over ``x`` to cuDNN, "native"
    for its own CUDA RNN, "cpu" on the CPU."""
    if x.device.type != "cuda":
        return "cpu"
    return "cudnn" if torch.backends.cudnn.enabled and torch.backends.cudnn.is_acceptable(x) else "native"


def _run_rnn(rnn: nn.RNNBase, seq: torch.Tensor, lengths=None, carry=None):
    """(outputs (B, T, D), final carry) of a batch-first RNN; with
    ``lengths``, a packed run whose carry is the last valid frame's and whose
    outputs past a length are zeros."""
    if lengths is None:
        return rnn(seq, carry)
    lengths = torch.as_tensor(lengths).to("cpu", torch.int64).clamp(1, seq.shape[1])
    packed = pack_padded_sequence(seq, lengths, batch_first=True, enforce_sorted=False)
    out, carry = rnn(packed, carry)
    return pad_packed_sequence(out, batch_first=True, total_length=seq.shape[1])[0], carry


def _frames(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, C, F, T) -> (B, T, F) log-mel frames."""
    return x[:, 0].transpose(-1, -2).to(dtype)


class _LstmBase(HowlModel):
    def __init__(self, num_labels: int, hidden_size: int, n_mels: int, dtype):
        super().__init__(dtype)
        self.lstm = nn.LSTM(n_mels, hidden_size, batch_first=True)
        self.dnn = nn.Sequential(nn.Linear(hidden_size, 2 * hidden_size), nn.ReLU(),
                                 nn.Linear(2 * hidden_size, num_labels))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._head(self.dnn[2], F.relu(self.dnn[0](h)))


@register_model("lstm", is_recurrent=True)
class SimpleLstm(_LstmBase):
    """LSTM over mel frames; MLP on the final hidden state. ``n_mels`` is
    the LSTM's input width (flax infers it)."""

    def __init__(self, num_labels: int, hidden_size: int = 128, n_mels: int = 40, dtype=None):
        super().__init__(num_labels, hidden_size, n_mels, dtype)

    def forward(self, x, lengths=None, carry=None, return_carry: bool = False):
        self._check_dtype()
        _, carry = _run_rnn(self.lstm, _frames(x, self.lstm.weight_ih_l0.dtype), lengths, carry)
        out = self._logits(carry[0][-1])
        return (out, carry) if return_carry else out


@register_model("seq-lstm", is_sequential=True, is_recurrent=True)
class SequentialLstm(_LstmBase):
    """LSTM emitting per-frame logits (T, B, L) for CTC."""

    def __init__(self, num_labels: int, hidden_size: int = 128, n_mels: int = 40, dtype=None):
        super().__init__(num_labels, hidden_size, n_mels, dtype)

    def forward(self, x, lengths=None, carry=None, return_carry: bool = False):
        self._check_dtype()
        seq = _frames(x, self.lstm.weight_ih_l0.dtype)
        outputs, new_carry = self.lstm(seq, carry)  # flax's outputs run on past a length
        out = self._logits(outputs).transpose(0, 1)  # (T, B, L)
        if not return_carry:
            return out
        if lengths is not None:
            new_carry = _run_rnn(self.lstm, seq, lengths, carry)[1]
        return out, new_carry


@register_model("gru", is_recurrent=True)
class SimpleGru(HowlModel):
    """Conv encoder + GRU; MLP on the final hidden state. ``n_mels`` is the
    GRU's input width."""

    def __init__(self, num_labels: int, hidden_size: int = 96, num_latent_channels: int = 8,
                 use_maxpool: bool = True, n_mels: int = 40, dtype=None):
        super().__init__(dtype)
        self.use_maxpool = use_maxpool
        # the JAX module pads conv1 ((3, 3), (1, 1)) on (time, frequency): (1, 3) here on (frequency, time)
        self.conv_encoder = nn.Sequential(
            nn.Conv2d(1, num_latent_channels, 3, padding=(1, 3)), _affine_bn(num_latent_channels), nn.ReLU(),
            nn.MaxPool2d((1, 2)) if use_maxpool else nn.Identity(),
            nn.Conv2d(num_latent_channels, 1, 3, padding=1), nn.ReLU(), _affine_bn(1),
        )
        self.lstm_encoder = nn.GRU(n_mels, hidden_size, batch_first=True)
        self.dnn = nn.Sequential(nn.Linear(hidden_size, 2 * hidden_size), nn.ReLU(), nn.Dropout(0.2),
                                 nn.Linear(2 * hidden_size, num_labels))

    def forward(self, x, lengths=None, carry=None, return_carry: bool = False):
        self._check_dtype()
        h = self.conv_encoder(x[:, :1].to(self.lstm_encoder.weight_ih_l0.dtype))  # (B, 1, F, T')
        seq = h[:, 0].transpose(1, 2)  # (B, T', F)
        if lengths is not None:
            lengths = torch.as_tensor(lengths) + 4
            if self.use_maxpool:
                lengths = lengths // 2
        _, new_carry = _run_rnn(self.lstm_encoder, seq, lengths, carry)
        out = self._head(self.dnn[3], F.relu(self.dnn[0](new_carry[-1])))
        return (out, new_carry) if return_carry else out


class LASEncoder(nn.Module):
    """Two padded convs + biLSTM over all three feature channels (log-mels,
    deltas, accels). Returns the (B, T', 2H) sequence and the mapped lengths."""

    def __init__(self, hidden_size: int = 96, num_latent_channels: int = 8, use_maxpool: bool = True,
                 n_mels: int = 40):
        super().__init__()
        self.use_maxpool = use_maxpool
        c = num_latent_channels
        self.conv1 = nn.Conv2d(3, c, 3, padding=2)
        self.conv2 = nn.Conv2d(c, c, 3, padding=2)
        pool = (lambda: nn.MaxPool2d((1, 2))) if use_maxpool else nn.Identity
        # the reference's layout: conv1 and conv2 also sit in conv_encoder, so both names are in the state dict
        self.conv_encoder = nn.Sequential(self.conv1, _affine_bn(c), nn.ReLU(), pool(),
                                          self.conv2, _affine_bn(c), nn.ReLU(), pool())
        self.lstm_encoder = nn.LSTM((n_mels + 4) * c, hidden_size, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor, lengths=None):
        h = self.conv_encoder(x.to(self.conv1.weight.dtype))  # (B, C, F', T')
        seq = h.permute(0, 3, 1, 2).flatten(2)  # (B, T', C * F'): channel-major
        if lengths is not None:
            lengths = torch.as_tensor(lengths).to(x.device)
            for _ in range(2):
                lengths = (lengths - 3 + 4) // 1 + 1
                if self.use_maxpool:
                    lengths = lengths // 2
        return _run_rnn(self.lstm_encoder, seq, lengths)[0], lengths


class FixedAttentionModule(nn.Module):
    """Multi-head attention against a learned context vector, in float32:
    the JAX module's reshapes, the context vector read as (head_dim, heads)."""

    def __init__(self, hidden_size: int = 96, num_heads: int = 4):
        super().__init__()
        dim = 2 * hidden_size
        self.num_heads = num_heads
        self.context_vec = nn.Parameter(torch.empty(dim).uniform_(-0.25, 0.25))
        self.v_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)

    def forward(self, seq: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, dim = seq.shape
        values = HowlModel._head(self.v_proj, seq).reshape(b, t, self.num_heads, dim // self.num_heads)
        keys = HowlModel._head(self.k_proj, seq).reshape(b, t, self.num_heads, dim // self.num_heads)
        cvec = self.context_vec.float().reshape(dim // self.num_heads, self.num_heads)
        logits = torch.einsum("bthl,lh->bth", values, cvec)  # a score per (time, head)
        if mask is not None:
            logits = logits + ((1.0 - mask) * -100.0)[..., None]
        scores = torch.softmax(logits, dim=1)  # over time
        return torch.einsum("bth,bthl->bhl", scores, keys).reshape(b, dim)


@register_model("las", uses_deltas=True)
class LASClassifier(HowlModel):
    """LAS encoder + fixed attention + MLP head; attention and head in
    float32. ``n_mels`` sets the biLSTM's input width ((n_mels + 4) * C)."""

    def __init__(self, num_labels: int, hidden_size: int = 96, num_latent_channels: int = 8, dnn_size: int = 256,
                 dropout: float = 0.1, use_maxpool: bool = True, n_mels: int = 40, dtype=None):
        super().__init__(dtype)
        self.encoder = LASEncoder(hidden_size, num_latent_channels, use_maxpool, n_mels)
        self.attn = FixedAttentionModule(hidden_size)
        self.fc = nn.Sequential(nn.Linear(2 * hidden_size, dnn_size), nn.ReLU(), nn.Dropout(dropout),
                                nn.Linear(dnn_size, num_labels))

    def forward(self, x, lengths=None):
        self._check_dtype()
        seq, out_lengths = self.encoder(x, lengths)
        seq = seq.float()
        mask = None
        if out_lengths is not None:
            mask = (torch.arange(seq.shape[1], device=seq.device)[None, :] < out_lengths[:, None]).float()
        context = self.attn(seq, mask)
        return self._head(self.fc[3], F.relu(self._head(self.fc[0], context)))

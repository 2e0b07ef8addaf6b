"""Plain forward pass of the audio-to-midi model
(https://github.com/kasper0406/audio-to-midi, model.py), written from the
published description:

* CNN of 7 stages.  Stage 0 is the stem: a conv with kernel and stride 5,
  then LayerNorm over channels.  Every later stage opens with LayerNorm and
  a conv with kernel and stride 2.  Each stage then runs its ConvNeXt
  blocks: depthwise conv k=7 SAME, LayerNorm, 1x1 up, GELU (tanh), 1x1
  down, layer scale gamma, residual.  A final LayerNorm closes the CNN.
* Transformer of ``num_transformer_layers`` pairs: a local layer (windows
  of 16 every 8 rows, averaged) and a global one.  Each layer is pre-LN:
  attention + residual, then a GLU feed-forward + residual.  The attention
  projects q from the input, and k and v from a compressed kv.  RoPE goes
  on q and k, the softmax is in float32, and the out-projection has no
  bias.
* Decoder: LayerNorm, linear, sigmoid.

The local layer keeps the published model's padded-coordinate quirk: the
sequence is padded so that the windows cover it, each window's outputs are
added at padded coordinates into a buffer of the original length, and then
divided by the count of windows that covered each row.

Departure, noted: RoPE here rotates the channel halves (x[:hd/2] against
x[hd/2:]) where the published model rotates interleaved pairs.  That is the
same function of a q/k weight whose columns are permuted within each head.
The weights are random and are given in the port's state-dict names and
layouts: linear (in, out), conv WIO (K, C_in/groups, C_out).

Every product goes through ``rnd`` (``precision.rounder``) on both operands
and sums in float32.  Activations stay float32.

Training's dropout enters through ``drops`` (``reference/train.py``): with
it set, the attention weights after the softmax and the feed-forward's
output are dropped as it says.  Without it the forward is the inference
one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import exact_f32, rounder

LN_EPS = 1e-5


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _layer_norm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + bias


class Reference:
    """The model on the weights ``params`` (name -> float32 tensor on the
    device it runs on) and the geometry ``model_cfg`` (the configuration
    file's ``model`` section), with products rounded as ``precision`` says."""

    def __init__(self, params: dict, model_cfg: dict, precision: str = "f32"):
        self.w = params
        self.cfg = model_cfg
        self.rnd = rounder(precision)
        self.drops = None

    # -- products --------------------------------------------------------
    def _mm(self, x, w, b=None):
        y = self.rnd(x) @ self.rnd(w)
        return y if b is None else y + b

    def _conv(self, x, w, b, stride=1, padding=0, groups=1):
        """x (B, L, C_in) channels-last; w WIO -> (B, L', C_out)."""
        y = F.conv1d(self.rnd(x).transpose(1, 2), self.rnd(w).permute(2, 1, 0), b,
                     stride=stride, padding=padding, groups=groups)
        return y.transpose(1, 2)

    # -- CNN -------------------------------------------------------------
    def cnn(self, audio):
        """audio (B, 2, N) -> (B, N / 320, dims[-1])."""
        w, cfg = self.w, self.cfg
        x = audio.transpose(1, 2)
        for i, depth in enumerate(cfg["depths"]):
            pre = f"cnn.stages.{i}.down."
            if i == 0:
                x = self._conv(x, w[pre + "conv.w"], w[pre + "conv.b"], stride=5)
                x = _layer_norm(x, w[pre + "norm.scale"], w[pre + "norm.bias"])
            else:
                x = _layer_norm(x, w[pre + "norm.scale"], w[pre + "norm.bias"])
                x = self._conv(x, w[pre + "conv.w"], w[pre + "conv.b"], stride=2)
            for j in range(depth):
                b = f"cnn.stages.{i}.blocks.{j}."
                k = w[b + "depth_conv.w"].shape[0]
                y = self._conv(x, w[b + "depth_conv.w"], w[b + "depth_conv.b"],
                               padding=(k - 1) // 2, groups=x.shape[-1])
                y = _layer_norm(y, w[b + "norm.scale"], w[b + "norm.bias"])
                y = _gelu(self._mm(y, w[b + "pw1.w"], w[b + "pw1.b"]))
                y = self._mm(y, w[b + "pw2.w"], w[b + "pw2.b"])
                x = x + w[b + "gamma"] * y
        return _layer_norm(x, w["cnn.final_norm.scale"], w["cnn.final_norm.bias"])

    # -- attention -------------------------------------------------------
    def _rope(self, x):
        """RoPE on x (..., S, H, hd) at positions 0..S-1 of axis -3, halves."""
        s, hd = x.shape[-3], x.shape[-1]
        inv_freq = 1.0 / self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
        angle = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv_freq
        cos = torch.cos(angle).float()[:, None, :]
        sin = torch.sin(angle).float()[:, None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _qkv(self, x, pre):
        """q, k, v (..., S, H, hd) of the rows of x (..., S, D), before RoPE."""
        w, heads = self.w, self.cfg["num_transformer_heads"]
        *lead, s, _ = x.shape
        q = self._mm(x, w[pre + "q_up.w"]).reshape(*lead, s, heads, -1)
        ckv = self._mm(x, w[pre + "kv_down.w"])
        k = self._mm(ckv, w[pre + "k_up.w"]).reshape(*lead, s, heads, -1)
        v = self._mm(ckv, w[pre + "v_up.w"]).reshape(*lead, s, heads, -1)
        return q, k, v

    def _core(self, q, k, v, local=False):
        """Softmax attention within the S axis (-3), RoPE at positions
        0..S-1: (..., S, H, hd) -> (..., S, H * hd)."""
        q, k = self._rope(q), self._rope(k)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("...shd,...thd->...hst", self.rnd(q), self.rnd(k))
        weights = torch.softmax(logits, dim=-1)
        if self.drops is not None:
            weights = self.drops.attention(weights, local)
        out = torch.einsum("...hst,...thd->...shd", self.rnd(weights), self.rnd(v))
        return out.flatten(-2)

    def _global(self, x, pre):
        return self._mm(self._core(*self._qkv(x, pre)), self.w[pre + "out.w"])

    def _local(self, x, pre):
        """Windows of ``local_context_window`` rows every half window, the
        published padding and padded-coordinate average.  x: (B, S, D).  The
        out-projection is linear, so it is taken once after the average."""
        window = self.cfg["local_context_window"]
        stride = window // 2
        b, s, _ = x.shape
        required = stride - (s - window) % stride
        left = 0 if required == stride else required // 2
        right = 0 if required == stride else required - left
        xp = F.pad(x, (0, 0, left, right))
        count = (xp.shape[1] - window) // stride + 1
        cut = lambda t: t.unfold(1, window, stride).permute(0, 1, 4, 2, 3)  # (B, W, window, H, hd)
        outs = self._core(*(cut(t) for t in self._qkv(xp, pre)), local=True)
        total = x.new_zeros((b, xp.shape[1], outs.shape[-1]))
        covered = x.new_zeros((xp.shape[1],))
        for i in range(count):
            total[:, i * stride: i * stride + window] += outs[:, i]
            covered[i * stride: i * stride + window] += 1
        return self._mm(total[:, :s] / covered[:s, None], self.w[pre + "out.w"])

    def _layer(self, x, pre, local):
        w = self.w
        a = _layer_norm(x, w[pre + "attention_norm.scale"], w[pre + "attention_norm.bias"])
        x = x + (self._local if local else self._global)(a, pre + "attention.")
        f = _layer_norm(x, w[pre + "ff_norm.scale"], w[pre + "ff_norm.bias"])
        h = self._mm(f, w[pre + "ff.in_proj.w"], w[pre + "ff.in_proj.b"])
        gate, value = h.chunk(2, dim=-1)
        y = self._mm(_gelu(gate) * value, w[pre + "ff.out_proj.w"], w[pre + "ff.out_proj.b"])
        return x + (y if self.drops is None else self.drops.ffn(y))

    def forward(self, audio):
        """audio (B, 2, N) float32 -> (logits, probs), each (B, N / 320, vocab)."""
        with exact_f32():
            h = self.cnn(audio.float())
            for i in range(self.cfg["num_transformer_layers"]):
                h = self._layer(h, f"transformer.layers.{i}.local.", local=True)
                h = self._layer(h, f"transformer.layers.{i}.global.", local=False)
            w = self.w
            h = _layer_norm(h, w["decoder.norm.scale"], w["decoder.norm.bias"])
            logits = self._mm(h, w["decoder.out.w"], w["decoder.out.b"])
        return logits, torch.sigmoid(logits)

    def _blocks(self, windows, which: int, block: int):
        return torch.cat([self.forward(windows[i: i + block])[which]
                          for i in range(0, windows.shape[0], block)])

    def logits(self, windows, block: int = 32):
        """(W, 2, N) windows -> (W, frames, vocab) logits, ``block`` windows
        at a time."""
        return self._blocks(windows, 0, block)

    def probs(self, windows, block: int = 32):
        """(W, 2, N) windows -> (W, frames, vocab) probabilities, ``block``
        windows at a time."""
        return self._blocks(windows, 1, block)

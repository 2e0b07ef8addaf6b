"""Plain training steps of the model: the loss, the backward by autograd in
float32 (TF32 off), and the layer-wise AdamW chain, written from the
published description (https://github.com/kasper0406/audio-to-midi,
train.py):

* loss: sigmoid binary cross-entropy summed over (frames x keys), meaned
  over the minibatch; a step's gradient is the mean of its minibatches', and
  the loss it reports is the mean of theirs;
* AdamW: moments b1, b2 with bias correction, eps added outside the root,
  ``+ weight_decay * param``, times ``-lr(count)`` read before the count
  advances (linear warm-up from 0, then cosine), times the CNN layer-wise
  factor ``layer_lr_decay ** (max_depth - depth)`` (the stem or downsample
  of stage i has depth sum(depths[:i]), block j of it that plus j + 1), and
  last a clip of the updates' global norm;
* dropout, where the program drew it: attention weights after the softmax
  are kept where their Philox4x32-10 byte is at least
  ``round(rate * 256)`` and scaled by ``256 / (256 - threshold)``.  The byte
  of logit (row, column) of stream (sample, core) comes from key = the two
  words of the seed the program drew for that call, counter = (row,
  column // 16, sample, core), byte column % 16 of the four output words
  read little-endian.  core is the head for the global layers; for the
  local layers, in padded coordinates, ``phase * H + head`` where window w
  (rows 8w .. 8w + 15) lies in phase w mod 2.  The feed-forward's output is
  kept where the program's mask says and divided by 1 - rate.

The program's own draws are taken as inputs, as the rows it trained on
are: the windows it sampled from its ring and augmented, each attention
call's seed and each feed-forward mask, in the order it drew them.  The
weights are the benchmark's; everything else is worked out here.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from .model import Reference
from .precision import exact_f32, rounder

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_CNN_STAGE = re.compile(r"^cnn\.stages\.(\d+)\.(down|blocks\.(\d+))\.")


def _mulhilo(m: int, x: torch.Tensor):
    lo, hi = m * (x & 0xFFFF), m * (x >> 16)
    mid = ((hi & 0xFFFF) << 16) + lo
    return (hi >> 16) + (mid >> 32), mid & _U32


def philox_bytes(seed: torch.Tensor, samples: range, cores: int, p_len: int,
                 device) -> torch.Tensor:
    """(len(samples), cores, p_len, p_len) uint8 mask bytes of ``seed``."""
    ar = lambda n, lo=0: torch.arange(lo, lo + n, dtype=torch.int64, device=device)
    words = seed.to(torch.int64).tolist()
    k0, k1 = words[0] & _U32, words[1] & _U32
    groups = -(-p_len // 16)
    c0, c1 = ar(p_len)[:, None], ar(groups)[None, :]
    c2 = ar(len(samples), samples.start)[:, None, None, None]
    c3 = ar(cores)[None, :, None, None]
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    out = torch.stack([c0, c1, c2, c3], dim=-1)[..., None] >> (8 * ar(4)) & 255
    return out.reshape(len(samples), cores, p_len, groups * 16)[..., :p_len].to(torch.uint8)


class DrawMismatch(ValueError):
    """The program's dropout draws do not fit the rows it trained on."""


class Drops:
    """The dropout of one block of samples (``samples``) of one minibatch's
    forward, from the program's draws in the order it made them:
    ``("seed", (2,) int32)`` per attention call, ``("mask", bool)`` per
    feed-forward."""

    def __init__(self, draws: list, samples: range, rate: float):
        self._draws = iter(draws)
        self.samples = samples
        self.threshold = round(rate * 256)
        self.keep = 1.0 - rate

    def _next(self, kind: str):
        got, value = next(self._draws, (None, None))
        if got != kind:
            raise DrawMismatch(f"the program drew a {got} where the reference needs a {kind}")
        return value

    def attention(self, weights: torch.Tensor, local: bool) -> torch.Tensor:
        """weights: global (B, H, S, S); local (B, W, H, 16, 16)."""
        seed = self._next("seed")
        if local:
            b, count, heads, window, _ = weights.shape
            stride = window // 2
            p_len = (count - 1) * stride + window
            planes = philox_bytes(seed, self.samples, 2 * heads, p_len, weights.device)
            planes = planes.view(b, 2, heads, p_len, p_len)
            bits = torch.empty(weights.shape, dtype=torch.uint8, device=weights.device)
            i = torch.arange(window, device=weights.device)
            for phase in (0, 1):
                ws = torch.arange(phase, count, 2, device=weights.device)
                rows = (stride * ws)[:, None, None] + i[None, :, None]
                cols = (stride * ws)[:, None, None] + i[None, None, :]
                bits[:, ws] = planes[:, phase][:, :, rows, cols].permute(0, 2, 1, 3, 4)
        else:
            b, heads, s, _ = weights.shape
            bits = philox_bytes(seed, self.samples, heads, s, weights.device)
        scale = 256.0 / (256 - self.threshold)
        return torch.where(bits >= self.threshold, weights * scale, torch.zeros_like(weights))

    def ffn(self, y: torch.Tensor) -> torch.Tensor:
        mask = self._next("mask")[self.samples.start: self.samples.stop].to(y.device)
        if mask.shape != y.shape:
            raise DrawMismatch(f"feed-forward mask {tuple(mask.shape)} for output "
                               f"{tuple(y.shape)}")
        return torch.where(mask, y / self.keep, torch.zeros_like(y))


def learning_rate(count: int, t: dict) -> float:
    if count < t["warmup_steps"]:
        return t["base_learning_rate"] * count / t["warmup_steps"]
    progress = min(count - t["warmup_steps"], t["num_steps"]) / t["num_steps"]
    return t["base_learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * progress))


def lr_factor(name: str, depths: list, decay: float) -> float:
    m = _CNN_STAGE.match(name)
    if m is None:
        return 1.0
    depth = sum(depths[: int(m.group(1))])
    if m.group(3) is not None:
        depth += int(m.group(3)) + 1
    return decay ** (sum(depths) - depth)


def _straight_through(mode: str):
    """Operands rounded to ``mode`` going forward, the gradient passed
    through unchanged."""
    rnd = rounder(mode)
    if mode == "f32":
        return rnd
    return lambda t: t + (rnd(t) - t).detach()


class Trainer:
    """The plain training of ``params`` (name -> float32 tensor, copied)
    with the geometry ``model_cfg`` and the settings ``train`` (the traffic
    mix's ``optimizer`` section with ``num_steps``).  ``precision``: the
    products' operand rounding (the control's); ``keep_rows``: the share of
    each minibatch's rows that enters the loss (1; the half-batch fault's
    0.5)."""

    def __init__(self, params: dict, model_cfg: dict, train: dict, device,
                 precision: str = "f32", block: int = 32, keep_rows: float = 1.0):
        self.w = {k: v.detach().to(device, torch.float32).clone().requires_grad_()
                  for k, v in params.items()}
        self.model = Reference(self.w, model_cfg)
        self.model.rnd = _straight_through(precision)
        self.cfg, self.t, self.device = model_cfg, train, device
        self.block, self.keep_rows = block, keep_rows
        self.mu = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.count = 0
        self.factors = {k: lr_factor(k, model_cfg["depths"], train["layer_lr_decay"])
                        for k in self.w}

    def _minibatch(self, audio, labels, draws) -> float:
        """Forward and backward of one minibatch, in blocks of rows; the
        gradients of its mean loss accumulate.  Returns the loss."""
        rows = max(1, int(audio.shape[0] * self.keep_rows))
        total = 0.0
        for lo in range(0, rows, self.block):
            hi = min(lo + self.block, rows)
            self.model.drops = Drops(draws, range(lo, hi), self.cfg["transformer_dropout_rate"])
            logits, _ = self.model.forward(audio[lo:hi].to(self.device))
            per_row = F.binary_cross_entropy_with_logits(
                logits, labels[lo:hi].to(self.device).float(), reduction="none").sum(dim=(-2, -1))
            loss = per_row.sum() / rows
            loss.backward()
            total += float(loss.detach())
        self.model.drops = None
        return total

    def step(self, audio, labels, draws) -> tuple[float, dict]:
        """One step over (num_minibatches, minibatch, ...) ``audio`` and
        ``labels`` with the minibatches' ``draws``.  Returns (loss, the
        gradients the optimizer took)."""
        for v in self.w.values():
            v.grad = None
        with exact_f32():
            losses = [self._minibatch(a, lab, d) for a, lab, d in zip(audio, labels, draws)]
        grads = {k: v.grad / len(losses) for k, v in self.w.items()}
        self._apply(grads)
        return sum(losses) / len(losses), grads

    @torch.no_grad()
    def _apply(self, grads: dict) -> None:
        t = self.t
        lr = learning_rate(self.count, t)
        self.count += 1
        updates = {}
        for k, g in grads.items():
            self.mu[k].lerp_(g, 1.0 - t["adam_b1"])
            self.nu[k].mul_(t["adam_b2"]).addcmul_(g, g, value=1.0 - t["adam_b2"])
            m_hat = self.mu[k] / (1.0 - t["adam_b1"] ** self.count)
            v_hat = self.nu[k] / (1.0 - t["adam_b2"] ** self.count)
            u = m_hat / (v_hat.sqrt() + t["adam_eps"]) + t["weight_decay"] * self.w[k]
            updates[k] = u * (-lr * self.factors[k])
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(u)
                                                     for u in updates.values()]))
        clip = t["global_norm_clip"]
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        for k, u in updates.items():
            self.w[k].add_(u * scale)

    def params(self) -> dict:
        return {k: v.detach() for k, v in self.w.items()}

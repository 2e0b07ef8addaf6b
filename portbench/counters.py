"""Operations and bytes from shapes, and the card's peaks.

Operations count 2 per multiply-add of the products (convolutions,
projections, the attention's two products); LayerNorm, GELU, the softmax
and RoPE are not counted.  The forward counts what the plain reference
computes: the local layers project q, k and v on the padded rows once,
attend within each window, and project out after the average.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense.  f32 products on this path run as
# 3xTF32 on the tensor cores, so TF32's rate is their ceiling.
PEAK_FLOPS = {"f32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
BYTES = {"f32": 4, "bf16": 2}


def _local_rows(seq: int, window: int) -> tuple[int, int]:
    """(padded rows, windows) of the local layer."""
    stride = window // 2
    required = stride - (seq - window) % stride
    padded = seq + (0 if required == stride else required)
    return padded, (padded - window) // stride + 1


def forward_flops(model: dict, samples: int) -> int:
    """Operations of one window of ``samples`` samples through the model."""
    flops = 0
    length = samples
    dims, hidden = model["dims"], [int(d * model["cnn_hidden_expansion"]) for d in model["dims"]]
    for i, depth in enumerate(model["depths"]):
        cin = 2 if i == 0 else dims[i - 1]
        k = 5 if i == 0 else 2
        length //= k
        flops += 2 * length * k * cin * dims[i]
        flops += depth * 2 * length * dims[i] * (7 + 2 * hidden[i])
    seq, d = length, dims[-1]
    width = model["num_transformer_heads"] * model["attention_size"]
    ckv = model["compressed_attention_kv_size"]
    inter = int(d * model["transformer_hidden_expansion"])
    proj_in = 2 * (d * width + d * ckv + 2 * ckv * width)
    proj_out = 2 * width * d
    ffn = 2 * seq * (d * 2 * inter + inter * d)
    window = model["local_context_window"]
    padded, count = _local_rows(seq, window)
    local = padded * proj_in + seq * proj_out + count * 4 * window * window * width + ffn
    global_ = seq * (proj_in + proj_out) + 4 * seq * seq * width + ffn
    flops += model["num_transformer_layers"] * (local + global_)
    return flops + 2 * seq * d * model["output_vocab"]


def train_flops(model: dict, samples: int) -> int:
    """Operations of one window through a training step: the forward, and
    the backward's two products for each of the forward's (the gradient of
    its input and of its weight), less the input gradient of the stem, which
    the audio does not need."""
    stem = 2 * (samples // 5) * 5 * 2 * model["dims"][0]
    return 3 * forward_flops(model, samples) - stem


def global_attention_work(shape, elt: int) -> tuple[int, int]:
    """(operations, bytes) of one ``a2m::global_attention_fwd`` call on q of
    ``shape`` (G, S, H * hd): q, k and v read once, the output written once."""
    g, s, width = shape
    return 4 * g * s * s * width, 4 * g * s * width * elt


def local_attention_work(shape, window: int, elt: int) -> tuple[int, int]:
    """(operations, bytes) of one ``a2m::local_two_phase_fwd`` call on qa of
    ``shape`` (B, P, H * hd): the 2P/window - 1 windows of the two phases;
    qa, ka, qb, kb and v read once, the output written once."""
    b, p, width = shape
    windows = 2 * p // window - 1
    return 4 * b * windows * window * window * width, 6 * b * p * width * elt

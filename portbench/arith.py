"""The benchmark's arithmetic of work and bytes, and the card's peaks.

Operations count multiply-adds as two. A model step's work is the
products of its linears, convolutions and attention, as the model defines
its passes, at each request's own lengths (never the engine's buckets),
so that less padding reads as a higher share of the peak. A kernel's least
time is the larger of its operations over the peak rate, its
exponentials over the special-function units' rate and its bytes over the
memory rate, counting each input read once and each output written once,
at the shapes it was launched at.

Peaks: NVIDIA's H100 SXM data sheet (dense bf16 989 TFLOP/s, HBM3 3.35
TB/s) and 3.9e12 f32 exponentials per second (132 SMs x 16 per clock x
~1.83 GHz, the figure FlashAttention-3 gives), copied from the port's
``utils/devtime.py`` and frozen here.
"""

from __future__ import annotations

import math
from collections import Counter

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 3.9e12
BF16 = 2


def least_s(flops: float, nbytes: float, exps: float = 0.0) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS, exps / PEAK_EXP, nbytes / PEAK_BYTES)


# -- Conformer blocks --------------------------------------------------------
def block_linear_params(dim: int, heads: int, dim_head: int, ff_mult: int) -> int:
    """Multiply-adds per position of a block's linears and pointwise convs."""
    inner, ff = heads * dim_head, dim * ff_mult
    return 2 * (2 * dim * ff) + 4 * dim * inner + (dim * 4 * dim + 2 * dim * dim)


def block_flops(arch: dict, dim: int, length: int) -> float:
    """One block's operations over one sequence of ``length`` positions
    attending to all of them."""
    inner = arch["heads"] * arch["dim_head"]
    lin = 2 * length * block_linear_params(dim, arch["heads"], arch["dim_head"], arch["ff_mult"])
    attn = 4 * length * length * inner
    depthwise = 2 * length * arch["kernel"] * 2 * dim
    return lin + attn + depthwise


def t2s_arch(c: dict, stack: str) -> dict:
    return {"heads": c[f"{stack}_num_heads"], "dim_head": c[f"{stack}_dim_head"],
            "ff_mult": c[f"{stack}_ff_mult"], "kernel": c[f"{stack}_conv_kernel_size"],
            "depth": c[f"{stack}_num_layers"]}


def s2a_arch(c: dict) -> dict:
    heads = c["encoder_num_heads"]
    return {"heads": heads, "dim_head": c["hidden_size"] // heads, "ff_mult": c["encoder_ff_mult"],
            "kernel": c["encoder_conv_kernel_size"], "depth": c["encoder_num_layers"]}


def latent_dim(codec: dict) -> int:
    return codec["encoder_dim"] * 2 ** len(codec["encoder_rates"])


# -- one served request --------------------------------------------------------
def t2s_request_flops(c: dict, serving: dict, text_len: int, predicted: bool) -> float:
    """The length predictor (when the request has no length) and
    ``pred_iters`` passes over the canvas of ``text_len + 4 +
    max_speech_len`` positions, each ending in the semantic head."""
    h = c["hidden_size"]
    main = t2s_arch(c, "main_encoder")
    canvas = text_len + 4 + serving["max_speech_len"]
    per_pass = (main["depth"] * block_flops(main, h, canvas)
                + 2 * canvas * (h * h + h * c["semantic_vocab_size"]))
    total = serving["pred_iters"] * per_pass
    if predicted:
        lp = t2s_arch(c, "length_predictor")
        total += lp["depth"] * block_flops(lp, h, 1 + text_len) + 2 * h
    return total


def s2a_request_flops(c: dict, codec: dict, serving: dict, prompt: int, frames: int) -> float:
    """``s2a_steps`` passes of the blocks up to the first injection layer
    with the level-0 head and a commit projection each, then one pass of
    every block with the injections, the coarse heads, the fine head and
    the stacked head, over the prompt and the request's own frames."""
    h, d = c["hidden_size"], latent_dim(codec)
    arch = s2a_arch(c)
    n, q = codec["codebook_size"], codec["n_codebooks"]
    n_inj = len(c["injection_layers"])
    length = prompt + frames
    first = (c["injection_layers"][0] + 1) * block_flops(arch, h, length) + 2 * length * h * n
    commit = 2 * frames * d * h
    full = (arch["depth"] * block_flops(arch, h, length)
            + n_inj * (2 * length * d * h + 2 * length * h * n)
            + 2 * frames * h * h * (q - n_inj) + 2 * frames * q * h * n)
    return serving["s2a_steps"] * (first + commit) + 2 * prompt * d * h + full


def decoder_layers(codec: dict, frames: int) -> list[tuple[str, int, int, int, int]]:
    """``(kind, T_out, C_in, C_out, taps)`` of each decoder convolution for
    ``frames`` frames; kind "conv", "tconv" (taps = 2 s, T_out the input
    length) or "unit" (a residual unit: k=7 then k=1, C x C)."""
    ch, t = codec["decoder_dim"], frames
    out = [("conv", t, latent_dim(codec), ch, 7)]
    for s in codec["decoder_rates"]:
        cin, ch = ch, ch // 2
        out.append(("tconv", t, cin, ch, 2 * s))
        t = s * t + (2 if s % 2 else 0)
        out += [("unit", t, ch, ch, 7)] * 3
    out.append(("conv", t, ch, 1, 7))
    return out


def decode_flops(codec: dict, frames: int) -> float:
    total = 2 * frames * codec["n_codebooks"] * codec["codebook_dim"] * latent_dim(codec)
    for kind, t, cin, cout, taps in decoder_layers(codec, frames):
        total += 2 * t * cin * cout * (taps + 1 if kind == "unit" else taps)
    return total


def request_flops(cfg: dict, text_len: int, frames: int, predicted: bool) -> float:
    """One request's model work: t2s, s2a and the decode."""
    serving = cfg["serving"]
    return (t2s_request_flops(cfg["t2s"], serving, text_len, predicted)
            + s2a_request_flops(cfg["s2a"], cfg["codec"], serving, cfg["assumed"]["prompt_frames"],
                                frames)
            + decode_flops(cfg["codec"], frames))


# -- one engine call's kernel launches ---------------------------------------
def engine_buckets(serving: dict, text_bytes: list[int], frames: list[int]) -> tuple[int, int, int]:
    """(batch rows, text length, canvas frames) an engine call of these
    requests runs at: each rounded up to the configuration's buckets."""
    def up(n: int, multiple: int) -> int:
        return -(-max(n, 1) // multiple) * multiple

    rows = min(b for b in serving["batch_buckets"] if b >= len(text_bytes))
    return (rows, up(max(text_bytes), serving["text_bucket"]),
            min(up(max(frames), serving["length_bucket"]), serving["max_speech_len"]))


def quantizable(k: int, n: int) -> bool:
    return k % 32 == 0 and n % 128 == 0


def block_sites(dim: int, heads: int, dim_head: int, ff_mult: int) -> list[tuple[int, int]]:
    """``(K, N)`` of the int8 sites of one block, in order."""
    inner, ff = heads * dim_head, dim * ff_mult
    sites = [(dim, ff), (ff, dim), (dim, inner), (dim, 2 * inner), (inner, dim),
             (dim, 4 * dim), (2 * dim, dim), (dim, ff), (ff, dim)]
    return [s for s in sites if quantizable(*s)]


def int8_launches(cfg: dict, rows: int, text_bucket: int, frames_bucket: int,
                  predicted: bool) -> Counter:
    """``{(M, K, N): count}`` of K5's launches in one engine call of
    ``rows`` rows (the batch bucket), text bucket and canvas bucket."""
    t2s, s2a, codec, serving = cfg["t2s"], cfg["s2a"], cfg["codec"], cfg["serving"]
    out: Counter = Counter()
    h = t2s["hidden_size"]
    if predicted:
        lp = t2s_arch(t2s, "length_predictor")
        for s in block_sites(h, lp["heads"], lp["dim_head"], lp["ff_mult"]):
            out[(rows * (1 + text_bucket),) + s] += lp["depth"]
    main = t2s_arch(t2s, "main_encoder")
    m = rows * (text_bucket + 4 + serving["max_speech_len"])
    for s in block_sites(h, main["heads"], main["dim_head"], main["ff_mult"]):
        out[(m,) + s] += main["depth"] * serving["pred_iters"]
    for s in ((h, h), (h, t2s["semantic_vocab_size"])):
        if quantizable(*s):
            out[(m,) + s] += serving["pred_iters"]
    d = s2a["hidden_size"]
    arch = s2a_arch(s2a)
    m = rows * (cfg["assumed"]["prompt_frames"] + frames_bucket)
    first = s2a["injection_layers"][0] + 1
    for s in block_sites(d, arch["heads"], arch["dim_head"], arch["ff_mult"]):
        out[(m,) + s] += first * serving["s2a_steps"] + arch["depth"]
    fine = (d, d * (codec["n_codebooks"] - len(s2a["injection_layers"])))
    if quantizable(*fine):
        out[(rows * frames_bucket,) + fine] += 1
    return out


def int8_least_s(launches: Counter) -> float:
    total = 0.0
    for (m, k, n), count in launches.items():
        total += count * least_s(2 * m * k * n, BF16 * m * k + k * n + 4 * n + BF16 * m * n)
    return total


def resunit_launches(codec: dict, rows: int, frames_bucket: int) -> Counter:
    """``{(B, T, C, dilation): count}`` of K1's units in one engine call's
    decode (the masked decode runs every unit of C <= 768 as K1)."""
    out: Counter = Counter()
    i = 0
    for kind, t, _, c, _ in decoder_layers(codec, frames_bucket):
        if kind == "unit":
            if c <= 768:
                out[(rows, t, c, (1, 3, 9)[i % 3])] += 1
            i += 1
    return out


def resunit_least_s(launches: Counter) -> float:
    total = 0.0
    for (b, t, c, _), count in launches.items():
        flops = 2 * b * t * c * c * 8
        nbytes = 2 * BF16 * b * t * c + BF16 * 8 * c * c + 4 * 3 * c
        total += count * least_s(flops, nbytes)
    return total


# -- attention in training -----------------------------------------------------
def attention_fwd_bwd_least_s(b: int, t: int, heads: int, dim_head: int) -> float:
    """K3 with its LSE and K4 over one layer's ``(B, T, H, D)``: forward
    Q K^T and P V, one exponential per score; backward recomputes S and P
    and forms dV, dP, dQ and dK."""
    scores = b * heads * t * t
    io = b * t * heads * dim_head * BF16
    fwd = least_s(4 * scores * dim_head, 4 * io + 4 * b * heads * t, scores)
    bwd = least_s(10 * scores * dim_head, 8 * io + 8 * b * heads * t, scores)
    return fwd + bwd


# -- the training step -----------------------------------------------------------
def s2a_train_flops(c: dict, codec: dict, batch: int, frames: int) -> float:
    """One optimizer step's model work over ``batch`` x ``frames``: three
    times the forward of the blocks and heads (forward, then the
    backward's two products per forward product), twice that of the
    feature projections (their inputs, the frozen codec's features, take no
    gradient), and the frozen codec's feature lookup once."""
    h, d = c["hidden_size"], latent_dim(codec)
    arch = s2a_arch(c)
    n, q = codec["codebook_size"], codec["n_codebooks"]
    n_inj = len(c["injection_layers"])
    full = (arch["depth"] * block_flops(arch, h, frames)
            + 2 * frames * h * h * (q - n_inj) + 2 * frames * q * h * n)
    projections = 2 * frames * d * h * (1 + n_inj)
    frozen = 2 * frames * q * codec["codebook_dim"] * d
    return batch * (3 * full + 2 * projections + frozen)


def audio_seconds(codec: dict, frames: int) -> float:
    return frames * math.prod(codec["decoder_rates"]) / codec["sample_rate"]

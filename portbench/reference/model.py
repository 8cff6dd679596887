"""The three models' forward passes in plain float32 PyTorch.

Each function reads a ``Params`` (a state dict of reference-format names)
and computes in f32 with the plain definitions:

- Conformer block: ``x + FF/2`` -> ``x + MHSA(RoPE)`` -> ``x + Conv`` ->
  ``x + FF/2`` -> LayerNorm (eps 1e-6); FF is Linear, SiLU, Linear; the
  attention has bias-free q and kv, softmax over the keys the mask keeps;
  the conv module is LayerNorm, pointwise to 2 x 2d, GLU (value first),
  depthwise conv padded ``(k//2, k//2 - (k+1)%2)``, SiLU, a scale-only
  channel LayerNorm (variance clamped at 1e-6), pointwise back;
- t2s: joint-vocab embedding (pad id 0 embeds to zeros), the main
  Conformer, Linear + GELU(tanh) + LayerNorm, the semantic head; the length
  predictor: a [LEN] token before the text, its Conformer, a linear head on
  that token giving log frames;
- s2a: semantic embedding plus the projected codec features of level 0;
  16 blocks; after each injection layer the coarse output's level logits,
  the codec features of the levels decoded so far (cumulative RVQ
  out-projections) projected and added, with the previous coarse output as
  a residual; the stacked per-level head over 4 coarse outputs and the 8
  fine ones;
- the DAC decoder: k=7 stem, blocks of snake, transposed conv (k = 2s) and
  three residual units (snake, dilated k=7 conv, snake, k=1 conv, plus the
  input), snake, k=7 conv, tanh; weight norm ``g * v / ||v||``.

``Params(quantize="int8")`` dequantizes the int8 serving sites (every
Conformer linear and pointwise conv, t2s ``pred_transform.0`` and
``pred_head``, s2a ``encoder.fine_head.0``, where in % 32 == 0 and out % 128
== 0) from the weights by symmetric per-output rounding to +-127.
``precision="fp8"`` rounds both operands of every linear and convolution
to float8 e4m3 with a per-tensor scale (the controls' lower precision).
"""

from __future__ import annotations

import contextlib
import math
import re

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
SPECIAL = {"pad": 0, "text": 1, "speech": 2, "sep": 3, "mask": 4}
_SITES = re.compile(r"(\.(ff1|ff2)\.fn\.fn\.net\.[03]|\.attn\.fn\.to_(q|kv|out)|\.conv\.net\.[27])"
                    r"\.weight$|^(pred_transform\.0|pred_head|encoder\.fine_head\.0)\.weight$")
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the products on the card (f32 as it is written)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """``(out, in)`` weight -> its int8 dequantization: per output row
    scale ``amax / 127`` (1 for a zero row), round half to even, clip."""
    w = w.float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


E5M2_MAX = 57344.0


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that puts its
    largest magnitude at ``top``, back in f32."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _FakeFP8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2 (each under its
    own per-tensor scale), as fp8 training runs its products."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, E5M2_MAX)


def fake_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32;
    under autograd its gradient is rounded to e5m2 the same way."""
    return _FakeFP8.apply(x)


class Params:
    """A state dict read in f32, with the int8 sites dequantized when
    ``quantize == "int8"`` and ``precision`` "f32" or "fp8" for the linears."""

    def __init__(self, sd: dict[str, torch.Tensor], *, quantize: str = "none",
                 precision: str = "f32"):
        if quantize not in ("none", "int8") or precision not in ("f32", "fp8"):
            raise ValueError(f"Params: quantize {quantize!r}, precision {precision!r}")
        self.sd, self.quantize, self.precision = sd, quantize, precision
        self._cache: dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._cache:
            t = self.sd[name]
            if self.quantize == "int8" and _SITES.search(name):
                n, k = t.shape[:2]
                if k % 32 == 0 and n % 128 == 0:
                    t = quantize_int8(t.reshape(n, k)).reshape(t.shape)
            self._cache[name] = t.float()
        return self._cache[name]

    def linear(self, x: torch.Tensor, prefix: str, bias: bool = True) -> torch.Tensor:
        w = self[f"{prefix}.weight"]
        w = w.reshape(w.shape[0], -1)
        if self.precision == "fp8":
            x, w = fake_e4m3(x), fake_e4m3(w)
        y = x @ w.t()
        return y + self[f"{prefix}.bias"] if bias else y


def layer_norm(x: torch.Tensor, p: Params, prefix: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"], LN_EPS)


def rope(length: int, dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    f = torch.outer(torch.arange(length, dtype=torch.float32, device=device), inv)
    f = torch.cat([f, f], dim=-1)
    return torch.cos(f), torch.sin(f)


def _rotate(t: torch.Tensor, cs) -> torch.Tensor:
    cos, sin = cs
    a, b = t.chunk(2, dim=-1)
    return t * cos + torch.cat([-b, a], dim=-1) * sin


def attention(x, p: Params, prefix: str, heads: int, dim_head: int, cs, key_mask):
    """Multi-head self-attention; ``key_mask`` bool ``(B, T)`` (True =
    attend) or None."""
    b, t, _ = x.shape
    q = p.linear(x, f"{prefix}.to_q", bias=False).view(b, t, heads, dim_head).transpose(1, 2)
    k, v = (y.reshape(b, t, heads, dim_head).transpose(1, 2)
            for y in p.linear(x, f"{prefix}.to_kv", bias=False).chunk(2, dim=-1))
    q, k = _rotate(q, cs), _rotate(k, cs)
    s = (q @ k.transpose(-1, -2)) * dim_head ** -0.5
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    return p.linear(o.transpose(1, 2).reshape(b, t, heads * dim_head), f"{prefix}.to_out")


def conv_module(x, p: Params, prefix: str, kernel: int, pad_mask):
    h = p.linear(layer_norm(x, p, f"{prefix}.0"), f"{prefix}.2")
    val, gate = h.chunk(2, dim=-1)
    h = val * torch.sigmoid(gate)
    if pad_mask is not None:
        h = torch.where(pad_mask[:, :, None], h, 0.0)
    h = F.pad(h.transpose(1, 2), (kernel // 2, kernel // 2 - (kernel + 1) % 2))
    h = F.conv1d(h, p[f"{prefix}.4.conv.weight"], p[f"{prefix}.4.conv.bias"],
                 groups=h.shape[1]).transpose(1, 2)
    h = h * torch.sigmoid(h)
    mean = h.mean(-1, keepdim=True)
    var = (h - mean).square().mean(-1, keepdim=True)
    h = (h - mean) * torch.rsqrt(var.clamp_min(1e-6)) * p[f"{prefix}.6.weight"].reshape(-1)
    return p.linear(h, f"{prefix}.7")


def feed_forward(x, p: Params, prefix: str):
    h = p.linear(layer_norm(x, p, f"{prefix}.norm"), f"{prefix}.fn.net.0")
    return p.linear(F.silu(h), f"{prefix}.fn.net.3")


def block(x, p: Params, prefix: str, arch: dict, cs, mask=None, conv_pad_mask=None):
    """One Conformer block; ``arch``: heads, dim_head, kernel."""
    x = x + 0.5 * feed_forward(x, p, f"{prefix}.ff1.fn")
    x = x + attention(layer_norm(x, p, f"{prefix}.attn.norm"), p, f"{prefix}.attn.fn",
                      arch["heads"], arch["dim_head"], cs, mask)
    x = x + conv_module(x, p, f"{prefix}.conv.net", arch["kernel"], conv_pad_mask)
    x = x + 0.5 * feed_forward(x, p, f"{prefix}.ff2.fn")
    return layer_norm(x, p, f"{prefix}.post_norm")


# -- text -> semantic --------------------------------------------------------
def t2s_arch(c: dict, stack: str) -> dict:
    return {"heads": c[f"{stack}_num_heads"], "dim_head": c[f"{stack}_dim_head"],
            "kernel": c[f"{stack}_conv_kernel_size"], "depth": c[f"{stack}_num_layers"]}


def t2s_embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["input_embedding.weight"][tokens] * (tokens != SPECIAL["pad"])[..., None]


def t2s_logits(p: Params, c: dict, tokens: torch.Tensor, attention_mask: torch.Tensor):
    """Canvas ``(B, L)`` -> semantic logits ``(B, L, V_sem)``; the attention
    mask also masks the convs, as the sampler runs it."""
    arch = t2s_arch(c, "main_encoder")
    x = t2s_embed(p, tokens)
    cs = rope(x.shape[1], arch["dim_head"], x.device)
    for i in range(arch["depth"]):
        x = block(x, p, f"conformer.layers.{i}", arch, cs, attention_mask, attention_mask)
    h = F.gelu(p.linear(x, "pred_transform.0"), approximate="tanh")
    return p.linear(layer_norm(h, p, "pred_transform.2"), "pred_head")


def t2s_log_length(p: Params, c: dict, text: torch.Tensor, text_mask: torch.Tensor):
    """``(B, Lt)`` text ids (+5) -> predicted log frames ``(B,)``."""
    arch = t2s_arch(c, "length_predictor")
    b = text.shape[0]
    x = torch.cat([p["length_token"].expand(b, 1, -1), t2s_embed(p, text)], dim=1)
    mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=text.device), text_mask], 1)
    cs = rope(x.shape[1], arch["dim_head"], x.device)
    for i in range(arch["depth"]):
        x = block(x, p, f"length_predictor.layers.{i}", arch, cs, mask, mask)
    return p.linear(x[:, 0], "length_pred_head")[:, 0]


def build_canvas(text: torch.Tensor, text_len: torch.Tensor, speech_len: torch.Tensor,
                 max_speech: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[TEXT] text [SEP] [SPEECH] [MASK]*len [SEP]`` padded to ``Lt + 4 +
    max_speech``: (canvas, attention, speech span)."""
    b, lt = text.shape
    pos = torch.arange(lt + 4 + max_speech, device=text.device)[None, :]
    tl, sl = text_len[:, None], speech_len[:, None]
    canvas = torch.zeros((b, pos.shape[1]), dtype=torch.long, device=text.device)
    canvas[:, 0] = SPECIAL["text"]
    inside = (pos >= 1) & (pos < 1 + tl)
    canvas = torch.where(inside, torch.gather(text, 1, (pos - 1).clamp(0, lt - 1).expand(b, -1)),
                         canvas)
    canvas = torch.where(pos == 1 + tl, SPECIAL["sep"], canvas)
    canvas = torch.where(pos == 2 + tl, SPECIAL["speech"], canvas)
    span = (pos >= 3 + tl) & (pos < 3 + tl + sl)
    canvas = torch.where(span, SPECIAL["mask"], canvas)
    canvas = torch.where(pos == 3 + tl + sl, SPECIAL["sep"], canvas)
    return canvas, (pos <= 3 + tl + sl).expand(b, -1), span


# -- semantic -> acoustic ----------------------------------------------------
def _wn_weight(p: Params, prefix: str) -> torch.Tensor:
    v, g = p[f"{prefix}.weight_v"], p[f"{prefix}.weight_g"]
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return v * (g.reshape(norm.shape) / norm)


def codec_features(p: Params, codec: dict, codes: torch.Tensor, prefix: str = "acoustic_model"):
    """``(B, Q', T)`` codes -> per-level out-projected codebook vectors
    ``(B, Q', T, D)`` (the RVQ's decode, unreduced)."""
    out = []
    for q in range(codes.shape[1]):
        lv = f"{prefix}.quantizer.quantizers.{q}"
        vec = p[f"{lv}.codebook.weight"][codes[:, q]]
        w = _wn_weight(p, f"{lv}.out_proj")[:, :, 0]
        out.append(vec @ w.t() + p[f"{lv}.out_proj.bias"])
    return torch.stack(out, dim=1)


def s2a_arch(c: dict) -> dict:
    heads = c["encoder_num_heads"]
    return {"heads": heads, "dim_head": c["hidden_size"] // heads,
            "kernel": c["encoder_conv_kernel_size"], "depth": c["encoder_num_layers"]}


def _feat_proj(p: Params, prefix: str, f: torch.Tensor) -> torch.Tensor:
    return layer_norm(p.linear(f, f"{prefix}.0"), p, f"{prefix}.1")


def level_logits(p: Params, x: torch.Tensor, level: int) -> torch.Tensor:
    h = layer_norm(x, p, "encoder.to_logits.0")
    return h @ p["encoder.to_logits.1.weight"][level] + p["encoder.to_logits.1.bias"][0, 0, level]


def s2a_first_level(p: Params, c: dict, x: torch.Tensor, pad_mask):
    """Blocks up to the first injection layer -> level-0 logits ``(B, L, N)``."""
    arch = s2a_arch(c)
    cs = rope(x.shape[1], arch["dim_head"], x.device)
    for i in range(c["injection_layers"][0] + 1):
        x = block(x, p, f"encoder.layers.{i}", arch, cs, pad_mask, pad_mask)
    return level_logits(p, x, 0)


def _all_levels(p: Params, c: dict, codec: dict, final, coarse):
    b, t, h = final.shape
    rem = codec["n_codebooks"] - len(c["injection_layers"])
    fine = p.linear(final, "encoder.fine_head.0").reshape(b, t, rem, h)
    x = layer_norm(torch.cat([torch.stack(coarse, dim=2), fine], dim=2), p, "encoder.to_logits.0")
    w = p["encoder.to_logits.1.weight"]
    return torch.einsum("btqh,qhn->bqtn", x, w) + p["encoder.to_logits.1.bias"][0, 0][None, :, None, :]


def s2a_full_logits(p: Params, c: dict, codec: dict, x: torch.Tensor, injected: torch.Tensor,
                    pad_mask, tp: int):
    """All blocks with the injections given -> logits ``(B, Q, L - tp, N)``.

    ``injected`` ``(n_inj, B, L, D)``: the codec features added after each
    injection layer (in serving: the prompt's own at its positions, those
    of the levels decoded so far at the generated ones)."""
    arch = s2a_arch(c)
    cs = rope(x.shape[1], arch["dim_head"], x.device)
    coarse: list[torch.Tensor] = []
    for i in range(arch["depth"]):
        cur = block(x, p, f"encoder.layers.{i}", arch, cs, pad_mask, pad_mask)
        if i in c["injection_layers"]:
            j = c["injection_layers"].index(i)
            residual = coarse[-1] if coarse and c["residual"] else 0.0
            coarse.append(cur)
            if c["use_injection"]:
                cur = cur + _feat_proj(p, f"encoder.project_injection.{j}", injected[j])
            cur = cur + residual
        x = cur
    return _all_levels(p, c, codec, x[:, tp:], [k[:, tp:] for k in coarse])


def s2a_train_loss(p: Params, c: dict, codec: dict, acoustic: torch.Tensor,
                   semantic: torch.Tensor, mask: torch.Tensor):
    """The masked-LM loss of one batch: ``(loss, masked count)``; the
    teacher's cumulative codec features are injected, the cross-entropy of
    every level is averaged over the masked positions."""
    with torch.no_grad():
        feats = codec_features(p, codec, acoustic)
    sem = p["semantic_embedding.weight"][semantic]
    ac0 = _feat_proj(p, "acoustic_feat_proj", feats[:, 0])
    x = torch.where(mask[:, :, None], sem + p["mask_token"], sem + ac0)
    teacher = torch.cumsum(feats, dim=1)[:, :len(c["injection_layers"])].transpose(0, 1)
    logits = s2a_full_logits(p, c, codec, x, teacher, None, 0).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, acoustic[..., None])[..., 0]
    m = mask[:, None, :].expand(nll.shape).float()
    return (nll * m).sum() / m.sum().clamp_min(1.0), mask.sum()


# -- codec decode ------------------------------------------------------------
def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x + sin^2(a x) / a`` on ``(B, C, T)``."""
    a = alpha.reshape(1, -1, 1)
    return x + (1.0 - torch.cos(2.0 * a * x)) / (2.0 * (a + 1e-9))


def _operands(p: Params, x, w):
    return (fake_e4m3(x), fake_e4m3(w)) if p.precision == "fp8" else (x, w)


def _conv(p: Params, prefix: str, x, **kw):
    x, w = _operands(p, x, _wn_weight(p, prefix))
    return F.conv1d(x, w, p[f"{prefix}.bias"], **kw)


def _unit(p: Params, prefix: str, x, dilation: int):
    y = _conv(p, f"{prefix}.block.1", snake(x, p[f"{prefix}.block.0.alpha"]),
              dilation=dilation, padding=3 * dilation)
    return x + _conv(p, f"{prefix}.block.3", snake(y, p[f"{prefix}.block.2.alpha"]))


def decode(p: Params, codec: dict, codes: torch.Tensor, prefix: str = "acoustic_model"):
    """``(B, Q, T)`` codes -> waveform ``(B, samples)`` at the codes' exact
    length (``T * hop`` plus 2 samples per odd stride)."""
    z = codec_features(p, codec, codes, prefix).sum(1).transpose(1, 2)
    m = f"{prefix}.decoder.model"
    x = _conv(p, f"{m}.0", z, padding=3)
    for i, s in enumerate(codec["decoder_rates"], start=1):
        x, w = _operands(p, snake(x, p[f"{m}.{i}.block.0.alpha"]),
                         _wn_weight(p, f"{m}.{i}.block.1"))
        x = F.conv_transpose1d(x, w, p[f"{m}.{i}.block.1.bias"], stride=s, padding=s // 2,
                               output_padding=s % 2)
        for u, d in enumerate((1, 3, 9)):
            x = _unit(p, f"{m}.{i}.block.{u + 2}", x, d)
    n = len(codec["decoder_rates"]) + 1
    x = _conv(p, f"{m}.{n + 1}", snake(x, p[f"{m}.{n}.alpha"]), padding=3)
    return torch.tanh(x[:, 0])


def hop(codec: dict) -> int:
    return math.prod(codec["decoder_rates"])

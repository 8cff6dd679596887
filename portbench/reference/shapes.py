"""The parameters of each model as reference-format names and shapes.

Names follow the published checkpoints (``conformer.layers.{i}.ff1.fn.
fn.net.0.weight``, ``acoustic_model.decoder.model.{i}...``, weight norm as
``weight_v`` / ``weight_g``), so a state dict made from these lists loads
into the port strictly, and the reference reads the same dict by name.
"""

from __future__ import annotations


def block_shapes(prefix: str, dim: int, heads: int, dim_head: int, ff_mult: int,
                 kernel: int) -> dict[str, tuple[int, ...]]:
    """One Conformer block: two half feed-forwards, attention, the conv
    module (expansion 2) and the post norm."""
    inner, ff, conv = heads * dim_head, dim * ff_mult, 2 * dim
    out: dict[str, tuple[int, ...]] = {}
    for half in ("ff1", "ff2"):
        p = f"{prefix}.{half}.fn"
        out.update({f"{p}.norm.weight": (dim,), f"{p}.norm.bias": (dim,),
                    f"{p}.fn.net.0.weight": (ff, dim), f"{p}.fn.net.0.bias": (ff,),
                    f"{p}.fn.net.3.weight": (dim, ff), f"{p}.fn.net.3.bias": (dim,)})
    p = f"{prefix}.attn"
    out.update({f"{p}.norm.weight": (dim,), f"{p}.norm.bias": (dim,),
                f"{p}.fn.to_q.weight": (inner, dim), f"{p}.fn.to_kv.weight": (2 * inner, dim),
                f"{p}.fn.to_out.weight": (dim, inner), f"{p}.fn.to_out.bias": (dim,)})
    p = f"{prefix}.conv.net"
    out.update({f"{p}.0.weight": (dim,), f"{p}.0.bias": (dim,),
                f"{p}.2.weight": (2 * conv, dim, 1), f"{p}.2.bias": (2 * conv,),
                f"{p}.4.conv.weight": (conv, 1, kernel), f"{p}.4.conv.bias": (conv,),
                f"{p}.6.weight": (1, conv, 1),
                f"{p}.7.weight": (dim, conv, 1), f"{p}.7.bias": (dim,)})
    out.update({f"{prefix}.post_norm.weight": (dim,), f"{prefix}.post_norm.bias": (dim,)})
    return out


def t2s_shapes(c: dict) -> dict[str, tuple[int, ...]]:
    h = c["hidden_size"]
    vocab = c["text_vocab_size"] + c["semantic_vocab_size"] + 5
    out = {"input_embedding.weight": (vocab, h), "length_token": (1, 1, h)}
    for name, stack in (("conformer", "main_encoder"), ("length_predictor", "length_predictor")):
        for i in range(c[f"{stack}_num_layers"]):
            out.update(block_shapes(f"{name}.layers.{i}", h, c[f"{stack}_num_heads"],
                                    c[f"{stack}_dim_head"], c[f"{stack}_ff_mult"],
                                    c[f"{stack}_conv_kernel_size"]))
    out.update({"pred_transform.0.weight": (h, h), "pred_transform.0.bias": (h,),
                "pred_transform.2.weight": (h,), "pred_transform.2.bias": (h,),
                "pred_head.weight": (c["semantic_vocab_size"], h),
                "pred_head.bias": (c["semantic_vocab_size"],),
                "length_pred_head.weight": (1, h), "length_pred_head.bias": (1,)})
    return out


def _wn(prefix: str, shape: tuple[int, ...]) -> dict[str, tuple[int, ...]]:
    """A weight-normed conv's direction and its magnitude (one per first dim)."""
    return {f"{prefix}.weight_v": shape, f"{prefix}.weight_g": (shape[0],) + (1,) * (len(shape) - 1)}


def _unit(prefix: str, c: int, k: int = 7) -> dict[str, tuple[int, ...]]:
    out = {f"{prefix}.block.0.alpha": (1, c, 1), f"{prefix}.block.2.alpha": (1, c, 1)}
    out.update(_wn(f"{prefix}.block.1", (c, c, k)))
    out[f"{prefix}.block.1.bias"] = (c,)
    out.update(_wn(f"{prefix}.block.3", (c, c, 1)))
    out[f"{prefix}.block.3.bias"] = (c,)
    return out


def codec_shapes(c: dict, prefix: str = "acoustic_model") -> dict[str, tuple[int, ...]]:
    """The DAC: encoder, residual VQ and decoder."""
    out: dict[str, tuple[int, ...]] = {}
    e = f"{prefix}.encoder.block"
    d = c["encoder_dim"]
    out.update(_wn(f"{e}.0", (d, 1, 7)))
    out[f"{e}.0.bias"] = (d,)
    for i, s in enumerate(c["encoder_rates"], start=1):
        half, d = d, 2 * d
        for u in range(3):
            out.update(_unit(f"{e}.{i}.block.{u}", half))
        out[f"{e}.{i}.block.3.alpha"] = (1, half, 1)
        out.update(_wn(f"{e}.{i}.block.4", (d, half, 2 * s)))
        out[f"{e}.{i}.block.4.bias"] = (d,)
    n = len(c["encoder_rates"]) + 1
    out[f"{e}.{n}.alpha"] = (1, d, 1)
    out.update(_wn(f"{e}.{n + 1}", (d, d, 3)))
    out[f"{e}.{n + 1}.bias"] = (d,)
    latent, dc = d, c["codebook_dim"]
    for q in range(c["n_codebooks"]):
        p = f"{prefix}.quantizer.quantizers.{q}"
        out.update(_wn(f"{p}.in_proj", (dc, latent, 1)))
        out[f"{p}.in_proj.bias"] = (dc,)
        out.update(_wn(f"{p}.out_proj", (latent, dc, 1)))
        out[f"{p}.out_proj.bias"] = (latent,)
        out[f"{p}.codebook.weight"] = (c["codebook_size"], dc)
    m = f"{prefix}.decoder.model"
    ch = c["decoder_dim"]
    out.update(_wn(f"{m}.0", (ch, latent, 7)))
    out[f"{m}.0.bias"] = (ch,)
    for i, s in enumerate(c["decoder_rates"], start=1):
        cin, ch = ch, ch // 2
        out[f"{m}.{i}.block.0.alpha"] = (1, cin, 1)
        out.update(_wn(f"{m}.{i}.block.1", (cin, ch, 2 * s)))
        out[f"{m}.{i}.block.1.bias"] = (ch,)
        for u in range(3):
            out.update(_unit(f"{m}.{i}.block.{u + 2}", ch))
    n = len(c["decoder_rates"]) + 1
    out[f"{m}.{n}.alpha"] = (1, ch, 1)
    out.update(_wn(f"{m}.{n + 1}", (1, ch, 7)))
    out[f"{m}.{n + 1}.bias"] = (1,)
    return out


def latent_dim(codec: dict) -> int:
    return codec["encoder_dim"] * 2 ** len(codec["encoder_rates"])


def s2a_shapes(c: dict, codec: dict) -> dict[str, tuple[int, ...]]:
    h, latent = c["hidden_size"], latent_dim(codec)
    q, n = codec["n_codebooks"], codec["codebook_size"]
    out = {"mask_token": (1, 1, h)}
    out.update(codec_shapes(codec))
    out.update({"semantic_embedding.weight": (c["num_semantic_tokens"], h),
                "acoustic_feat_proj.0.weight": (h, latent), "acoustic_feat_proj.0.bias": (h,),
                "acoustic_feat_proj.1.weight": (h,), "acoustic_feat_proj.1.bias": (h,)})
    for i in range(c["encoder_num_layers"]):
        out.update(block_shapes(f"encoder.layers.{i}", h, c["encoder_num_heads"],
                                h // c["encoder_num_heads"], c["encoder_ff_mult"],
                                c["encoder_conv_kernel_size"]))
    for j in range(len(c["injection_layers"])):
        p = f"encoder.project_injection.{j}"
        out.update({f"{p}.0.weight": (h, latent), f"{p}.0.bias": (h,),
                    f"{p}.1.weight": (h,), f"{p}.1.bias": (h,)})
    rem = q - len(c["injection_layers"])
    out.update({"encoder.fine_head.0.weight": (h * rem, h), "encoder.fine_head.0.bias": (h * rem,),
                "encoder.to_logits.0.weight": (h,), "encoder.to_logits.0.bias": (h,),
                "encoder.to_logits.1.weight": (q, h, n), "encoder.to_logits.1.bias": (1, 1, q, n)})
    return out

"""The benchmark's arithmetic of work and bytes against hand counts,
against torch's own count of the reference's products, and against the
port's launches at tiny sizes on the CPU."""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith, weights
from portbench.reference import model as ref
from portbench.reference import shapes
from portbench.tests import tiny


def _count(fn) -> dict[str, int]:
    with FlopCounterMode(display=False) as fc:
        fn()
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_least_time_by_hand():
    # 2 x 64 x 64 x 64 products, 3 x 64 x 64 bf16 in and out
    flops, nbytes = 2 * 64**3, 3 * 64 * 64 * 2
    assert arith.least_s(flops, nbytes) == max(flops / 989e12, nbytes / 3.35e12)
    assert arith.least_s(1.0, 1.0, exps=3.9e12) == 1.0
    # K5 at M 4, K 32, N 128: bytes 4*32*2 + 32*128 + 128*4 + 4*128*2 bound it
    want = (256 + 4096 + 512 + 1024) / 3.35e12
    assert arith.int8_least_s(Counter({(4, 32, 128): 1})) == pytest.approx(want)
    # K1 at B 1, T 10, C 8: operations 2*10*64*8, bytes 2*2*10*8 + 2*8*64 + 4*24
    assert arith.resunit_least_s(Counter({(1, 10, 8, 1): 2})) == pytest.approx(
        2 * (2 * 2 * 80 + 2 * 8 * 64 + 96) / 3.35e12)


def test_block_flops_by_hand():
    arch = {"heads": 2, "dim_head": 4, "ff_mult": 2, "kernel": 3, "depth": 1}
    dim, length = 8, 5
    inner, ff = 8, 16
    linear = 2 * length * (2 * 2 * dim * ff + dim * inner * 4 + dim * 4 * dim + 2 * dim * dim)
    assert arith.block_flops(arch, dim, length) == (
        linear + 4 * length * length * inner + 2 * length * 3 * 2 * dim)


def test_t2s_pass_and_length_predictor_against_the_flop_counter():
    c = tiny.T2S
    p = ref.Params(weights.make_state(shapes.t2s_shapes(c), 1, dtype=torch.float32, device="cpu"))
    length = 37
    tok = torch.randint(5, 300, (2, length))
    got = sum(_count(lambda: ref.t2s_logits(p, c, tok, torch.ones(2, length, dtype=torch.bool)))
              .values())
    main = arith.t2s_arch(c, "main_encoder")
    h = c["hidden_size"]
    assert got == 2 * (main["depth"] * arith.block_flops(main, h, length)
                       + 2 * length * (h * h + h * c["semantic_vocab_size"]))
    text = torch.randint(5, 200, (1, 9))
    got = sum(_count(lambda: ref.t2s_log_length(p, c, text, torch.ones(1, 9, dtype=torch.bool)))
              .values())
    lp = arith.t2s_arch(c, "length_predictor")
    assert got == lp["depth"] * arith.block_flops(lp, h, 10) + 2 * h


def test_s2a_passes_decode_and_training_step_against_the_flop_counter():
    s2c, codec = tiny.S2A, tiny.CODEC
    state = weights.make_state(shapes.s2a_shapes(s2c, codec), 2, dtype=torch.float32,
                               device="cpu")
    p = ref.Params(state)
    arch, h = arith.s2a_arch(s2c), s2c["hidden_size"]
    d, n = arith.latent_dim(codec), codec["codebook_size"]
    length = 11
    x = torch.randn(1, length, h)
    got = sum(_count(lambda: ref.s2a_first_level(p, s2c, x, None)).values())
    assert got == (s2c["injection_layers"][0] + 1) * arith.block_flops(arch, h, length) \
        + 2 * length * h * n
    frames = 13
    codes = torch.randint(0, n, (1, codec["n_codebooks"], frames))
    assert sum(_count(lambda: ref.decode(p, codec, codes)).values()) == \
        arith.decode_flops(codec, frames)

    batch = 2
    params = {k: t.clone().requires_grad_(not k.startswith("acoustic_model.")) for k, t in
              state.items()}
    pg = ref.Params(params)
    acoustic = torch.randint(0, n, (batch, codec["n_codebooks"], frames))
    semantic = torch.randint(0, s2c["num_semantic_tokens"], (batch, frames))
    mask = torch.rand(batch, frames) < 0.5
    out = {}
    fwd = _count(lambda: out.setdefault(
        "loss", ref.s2a_train_loss(pg, s2c, codec, acoustic, semantic, mask)[0]))
    bwd = _count(lambda: out["loss"].backward())
    # torch counts a grouped (depthwise) convolution's backward as dense:
    # count it as the forward's two products instead
    counted = sum(fwd.values()) + bwd["aten.mm"] + bwd["aten.bmm"] + 2 * fwd["aten.convolution"]
    assert counted == arith.s2a_train_flops(s2c, codec, batch, frames)


def _engine_shapes(monkeypatch, offline: bool):
    """K5's (M, K, N) and K1's (B, T, C, dilation) of one tiny engine call on
    the CPU, counted at the port's own call sites."""
    from edm_tts_tpu_torch.models.codec import layers
    from edm_tts_tpu_torch.ops import qdense

    from portbench import serving

    k5, k1 = Counter(), Counter()
    real_dense = qdense.int8_dense

    def dense(x, kernel_q, kernel_scale, **kw):
        k5[(x.reshape(-1, x.shape[-1]).shape[0],) + tuple(kernel_q.shape)] += 1
        return real_dense(x, kernel_q, kernel_scale, **kw)

    real_unit = layers.ResidualUnit.forward

    def unit(self, x):
        k1[(x.shape[0], x.shape[1], x.shape[2], self.dilation)] += 1
        return real_unit(self, x)

    monkeypatch.setattr(qdense, "int8_dense", dense)
    monkeypatch.setattr(layers.ResidualUnit, "forward", unit)
    cfg = tiny.SERVE_CONFIG
    served = serving.build(cfg, 4, torch.device("cpu"))
    texts = ["abc def.", "ghijklmnopqrstu vw."]
    gt = None if offline else [7, 19]
    waves = served.engine.synthesize(texts, "spk", seed=5, gt_lengths=gt)
    frames = max(len(w) for w in waves) // ref.hop(cfg["codec"])
    sv = cfg["serving"]
    nb = min(-(-frames // sv["length_bucket"]) * sv["length_bucket"], sv["max_speech_len"])
    lt = -(-max(len(t) for t in texts) // sv["text_bucket"]) * sv["text_bucket"]
    return k5, k1, (2, lt, nb)


@pytest.mark.parametrize("offline", [True, False])
def test_engine_launches_match_the_ports_call_sites(monkeypatch, offline):
    k5, k1, (rows, lt, nb) = _engine_shapes(monkeypatch, offline)
    cfg = tiny.SERVE_CONFIG
    assert k5 == arith.int8_launches(cfg, rows, lt, nb, predicted=offline)
    assert k1 == arith.resunit_launches(cfg["codec"], rows, nb)


def test_attention_least_time_by_hand():
    b, t, h, d = 2, 16, 2, 8
    scores = b * h * t * t
    io = b * t * h * d * 2
    fwd = arith.least_s(4 * scores * d, 4 * io + 4 * b * h * t, scores)
    bwd = arith.least_s(10 * scores * d, 8 * io + 8 * b * h * t, scores)
    assert arith.attention_fwd_bwd_least_s(b, t, h, d) == fwd + bwd

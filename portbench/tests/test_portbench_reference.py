"""The benchmark's frozen reference against the port's plain path (the
port's CPU path, f32) at tiny widths, on the same seeded weights."""

from __future__ import annotations

import torch

from portbench import serving, weights
from portbench.reference import model as ref
from portbench.reference import shapes
from portbench.reference.noise import gumbel_lanes, iteration_seeds
from portbench.tests import tiny


def _close(a, b, tol=2e-5):
    a, b = a.float(), b.float()
    assert (a - b).norm() <= tol * b.norm(), float((a - b).norm() / b.norm())


def test_t2s_logits_and_length_match_the_port():
    cfg = tiny.SERVE_CONFIG
    served = serving.build(cfg, 11, torch.device("cpu"))
    t2s, c = served.engine.t2s, cfg["t2s"]
    p = ref.Params(served.t2s_state, quantize="int8")
    text = torch.randint(5, 200, (2, 8))
    text_len = torch.tensor([8, 5])
    text_mask = torch.arange(8)[None] < text_len[:, None]
    with torch.no_grad():
        _close(ref.t2s_log_length(p, c, text, text_mask),
               t2s.predict_log_length(text, text_mask, mask_conv=True))
        canvas, attention, _ = ref.build_canvas(text, text_len, torch.tensor([20, 9]), 48)
        _close(ref.t2s_logits(p, c, canvas, attention),
               t2s.embeddings_to_logits(t2s.embed(canvas), attention, conv_pad_mask=attention))


def test_s2a_passes_and_decode_match_the_port():
    cfg = tiny.SERVE_CONFIG
    served = serving.build(cfg, 12, torch.device("cpu"))
    s2a, c, codec = served.engine.s2a, cfg["s2a"], cfg["codec"]
    p = ref.Params(served.s2a_state, quantize="int8")
    tp, t = 6, 10
    x = torch.randn(2, tp + t, c["hidden_size"])
    pad = torch.ones(2, tp + t, dtype=torch.bool)
    pad[1, -3:] = False
    prompt = torch.randint(0, codec["codebook_size"], (2, codec["n_codebooks"], tp))
    cum = torch.cumsum(s2a.acoustic_features_unreduced(prompt), dim=1)
    n_inj = len(c["injection_layers"])
    prompt_inj = torch.stack([torch.cat([cum[:, i], cum.new_zeros(2, t, cum.shape[-1])], 1)
                              for i in range(n_inj)])
    mask_time = torch.cat([torch.zeros(2, tp, dtype=torch.bool), torch.ones(2, t,
                                                                           dtype=torch.bool)], 1)
    with torch.no_grad():
        _close(ref.s2a_first_level(p, c, x, pad), s2a.forward_first_level(x, pad))
        logits = s2a.forward_logits(x, prompt_injections=prompt_inj, mask_time=mask_time,
                                    pad_mask=pad, generated_start=tp)
        codes = logits.argmax(-1)
        gen = torch.cumsum(ref.codec_features(p, codec, codes[:, :n_inj]), 1)
        ref_prompt = torch.cumsum(ref.codec_features(p, codec, prompt), 1)[:, :n_inj]
        injected = torch.cat([ref_prompt, gen], 2).transpose(0, 1)
        _close(ref.s2a_full_logits(p, c, codec, x, injected, pad, tp), logits)
        _close(ref.decode(p, codec, codes[:1]), s2a.decode_audio(codes[:1])[..., 0])


def test_training_loss_and_gradient_match_the_port():
    from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
    from edm_tts_tpu_torch.train.run_s2a import s2a_loss

    s2c, codec = tiny.S2A, tiny.CODEC
    state = weights.make_state(shapes.s2a_shapes(s2c, codec), 3, dtype=torch.float32,
                               device="cpu")
    model = InjectionConformer(S2AConfig.from_dict({**s2c, "codec": codec}))
    weights.load_into(model, state)
    model.acoustic_model.requires_grad_(False)
    acoustic = torch.randint(0, codec["codebook_size"], (2, codec["n_codebooks"], 12))
    semantic = torch.randint(0, s2c["num_semantic_tokens"], (2, 12))
    mask = torch.rand(2, 12) < 0.5
    _, loss_fn = s2a_loss(model, bf16=False)
    loss, _ = loss_fn({"acoustic_tokens": acoustic, "semantic_tokens": semantic, "mask": mask},
                      None)
    loss.backward()
    params = {k: t.clone().requires_grad_(not k.startswith("acoustic_model.")) for k, t in
              state.items()}
    ref_loss, _ = ref.s2a_train_loss(ref.Params(params), s2c, codec, acoustic, semantic, mask)
    ref_loss.backward()
    _close(loss, ref_loss, 1e-6)
    for name, prm in model.named_parameters():
        if prm.requires_grad:
            _close(prm.grad, params[name].grad, 1e-4)


def test_the_samplers_noise_is_the_ports():
    from edm_tts_tpu_torch.ops import positional_categorical

    logits = torch.randn(3, 7, 5)
    rows = torch.arange(3)
    assert torch.equal((logits + gumbel_lanes(1234, rows, 7, 5)).argmax(-1),
                       positional_categorical(1234, logits))
    gen = torch.Generator().manual_seed(99)
    draws = [torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist() for _ in range(5)]
    assert iteration_seeds(99, 3, 2) == (draws[:3], draws[3:])


def test_int8_dequantization_is_the_ports():
    from edm_tts_tpu_torch.ops.qdense import quantize_weight

    w = torch.randn(256, 64)
    q, scale = quantize_weight(w.t())
    assert torch.equal(ref.quantize_int8(w), (q.float() * scale).t())

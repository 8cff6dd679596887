"""The port's prompt tokenization against edm_tts_tpu's: the codec encoder
and RVQ encode, the semantic tokenizer, ``AudioTokenizer``, the resampler,
the nearest-centroid assignment and the loudness copy.

Tiny models (``TINY_CODEC``; HuBERTs of tests/torch_port_parity.py) with the
same weights on both sides, f32 on the CPU. Latents: atol/rtol 1e-4, as
tests/test_torch_codec.py (same math, other summation order). Ids and codes
must be equal, and each test also asserts that its inputs leave every
argmin a gap of more than ten times the largest difference between the
two packages' distances on those inputs (``_hold_argmin``), so that the
equality is not luck: the f32 noise between the implementations is
~1e-6 here, far below the ~6e-3 of tiny models' logits. The resampler:
atol 1e-5 (one f32 strided convolution). The loudness copy: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.hubert import HUBERT_TINY_TEST as J_TINY
from edm_tts_tpu.models.hubert import HubertModel as JHubertModel
from edm_tts_tpu.models.hubert import normalize_input as j_normalize_input
from edm_tts_tpu.models.tokenizer import AudioTokenizer as JAudioTokenizer
from edm_tts_tpu.models.tokenizer import SemanticTokenizerHubert as JSemantic
from edm_tts_tpu.ops import convolution as j_conv
from edm_tts_tpu.ops import loudness as j_loudness
from edm_tts_tpu.ops.kmeans import _assign as j_assign
from edm_tts_tpu.ops.resample import resample_numpy as j_resample_numpy
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.codec import Codec, pad_audio_to_hop
from edm_tts_tpu_torch.models.codec.rvq import _l2n
from edm_tts_tpu_torch.models.hubert import HUBERT_TINY_TEST, hf_state_dict_from_jax_params
from edm_tts_tpu_torch.models.hubert import load_hf_state_dict
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer, SemanticTokenizerHubert
from edm_tts_tpu_torch.ops import convolution, loudness
from edm_tts_tpu_torch.ops.kmeans import assign, sq_distances
from edm_tts_tpu_torch.ops.resample import resample, resample_numpy
from torch_port_parity import argmin_gap, codec_pair, hubert_pair, random_variables

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def codecs():
    return codec_pair(seed=0)


@pytest.fixture(scope="module")
def tokenizers(codecs):
    """(JAX tokenizer, codec variables, semantic params, port tokenizer)."""
    jcodec, variables, codec = codecs
    jsem, sem_params, sem = hubert_pair(seed=0)
    return JAudioTokenizer(jcodec, jsem), variables, sem_params, AudioTokenizer(codec, sem)


def _wav(rng, *shape):
    """Speech-like level: a few low-passed tones in noise."""
    t = np.arange(shape[-1]) / 16000.0
    tones = sum(np.sin(2 * np.pi * f * t + p) for f, p in ((140, 0.3), (410, 1.1), (1230, 2.0)))
    return (0.1 * tones + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _assert_margin(d, d_ref) -> None:
    """The port's distances ``d`` leave each argmin a gap above ten times
    their largest difference from ``d_ref``, the same distances from the
    JAX package's features."""
    noise = float((d.detach() - torch.as_tensor(np.asarray(d_ref))).abs().max())
    assert argmin_gap(d) > 10 * noise, (argmin_gap(d), noise)


def _hold_argmin(d, d_ref, ids, ids_ref) -> None:
    """``ids`` equal to ``ids_ref``, with ``_assert_margin(d, d_ref)``."""
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))
    _assert_margin(d, d_ref)


def _rvq_distances(codec: Codec, latents) -> torch.Tensor:
    """Each level's distances of its in-projection ``latents[:, :, q]`` to its
    normalized codebook, ``(Q, B, T, N)``."""
    latents = torch.as_tensor(np.array(latents))
    with torch.no_grad():
        return torch.stack([sq_distances(_l2n(latents[:, :, q]), _l2n(vq.codebook.weight))
                            for q, vq in enumerate(codec.quantizer.quantizers[:latents.shape[2]])])


def _codes_margin(tok, jtok, variables, sem_params, normalized, padded, mask=None) -> None:
    """``_assert_margin`` of both streams' distances against those from the
    JAX tokenizer's features of the same inputs (each row's valid frames)."""
    norm_t, pad_t = torch.from_numpy(normalized), torch.from_numpy(padded)
    mask_t = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        lat = tok.codec.encode(norm_t[..., None])["latents"]
        hidden = tok.semantic.hidden_states(pad_t, mask_t)
    j_lat = jax.jit(lambda v, a: jtok.codec.apply(v, a, method=JCodec.encode)["latents"])(
        variables, jnp.asarray(normalized)[..., None])
    j_mask = None if mask is None else jnp.asarray(mask)
    j_hidden = jax.jit(lambda p, a, m: jtok.semantic.model.apply(
        p, j_normalize_input(a, m), m, output_layer=tok.semantic.output_layer))(
        sem_params["hubert"], jnp.asarray(padded), j_mask)
    centers = tok.semantic.cluster_centers
    for i in range(len(padded)):
        n = lat.shape[1] if mask is None else int(tok.get_code_lengths(int(mask[i].sum())))
        _assert_margin(_rvq_distances(tok.codec, lat[i:i + 1, :n]),
                       _rvq_distances(tok.codec, np.asarray(j_lat)[i:i + 1, :n]))
        _assert_margin(sq_distances(hidden[i, :n], centers),
                       sq_distances(torch.from_numpy(np.asarray(j_hidden)[i, :n]), centers))


def test_length_arithmetic_and_pad_equal_jax(tokenizers):
    jtok, _, _, tok = tokenizers
    lengths = np.arange(1, 5000, 7)
    for k, s, p, d in ((7, 1, 3, 1), (4, 2, 1, 1), (10, 5, 3, 1), (16, 8, 4, 1), (7, 1, 27, 9)):
        np.testing.assert_array_equal(convolution.conv1d_output_length(lengths, k, s, p, d),
                                      j_conv.conv1d_output_length(lengths, k, s, p, d))
    np.testing.assert_array_equal(tok.get_code_lengths(lengths), jtok.get_code_lengths(lengths))
    assert int(convolution.encoder_output_length(torch.tensor(160160), (2, 4, 5, 8))) == 500
    for n in (1, 319, 320, 321, 4801, 16000):
        x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
        np.testing.assert_array_equal(tok.pad(x), jtok.pad(x))
    audio = np.ones((2, 333, 1), np.float32)
    from edm_tts_tpu.models.codec import pad_audio_to_hop as j_pad_audio_to_hop
    np.testing.assert_array_equal(pad_audio_to_hop(torch.from_numpy(audio), 320).numpy(),
                                  np.asarray(j_pad_audio_to_hop(jnp.asarray(audio), 320)))


def test_encoder_and_rvq_encode_match_jax(codecs):
    """The encoder's latents, the quantized sum and each level's
    in-projection within TOL; the codes equal, also with n_quantizers."""
    jmodel, variables, model = codecs
    audio = _wav(np.random.default_rng(0), 2, 3200)[..., None]
    for nq in (None, 2):
        ref = jax.jit(lambda v, a, nq=nq: jmodel.apply(v, a, nq, method=JCodec.encode))(
            variables, jnp.asarray(audio))
        with torch.no_grad():
            out = model.encode(torch.from_numpy(audio), nq)
        for key in ("z_e", "z", "latents"):
            assert out[key].shape == ref[key].shape, key
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
        _hold_argmin(_rvq_distances(model, out["latents"]), _rvq_distances(model, ref["latents"]),
                     out["codes"], ref["codes"])
    with torch.no_grad():
        codes = model.encode_to_codes(torch.from_numpy(audio))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jmodel.apply(variables, jnp.asarray(audio), method=JCodec.encode_to_codes)))


def test_from_latents_and_continuous_to_codes_match_jax(codecs):
    jmodel, variables, model = codecs
    rng = np.random.default_rng(1)
    q = model.quantizer
    dc = q.codebook_dim
    for nq in (1, 3):
        latents = rng.standard_normal((2, 9, nq * dc)).astype(np.float32)
        ref = jmodel.apply(variables, jnp.asarray(latents),
                           method=lambda m, x: m.quantizer.from_latents(x))
        with torch.no_grad():
            out = q.from_latents(torch.from_numpy(latents))
        for o, r in zip(out[:2], ref[:2]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
        # the inputs are the same numbers on both sides: the noise is the
        # distances' own f32 rounding, against a float64 evaluation
        parts = latents.reshape(2, 9, nq, dc)
        d64 = [(lambda e, c: (e * e).sum(-1)[..., None] - 2 * e @ c.T + (c * c).sum(-1))(
                   *(x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (
                       parts[:, :, i].astype(np.float64),
                       vq.codebook.weight.detach().numpy().astype(np.float64))))
               for i, vq in enumerate(q.quantizers[:nq])]
        _hold_argmin(_rvq_distances(model, parts), np.stack(d64), out[2], ref[2])
    feats = rng.standard_normal((2, 6, model.config.latent_dim)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(feats),
                       method=lambda m, x: m.quantizer.continuous_to_codes(x))
    with torch.no_grad():
        np.testing.assert_array_equal(q.continuous_to_codes(torch.from_numpy(feats)).numpy(),
                                      np.asarray(ref))


def test_semantic_ids_match_jax(tokenizers):
    _, _, sem_params, tok = tokenizers
    jsem = JSemantic(tok.semantic.config, output_layer=1)
    audio = _wav(np.random.default_rng(2), 2, 6400)
    with torch.no_grad():
        hidden = tok.semantic.hidden_states(torch.from_numpy(audio))
        ids = tok.semantic.encode(torch.from_numpy(audio))
    j_hidden = jax.jit(lambda p, a: jsem.model.apply(p, j_normalize_input(a), output_layer=1))(
        sem_params["hubert"], jnp.asarray(audio))
    centers = tok.semantic.cluster_centers
    _hold_argmin(sq_distances(hidden, centers),
                 sq_distances(torch.from_numpy(np.asarray(j_hidden)), centers),
                 ids, jsem.encode(sem_params, jnp.asarray(audio)))
    assert len(np.unique(ids.numpy())) > 2  # the centroids spread the ids


@pytest.mark.parametrize("shape", [(1, 4801), (2, 9599)])
def test_compute_codes_matches_jax(tokenizers, shape):
    """Odd-length wavs: the aligned codes and the input loudness."""
    jtok, variables, sem_params, tok = tokenizers
    audio = _wav(np.random.default_rng(shape[1]), *shape)
    out = tok.compute_codes(audio)
    ref = jtok.compute_codes(variables, sem_params, audio)
    n = tok.get_code_lengths(tok.pad(audio).shape[-1])
    assert out["acoustic_codes"].shape == (shape[0], 4, n)
    assert out["semantic_codes"].shape == (shape[0], n)
    np.testing.assert_array_equal(out["acoustic_codes"].numpy(), np.asarray(ref["acoustic_codes"]))
    np.testing.assert_array_equal(out["semantic_codes"].numpy(), np.asarray(ref["semantic_codes"]))
    np.testing.assert_array_equal(out["input_db"], ref["input_db"])
    padded = tok.pad(audio)
    _codes_margin(tok, jtok, variables, sem_params,
                  loudness.normalize_loudness(padded, 16000)[0], padded)


def test_compute_codes_batch_with_mask_matches_jax(tokenizers):
    """A padded batch with HuBERT's attention mask: equal ids and codes, and
    each row's valid frames equal to that row's exact-size call."""
    jtok, variables, sem_params, tok = tokenizers
    rng = np.random.default_rng(7)
    lengths = (6400, 4480, 3200)
    rows = [tok.pad(_wav(rng, n)) for n in lengths]
    t = max(len(r) for r in rows)
    padded = np.stack([np.pad(r, (0, t - len(r))) for r in rows])
    mask = (np.arange(t)[None] < np.array([len(r) for r in rows])[:, None]).astype(np.int32)
    normalized = np.stack([np.pad(loudness.normalize_loudness(r[None], 16000)[0][0],
                                  (0, t - len(r))) for r in rows])
    out = tok.compute_codes_batch(normalized, padded, mask)
    ref = jtok.compute_codes_batch(variables, sem_params, normalized, padded, mask)
    for key in ("acoustic_codes", "semantic_codes"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    _codes_margin(tok, jtok, variables, sem_params, normalized, padded, mask)
    for i, r in enumerate(rows):
        n = int(tok.get_code_lengths(len(r)))
        alone = tok.compute_codes_batch(normalized[i:i + 1, :len(r)], r[None])
        np.testing.assert_array_equal(out["semantic_codes"][i, :n].numpy(),
                                      alone["semantic_codes"][0].numpy())
        np.testing.assert_array_equal(out["acoustic_codes"][i, :, :n - 1].numpy(),
                                      alone["acoustic_codes"][0, :, :n - 1].numpy())


def test_frame_mismatch_raises_as_in_jax(codecs):
    """A HuBERT that downsamples by 10, not 320: both packages refuse."""
    jcodec, variables, codec = codecs
    jvars = random_variables(lambda r: JHubertModel(J_TINY).init(r, jnp.zeros((1, 1280))), 3)
    sem = SemanticTokenizerHubert(HUBERT_TINY_TEST, output_layer=1, num_clusters=4)
    load_hf_state_dict(sem.hubert, hf_state_dict_from_jax_params(HUBERT_TINY_TEST, jvars))
    jsem = JSemantic(J_TINY, output_layer=1)
    audio = _wav(np.random.default_rng(3), 1, 3200)
    with pytest.raises(ValueError, match="mismatch"):
        AudioTokenizer(codec, sem).compute_codes(audio)
    with pytest.raises(ValueError, match="mismatch"):
        JAudioTokenizer(jcodec, jsem).compute_codes(
            variables, jsem.make_params(jvars, np.zeros((4, 32), np.float32)), audio)
    with pytest.raises(ValueError, match="semantic"):
        AudioTokenizer(codec, None).compute_codes(audio)


@pytest.mark.parametrize("orig", [24000, 44100, 22050, 8000])
def test_resample_matches_jax(orig):
    x = np.random.default_rng(orig).standard_normal((2, orig // 10 + 7)).astype(np.float32)
    ref = j_resample_numpy(x, orig, 16000)
    out = resample_numpy(x, orig, 16000)
    assert out.shape == ref.shape == (2, int(np.ceil((orig // 10 + 7) * 16000 / orig)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(resample(torch.from_numpy(x[0]), orig, 16000).numpy(), ref[0],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(resample_numpy(x, 16000, 16000), x)


def test_assign_matches_jax():
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((32, 16)).astype(np.float32)
    x = (centers[rng.integers(0, 32, 300)] + 0.3 * rng.standard_normal((300, 16))).astype(np.float32)
    labels, dist = assign(torch.from_numpy(x), torch.from_numpy(centers))
    j_labels, j_dist = j_assign(jnp.asarray(x), jnp.asarray(centers))
    x64, c64 = x.astype(np.float64), centers.astype(np.float64)
    d64 = (x64 * x64).sum(-1)[:, None] - 2 * x64 @ c64.T + (c64 * c64).sum(-1)
    _hold_argmin(sq_distances(torch.from_numpy(x), torch.from_numpy(centers)), d64,
                 labels, j_labels)
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), atol=1e-4, rtol=1e-5)


def test_exact_f32_holds_tf32_off_until_the_last_thread_leaves():
    """Two threads in ``exact_f32`` at once, as two POST /speakers on the
    server's handler threads: TF32 stays off while either is inside, the
    switches it turned off come back on only when the last leaves, and a
    switch that was off stays off."""
    import threading

    from edm_tts_tpu_torch.ops.precision import exact_f32

    switches = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [s.allow_tf32 for s in switches]
    a_inside, b_left = threading.Event(), threading.Event()
    seen = {}

    def first():
        with exact_f32():
            a_inside.set()
            b_left.wait(10)
            seen["first, after the second left"] = [s.allow_tf32 for s in switches]

    def second():
        a_inside.wait(10)
        with exact_f32():
            seen["second, inside"] = [s.allow_tf32 for s in switches]
        b_left.set()

    try:
        for flags in ([True, True], [False, True]):
            for s, on in zip(switches, flags):
                s.allow_tf32 = on
            seen.clear()
            a_inside.clear()
            b_left.clear()
            threads = [threading.Thread(target=f) for f in (first, second)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(20)
            assert seen == {"second, inside": [False, False],
                            "first, after the second left": [False, False]}
            assert [s.allow_tf32 for s in switches] == flags
    finally:
        for s, on in zip(switches, saved):
            s.allow_tf32 = on


def test_loudness_copy_is_bit_equal():
    rng = np.random.default_rng(6)
    cases = [rng.standard_normal((2, 24000)) * 0.1,  # a batch
             rng.standard_normal(4000) * 0.3,         # under 0.5 s: zero-padded
             np.zeros(16000),                         # silence: -70 LUFS
             _wav(rng, 1, 16321)]
    for sr in (16000, 24000):
        for audio in cases:
            audio = np.asarray(audio, np.float32)
            np.testing.assert_array_equal(loudness.k_weight(audio, sr), j_loudness.k_weight(audio, sr))
            np.testing.assert_array_equal(loudness.integrated_loudness(audio, sr),
                                          j_loudness.integrated_loudness(audio, sr))
            for a, b in zip(loudness.normalize_loudness(audio, sr, -16.0),
                            j_loudness.normalize_loudness(audio, sr, -16.0)):
                np.testing.assert_array_equal(a, b)


def test_encoder_weights_are_packed_at_load(codecs):
    """Loading packs every encoder unit as K1 takes it; an unpacked one
    refuses to run rather than lay its weights out per call."""
    jmodel, variables, model = codecs
    units = [m for m in model.encoder.modules() if type(m).__name__ == "ResidualUnit"]
    assert len(units) == 12 and all(u.kernel_args is not None for u in units)
    from edm_tts_tpu.models.codec.convert import to_torch_state_dict
    fresh = Codec(model.config)
    fresh.load_state_dict(model.state_dict())  # a plain load does not pack
    with pytest.raises(RuntimeError, match="not packed"):
        fresh.encode_to_codes(torch.zeros(1, 640, 1))
    load_reference_state_dict(fresh, to_torch_state_dict(jmodel.config, variables))
    with torch.no_grad():
        torch.testing.assert_close(fresh.encode_to_codes(torch.zeros(1, 640, 1)),
                                   model.encode_to_codes(torch.zeros(1, 640, 1)))



def _bf16_copy(tok: AudioTokenizer) -> AudioTokenizer:
    """``tok`` with its codec encoder and HuBERT in bf16, the same weights
    rounded (the RVQ and the centroids stay f32)."""
    import copy

    codec16, sem16 = copy.deepcopy(tok.codec), copy.deepcopy(tok.semantic)
    codec16.encoder.to(torch.bfloat16)
    codec16.dtype = torch.bfloat16
    codec16.pack()
    sem16.hubert.to(torch.bfloat16)
    return AudioTokenizer(codec16, sem16)


def _narrow_tokenizer() -> AudioTokenizer:
    """A narrow stand-in for path (g)'s models, f32: HuBERT with 128-channel
    convs, hidden 256 and 18 layers, 256 centroids drawn from its own states
    on a seeded 6 s waveform; the codec at encoder_dim 16."""
    from edm_tts_tpu_torch.convert import init_random_weights
    from edm_tts_tpu_torch.models.codec import CodecConfig
    from edm_tts_tpu_torch.models.hubert import HubertConfig
    from edm_tts_tpu_torch.profile_tokenization import prompt_wav

    cfg = HubertConfig(conv_dim=(128,) * 7, hidden_size=256, num_hidden_layers=18,
                       num_attention_heads=4, intermediate_size=1024)
    sem = SemanticTokenizerHubert(cfg, 18, 256)
    init_random_weights(sem, 2)
    codec = Codec(CodecConfig(encoder_dim=16, decoder_dim=64))
    init_random_weights(codec, 0)
    with torch.no_grad():
        frames = sem.hidden_states(torch.from_numpy(prompt_wav(6.0, 1, 16000))[None])[0]
    pick = torch.randperm(frames.shape[0], generator=torch.Generator().manual_seed(0))[:256]
    sem.cluster_centers.copy_(frames[pick])
    return AudioTokenizer(codec, sem)


@pytest.mark.parametrize("size", ["tiny", "narrow"])
def test_bf16_flip_share_on_the_cpu(tokenizers, size):
    """The share of ids and level-0 codes that flip when the tokenizer's
    models run in bf16 instead of f32 on the CPU (the card runs them in
    bf16; chip_smoke.py measures the same at full width): the tiny models
    on 4 x 1 s, and a narrow 18-layer stand-in on a 3 s and a 10 s prompt at
    24 kHz (``profile_tokenization.prompt_wav``). Random weights are a worst
    case; the test prints the shares (``-s``) and holds them under 10 %.
    oneDNN is off for the bf16 runs: this PyTorch's oneDNN bf16 grouped
    convolution at 4 groups and k=16 (the tiny positional conv) is off by a
    relative l2 of ~1 on the CPU, where its plain CPU kernel is not."""
    from edm_tts_tpu_torch.profile_tokenization import prompt_wav

    tok = tokenizers[3] if size == "tiny" else _narrow_tokenizer()
    tok16 = _bf16_copy(tok)
    if size == "tiny":
        prompts = [_wav(np.random.default_rng(11), 4, 16000)]
    else:
        prompts = [resample_numpy(prompt_wav(s, int(s)), 24000, 16000)[None] for s in (3.0, 10.0)]
    for audio in prompts:
        out32 = tok.compute_codes(audio)
        with torch.backends.mkldnn.flags(enabled=False):
            out16 = tok16.compute_codes(audio)
        semantic = (out32["semantic_codes"] != out16["semantic_codes"]).float().mean().item()
        level0 = (out32["acoustic_codes"][:, 0] != out16["acoustic_codes"][:, 0]).float().mean().item()
        print(f"bf16 vs f32 on the CPU, {size} models, {audio.shape[0]} x "
              f"{audio.shape[1] / 16000:.2f} s: semantic ids flip {semantic:.4f}, level-0 codes "
              f"{level0:.4f}")
        assert semantic < 0.1 and level0 < 0.1

"""The port's codec-training modules against the JAX package's, on the CPU
in f32: the spectral ops, the discriminator ensemble, the losses, the
train-mode RVQ and the codec's training API, its gradient, the data copies
and ``train.run_codec``.

Weights cross over through the JAX package's own converters
(``to_torch_state_dict`` and ``discriminator_to_torch_state_dict``, with
``weight_g`` / ``weight_v`` names) into the port's trainable modules, v and
g kept apart. Quantizer dropout: JAX's drawn thresholds are injected
(``thresholds=``), as torch cannot replay ``jax.random``. Tolerances:
spectra, feature maps and losses within 1e-5 of the reference's largest
magnitude (f32, other FFT and summation orders); codes equal (seeds whose
argmin gaps clear the f32 noise, ``_codes_margin``); gradients atol 2e-6 +
rtol 1e-4 (``GRAD_TOL`` of tests/test_torch_s2a_train.py).
"""

import ast
import functools
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.data import collators as j_collators
from edm_tts_tpu.data import manifests as j_manifests
from edm_tts_tpu.data import pipeline as j_pipeline
from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu.models.codec import CodecConfig as JCodecConfig
from edm_tts_tpu.models.codec import discriminator as j_disc
from edm_tts_tpu.models.codec import losses as j_losses
from edm_tts_tpu.models.codec.convert import discriminator_to_torch_state_dict
from edm_tts_tpu.models.codec.convert import to_torch_state_dict as codec_to_torch
from edm_tts_tpu.ops import spectral as j_spectral
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.data import collators, manifests, pipeline
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig, discriminator, losses
from edm_tts_tpu_torch.ops import spectral
from edm_tts_tpu_torch.train import run_codec
from edm_tts_tpu_torch.utils import hub
from flac_encoder import encode_flac
from torch_port_parity import random_variables

TOL = 1e-5
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
# tests/test_gan_trainer_loop.py's tiny models, plus one MSD rate
TINY_GAN_CODEC = dict(encoder_dim=4, decoder_dim=32, n_codebooks=2, codebook_size=16,
                      codebook_dim=4, quantizer_dropout=0.5)
TINY_DISC = dict(periods=(2,), fft_sizes=(128,), rates=(2,))
# JAX's dropout draw under this key: rows 0 and 1 at 2 and 1 levels
DROP_KEY = jax.random.PRNGKey(0)
TINY_MEL = {"n_mels": (5, 10), "window_lengths": (32, 64), "mel_fmin": (0.0, 0.0),
            "mel_fmax": (None, None)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread: these models are tiny, and the suite runs one
    worker per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def assert_close(out, ref, tol=TOL, what=""):
    """Every element within ``tol`` of the reference's largest magnitude."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (what, err, scale)


def gan_codec_pair(seed: int):
    """(JAX codec, its variables, port codec) at the tiny GAN size, same weights."""
    jcfg = JCodecConfig(**TINY_GAN_CODEC)
    jmodel = JCodec(jcfg)
    variables = random_variables(lambda r: jmodel.init(r, jnp.zeros((1, 640, 1))), seed)
    model = Codec(CodecConfig(**TINY_GAN_CODEC))
    load_reference_state_dict(model, codec_to_torch(jcfg, variables, legacy_wn=True))
    return jmodel, variables, model


def disc_pair(seed: int, cfg: dict = TINY_DISC):
    """(JAX Discriminator, its variables, port Discriminator), same weights."""
    jcfg = j_disc.DiscriminatorConfig(**cfg)
    jmodel = j_disc.Discriminator(jcfg)
    variables = random_variables(lambda r: jmodel.init(r, jnp.zeros((1, 640, 1))), seed)
    model = discriminator.Discriminator(discriminator.DiscriminatorConfig(**cfg))
    load_reference_state_dict(model, discriminator_to_torch_state_dict(jcfg, variables,
                                                                        legacy_wn=True))
    return jmodel, variables, model


def _audio(b: int, t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 16000
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (b, 1)) * tt)
    return (tone + 0.05 * rng.standard_normal((b, t)))[..., None].astype(np.float32)


# -- spectral ------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,t", [(2048, 512, 6080), (64, 16, 640), (32, 8, 643)])
def test_stft_and_spectrograms_match_jax(n_fft, hop, t):
    x = np.random.default_rng(n_fft).standard_normal((2, t)).astype(np.float32)
    n_mels = min(80, n_fft // 4)

    def all_of(mod, x):
        return (mod.stft(x, n_fft, hop), mod.spectrogram(x, n_fft, hop, power=1.0),
                mod.spectrogram(x, n_fft, hop, power=2.0),
                mod.mel_spectrogram(x, 16000, n_fft, n_mels, hop, power=2.0))

    refs = jax.jit(functools.partial(all_of, j_spectral))(jnp.asarray(x))
    outs = all_of(spectral, torch.from_numpy(x))
    assert outs[0].shape == (2, n_fft // 2 + 1, 1 + t // hop)
    for what, out, ref in zip(("stft", "magnitude", "power", "mel"), outs, refs):
        assert_close(out.numpy(), ref, what=what)
    np.testing.assert_array_equal(spectral.mel_filterbank(16000, n_fft, n_mels, 30.0, 7000.0),
                                  j_spectral.mel_filterbank(16000, n_fft, n_mels, 30.0, 7000.0))


# -- discriminator ---------------------------------------------------------------

@pytest.fixture(scope="module")
def discs():
    jmodel, variables, model = disc_pair(0)
    x = _audio(2, 640, 1)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return jmodel, variables, model, x, ref, out


def test_discriminator_state_dict_is_the_reference_one(discs):
    jmodel, variables, model, *_ = discs
    ref = discriminator_to_torch_state_dict(jmodel.config, variables, legacy_wn=True)
    own = model.state_dict()
    assert set(own) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)


def test_every_feature_map_matches_jax(discs):
    """MPD (period 2), MSD (rate 2) and MRD (n_fft 128): each map, NHWC /
    NTC on the JAX side, NCHW / NCT here."""
    *_, ref, out = discs
    assert len(out) == len(ref) == 3
    for d, (o_list, r_list) in enumerate(zip(out, ref)):
        assert len(o_list) == len(r_list)
        for i, (o, r) in enumerate(zip(o_list, r_list)):
            o = o.numpy()
            o = o.transpose(0, 2, 3, 1) if o.ndim == 4 else o.transpose(0, 2, 1)
            assert_close(o, r, what=(d, i))


def test_discriminator_gradient_matches_jax_grad(discs):
    """The LSGAN discriminator loss's gradient of every discriminator
    parameter (v and g apart) against ``jax.grad`` on the same inputs, at
    ``GRAD_TOL``."""
    jmodel, variables, model, x, *_ = discs
    real = _audio(2, 640, 9)

    def jloss(v):
        return j_losses.discriminator_loss(jmodel.apply(v, jnp.asarray(x)),
                                           jmodel.apply(v, jnp.asarray(real)))

    ref = discriminator_to_torch_state_dict(jmodel.config, jax.jit(jax.grad(jloss))(variables),
                                            legacy_wn=True)
    model.zero_grad(set_to_none=True)
    losses.discriminator_loss(model(torch.from_numpy(x)), model(torch.from_numpy(real))).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    for name, value in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), value, err_msg=name, **GRAD_TOL)


def test_mrd_bands_at_the_recipe_size_match_jax():
    """n_fft 2048 on a 0.38 s segment: match-stride padding, the centered
    STFT, the 2-frame trims and the 5 bands."""
    x = _audio(2, 6080, 2)
    ref = jax.jit(lambda a: j_disc.MRD(2048).apply({}, a, method=j_disc.MRD.spectrogram_bands))(
        jnp.asarray(x))
    out = discriminator.MRD(2048).spectrogram_bands(torch.from_numpy(x).transpose(1, 2))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert_close(o.permute(0, 2, 3, 1).numpy(), r)


# -- losses ----------------------------------------------------------------------

def test_every_loss_term_matches_jax(discs):
    x, y = _audio(2, 6080, 3), _audio(2, 6080, 4)
    xt, yt, xj, yj = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    args = dict(waveform_args={}, multi_scale_stft_args={"window_lengths": [256], "weight": 1},
                mel_spectrogram_args={**TINY_MEL, "pow": 2.0, "weight": 15.0})
    rec, jrec = losses.ReconstructionLoss(16000, **args), j_losses.ReconstructionLoss(16000, **args)
    assert rec.mel_args == jrec.mel_args

    def terms(mod, rec, x, y):
        out = rec(x, y)
        assert set(out) == {"waveform/loss", "stft/loss", "mel/loss"}
        return [
            mod.waveform_l1_loss(x, y), mod.multi_scale_stft_loss(x, y),
            mod.multi_scale_mel_loss(x, y, sample_rate=16000),  # the 7 recipe scales
            mod.multi_scale_mel_loss(x, y, sample_rate=16000, power=2.0, mag_weight=0.5),
            mod.sisdr_loss(x, y),
            mod.sisdr_loss(x, y, scaling=False, zero_mean=False, clip_min=-5.0),
            *(out[k] for k in sorted(out))]

    pairs = list(zip(terms(losses, rec, xt, yt),
                     jax.jit(functools.partial(terms, j_losses, jrec))(xj, yj)))
    *_, d_ref, d_out = discs

    def gan_terms(mod, fake, flip):
        real = [[flip(f) for f in fl] for fl in fake]  # another batch order: nonzero features
        return (mod.discriminator_loss(fake, fake[::-1]),
                *mod.generator_adversarial_losses(fake, real))

    pairs += list(zip(gan_terms(losses, d_out, lambda f: f.flip(0)),
                      jax.jit(lambda f: gan_terms(j_losses, f, lambda a: a[::-1]))(d_ref)))
    for i, (o, r) in enumerate(pairs):
        assert abs(float(o) - float(r)) <= TOL * abs(float(r)), (i, float(o), float(r))


# -- the codec's training API ------------------------------------------------------

def _codes_margin(latents: np.ndarray, codebooks: np.ndarray) -> float:
    """The smallest gap between the nearest and the second nearest
    normalized codebook vector over every row and level."""
    def l2n(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)

    gaps = []
    for q in range(codebooks.shape[0]):
        e, c = l2n(latents[:, :, q].astype(np.float64)), l2n(codebooks[q].astype(np.float64))
        d = np.sort(((e[..., None, :] - c) ** 2).sum(-1), axis=-1)
        gaps.append((d[..., 1] - d[..., 0]).min())
    return float(min(gaps))


@pytest.fixture(scope="module")
def codecs():
    """Both codecs, seeded audio, JAX's thresholds, and JAX's train-mode
    outputs and gradient (one compile) of a loss on the audio plus both VQ
    losses."""
    jmodel, variables, model = gan_codec_pair(5)
    audio = _audio(4, 640, 6)
    # the audio term's weights scaled so that the largest gradient entries
    # are ~1e-1, the scale GRAD_TOL was set at (tests/test_torch_s2a_train.py)
    w = (np.random.default_rng(7).standard_normal(audio.shape) / 64).astype(np.float32)
    thr = np.asarray(jax.jit(lambda v, k: jmodel.apply(
        v, k, 4, None, True, method=lambda m, *a: m.quantizer.active_level_thresholds(*a)))(
            variables, DROP_KEY))

    def jloss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(audio), train=True, rng=DROP_KEY)
        loss = (jnp.sum(out["audio"] * w) + out["vq/commitment_loss"]
                + 0.5 * out["vq/codebook_loss"])
        return loss, out

    (_, ref), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    return jmodel, variables, model, audio, thr, ref, w, grads


def test_train_mode_forward_matches_jax_with_its_thresholds(codecs):
    """Codes equal, z, latents, z_e, both VQ losses and the audio to 1e-5;
    JAX's draw drops rows 0 and 1 (floor(4 * 0.5)) to a count in [1, 2]."""
    jmodel, variables, model, audio, thr, ref, *_ = codecs
    assert (thr[2:] == 3).all() and ((thr[:2] >= 1) & (thr[:2] <= 2)).all()
    assert thr[0] != thr[1]  # one row at one level, one at both
    cbs = np.stack([q.codebook.weight.detach().numpy() for q in model.quantizer.quantizers])
    margin = _codes_margin(np.asarray(ref["latents"]), cbs)
    assert margin > 1e-4, margin
    with torch.no_grad():
        out = model(torch.from_numpy(audio), train=True, thresholds=torch.from_numpy(thr))
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(ref["codes"]))
    for k in ("z", "latents", "z_e", "audio", "vq/commitment_loss", "vq/codebook_loss"):
        assert_close(out[k].numpy(), ref[k], what=k)


def test_the_ports_own_dropout_draw_has_the_reference_structure(codecs):
    _, _, model, audio, *_ = codecs
    rvq = model.quantizer
    thr = rvq.active_level_thresholds(8, None, True, torch.Generator().manual_seed(0))
    assert (thr[4:] == 3).all() and ((thr[:4] >= 1) & (thr[:4] <= 2)).all()
    assert (rvq.active_level_thresholds(8, 1, False) == 2).all()  # the +1 quirk
    with pytest.raises(ValueError, match="generator"):
        rvq.active_level_thresholds(8, None, True)
    a = model(torch.from_numpy(audio), train=True, generator=torch.Generator().manual_seed(1))
    b = model(torch.from_numpy(audio), train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["audio"], b["audio"], rtol=0, atol=0)


def test_codec_methods_match_jax(codecs):
    """features_to_codes, features_to_codebook_logits,
    continuous_to_quantized_features, get_projected_codebook and
    decode(z, length, valid_frames)."""
    jmodel, variables, model, audio, _, ref, *_ = codecs
    b, t, q, dc = ref["latents"].shape
    feats = np.asarray(ref["latents"]).reshape(b, t, q * dc)
    z_e = np.asarray(ref["z_e"])
    z = np.asarray(ref["z"])
    valid = np.array([2, 1, 2, 1])
    def methods(m, feats, z_e, z, valid):
        return {"codes": m.features_to_codes(feats),
                "logits": m.features_to_codebook_logits(z_e),
                "quantized": m.quantizer.continuous_to_quantized_features(z_e),
                "projected": m.quantizer.get_projected_codebook(1),
                "decoded": m.decode(z, 600, valid)}

    j = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=methods))(
        variables, *(jnp.asarray(a) for a in (feats, z_e, z, valid)))
    with torch.no_grad():
        p = {
            "codes": model.features_to_codes(torch.from_numpy(feats)),
            "logits": model.features_to_codebook_logits(torch.from_numpy(z_e)),
            "quantized": model.quantizer.continuous_to_quantized_features(torch.from_numpy(z_e)),
            "projected": model.quantizer.get_projected_codebook(1),
            "decoded": model.decode(torch.from_numpy(z), 600, torch.from_numpy(valid)),
        }
    np.testing.assert_array_equal(p["codes"].numpy(), np.asarray(j["codes"]))
    np.testing.assert_array_equal(p["codes"].numpy(), np.asarray(ref["codes"]))
    assert p["decoded"].shape == (4, 600, 1)
    for k in ("logits", "quantized", "projected", "decoded"):
        assert_close(p[k].numpy(), j[k], what=k)


def test_codec_gradient_matches_jax_grad(codecs):
    """The gradient of every generator parameter (v and g apart) of a loss
    on the train-mode audio plus both VQ losses, against ``jax.grad``."""
    jmodel, _, model, audio, thr, _, w, jgrads = codecs
    jgrads = codec_to_torch(jmodel.config, {"params": jgrads}, legacy_wn=True)
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(audio), train=True, thresholds=torch.from_numpy(thr))
    ((out["audio"] * torch.from_numpy(w)).sum() + out["vq/commitment_loss"]
     + 0.5 * out["vq/codebook_loss"]).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads) and any(k.endswith("weight_g") for k in grads)
    for name, ref in jgrads.items():
        got = grads[name]
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref, err_msg=name, **GRAD_TOL)


def test_weight_norm_is_trainable_and_folds_once_for_inference(codecs):
    """v and g are parameters; the inference kernel is the fold made at
    load and made again only after v or g change."""
    model = codecs[2]
    conv = model.decoder.model[0]
    assert {n for n, _ in conv.named_parameters()} == {"weight_v", "weight_g", "bias"}
    with torch.no_grad():
        kept = conv.weight
        assert conv.weight is kept  # not refolded
        conv.weight_g.mul_(2.0)
        torch.testing.assert_close(conv.weight, 2.0 * kept)
        conv.weight_g.div_(2.0)
    live = conv.weight
    assert live.requires_grad and live.grad_fn is not None


def test_loader_takes_a_folded_export(codecs):
    """The port's exports before trainable weight norm held each codec conv's
    folded ``.weight``: such a state dict loads as ``v = weight``, ``g =
    ||weight||``, the same kernels; a dict with both forms is refused."""
    from edm_tts_tpu_torch.models.codec.layers import WeightNormed

    model = codecs[2]
    pairs = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    folded = dict(pairs)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, WeightNormed):
                del folded[f"{name}.weight_v"], folded[f"{name}.weight_g"]
                folded[f"{name}.weight"] = m.weight.numpy()
    fresh = Codec(CodecConfig(**TINY_GAN_CODEC))
    load_reference_state_dict(fresh, folded)
    mods = dict(model.named_modules())
    for name, m in fresh.named_modules():
        if isinstance(m, WeightNormed):
            torch.testing.assert_close(m.folded_weight, mods[name].folded_weight,
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(fresh, {**pairs, "decoder.model.0.weight": folded[
            "decoder.model.0.weight"]})


# -- the data copies -----------------------------------------------------------------

def _body(fn) -> str:
    """The function's AST without its docstring, module names unified."""
    tree = ast.parse(inspect.getsource(fn).replace("edm_tts_tpu_torch.", "edm_tts_tpu."))
    node = tree.body[0]
    if ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("port,jax_mod,name", [
    (pipeline, j_pipeline, "silence_filter"), (pipeline, j_pipeline, "volume_normalize"),
    (pipeline, j_pipeline, "codec_audio_pipeline"), (pipeline, j_pipeline, "batched"),
    (collators, j_collators, "collate_codec_audio")])
def test_data_copies_equal_jax(port, jax_mod, name):
    assert _body(getattr(port, name)) == _body(getattr(jax_mod, name))


def _librilight(root: Path) -> None:
    """Two speakers' books at 16 kHz, one with a silent stretch."""
    rng = np.random.default_rng(11)
    for spk, seconds in ((100, 2.3), (200, 1.6)):
        t = np.arange(int(seconds * 16000)) / 16000
        wav = 0.3 * np.sin(2 * np.pi * (150 + spk) * t) + 0.05 * rng.standard_normal(t.shape)
        wav[: 8000] *= 1e-4 if spk == 200 else 1.0
        path = root / "small" / str(spk) / "book" / f"{spk}.flac"
        path.parent.mkdir(parents=True)
        path.write_bytes(encode_flac(np.round(np.clip(wav, -1, 1) * 32767).astype(np.int64)[None],
                                     sample_rate=16000))


def test_codec_pipeline_equals_jax_on_seeded_flacs(tmp_path):
    _librilight(tmp_path)
    manifest = list(manifests.librilight_manifest(str(tmp_path), "small", 1.0))
    assert manifest == list(j_manifests.librilight_manifest(str(tmp_path), "small", 1.0))
    kw = dict(target_sr=16000, segment_seconds=0.38, shuffle=3, seed=1, repeat=False)
    out = list(pipeline.batched(pipeline.codec_audio_pipeline(manifest, **kw), 2,
                                stack=collators.collate_codec_audio))
    ref = list(j_pipeline.batched(j_pipeline.codec_audio_pipeline(manifest, **kw), 2,
                                  stack=j_collators.collate_codec_audio))
    assert len(out) == len(ref) >= 3 and out[0].shape == (2, 6080, 1)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    quiet = np.zeros(6080, np.float32)
    assert not pipeline.silence_filter(quiet, 16000) and not j_pipeline.silence_filter(quiet, 16000)


# -- run_codec ------------------------------------------------------------------------

def _recipe(tmp_path: Path) -> dict:
    """configs/dac/train_config.yaml at the tiny size: 2 steps of B2 x 0.04 s."""
    return {
        "output_dir": str(tmp_path / "out"),
        "generator_args": {**TINY_GAN_CODEC, "sample_rate": 16000},
        "discriminator_args": {"sample_rate": 16000, "rates": [], "periods": [2],
                               "fft_sizes": [128]},
        "gen_optimizer_args": {"lr": 1e-4, "betas": [0.8, 0.99]},
        "disc_optimizer_args": {"lr": 1e-4, "betas": [0.8, 0.99]},
        "gen_scheduler_args": {"gamma": 0.999996},
        "waveform_args": None, "multi_scale_stft_args": None,
        "mel_spectrogram_args": {**{k: list(v) for k, v in TINY_MEL.items()}, "power": 1.0,
                                 "clamp_eps": 1e-5, "mag_weight": 0.0},
        "lambdas": {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
                    "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0},
        "preprocessing_only": False,
        "dataset_args": {"path": "librilight", "name": "small", "data_dir": str(tmp_path / "data")},
        "training_segment_length": 0.04, "validation_segment_length": 0.04,
        "validation_split": 1, "silence_threshold": -40, "volume_normalize": -16,
        "shuffle_buffer_size": 4, "seed": 42, "per_device_train_batch_size": 2,
        "max_steps": 2, "save_steps": 2, "eval_steps": 2, "logging_steps": 1,
    }


def test_run_codec_preprocesses_trains_and_exports_on_the_cpu(tmp_path, capsys):
    _librilight(tmp_path / "data")
    raw = _recipe(tmp_path)
    cfg = tmp_path / "train_config.yaml"
    cfg.write_text(json.dumps({**raw, "preprocessing_only": True}))  # JSON is YAML
    run_codec.main([str(cfg), "--device", "cpu"])
    assert "preprocessing ok; batch (2, 640, 1)" in capsys.readouterr().out
    cfg.write_text(json.dumps(raw))
    run_codec.main([str(cfg), "--device", "cpu"])
    out = tmp_path / "out"
    assert (out / "checkpoint_2").is_dir() and (out / "samples" / "step_2" / "recon_0.wav").exists()
    records = [json.loads(line) for line in open(out / "metrics.jsonl")]
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r[k]) for r in train for k in r if k.startswith("train/"))
    assert {f"train/time/{p}" for p in ("g_forward", "d_step", "d_optim", "g_step", "g_optim")} \
        <= set(train[0])
    codec = hub.load_codec(str(out / "best_model"), device="cpu")
    with torch.no_grad():
        assert codec(torch.zeros(1, 640, 1))["audio"].shape == (1, 640, 1)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            run_codec.main([str(cfg)])
        assert e.value.code == 2


# -- K1/K2 under autograd ---------------------------------------------------------

@pytest.mark.parametrize("needs", ["all", "x only", "weights only"])
def test_plain_backward_gives_the_plain_versions_gradient(needs):
    """The autograd function K1 and K2 run under on the card: the forward
    is the launch, the backward the VJP of the plain composition on the
    saved inputs. With the plain composition itself standing in for the
    launch, the gradients equal autograd through the plain version, for
    the inputs that need one."""
    from edm_tts_tpu_torch.kernels import with_plain_backward
    from edm_tts_tpu_torch.ops.decoder_block import decoder_block_reference, phase_weights
    from edm_tts_tpu_torch.ops.resunit import resunit_reference

    gen = torch.Generator().manual_seed(0)

    def t(*shape, scale=0.3):
        return torch.randn(*shape, generator=gen) * scale

    cin, cout, s = 16, 8, 4
    flat = [p for _ in range(3) for p in (1 + t(cout), t(7, cout, cout), t(cout), 1 + t(cout),
                                          t(1, cout, cout), t(cout))]
    inputs = [t(2, 9, cin, scale=1.0), 1 + t(cin), phase_weights(t(2 * s, cin, cout), s),
              t(cout).repeat(s), *flat]
    want = {"all": [True] * len(inputs), "x only": [True] + [False] * (len(inputs) - 1),
            "weights only": [False] + [True] * (len(inputs) - 1)}[needs]
    leaves = [x.clone().requires_grad_(w) for x, w in zip(inputs, want)]

    def plain(x, a0, w3, b3, *ps):
        units = [tuple(ps[i:i + 6]) for i in range(0, len(ps), 6)]
        return decoder_block_reference(x, a0, w3, b3, units, stride=s)

    w = t(2, 9 * s, cout, scale=1.0)
    out = with_plain_backward(plain, plain, *leaves)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_PlainBackwardBackward"
    grads = torch.autograd.grad((out * w).sum(), [x for x in leaves if x.requires_grad])
    refs = [x.detach().clone().requires_grad_(x.requires_grad) for x in leaves]
    ref_grads = torch.autograd.grad((plain(*refs) * w).sum(), [x for x in refs if x.requires_grad])
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with torch.no_grad():  # nothing to record: the launch alone
        assert with_plain_backward(plain, plain, *leaves).grad_fn is None
    unit = [x.clone().requires_grad_() for x in (inputs[0][..., :cout], *flat[:6])]
    out = with_plain_backward(functools.partial(resunit_reference, dilation=3),
                              functools.partial(resunit_reference, dilation=3), *unit)
    (out * w[:, :9]).sum().backward()
    assert all(x.grad is not None for x in unit)

"""The port's codec GAN step and trainer against the JAX package's, on the
CPU in f32.

``train.gan.gan_train_step`` against ``edm_tts_tpu.train.gan.gan_train_step``
(skip_nonfinite and watch "all") for two steps of the tiny models of
tests/test_gan_trainer_loop.py (plus one MSD rate) on the same weights and
batches, with JAX's quantizer-dropout thresholds injected: every metric to a
relative 1e-5; the norms the first step watches (the keys, which tensor
each is, the prefixes) to a relative 1e-3: the gradients pass through the
discriminator's LeakyReLUs at a fake that agrees to ~1e-6, where a
pre-activation that close to 0 takes the other slope (2e-5 to 2e-4 in a
few gradient norms in the runs seen), and the updated parameters carry
Adam's first-step amplification below (3.7e-5 in a large discriminator
tensor's norm); on the same inputs both models' gradients agree to
GRAD_TOL (tests/test_torch_codec_train.py). A stacked JAX RVQ tensor is
held against the norm over the port's per-level tensors. The parameters after each step at the s2a
test's ``PARAM_TOL`` (atol/rtol 1e-6) against optax's AdamW (lr 1e-4 *
0.999996^count, betas (0.8, 0.99), weight decay 0.01 on every parameter)
applied to the step's own gradients, as tests/test_torch_s2a_train.py holds
the optimizer: element by element against the JAX run's parameters, Adam's
first update ``g / (|g| + 1e-8)`` turns the f32 noise of gradients within
~1e-8 of zero into differences of up to ~lr, for a handful of elements.
Then a step on a non-finite batch, skipped on both sides with the counts
advanced. The trainer's train -> eval -> export -> resume loop mirrors
tests/test_gan_trainer_loop.py (its repeated-eval regression included),
and a resumed run equals an unbroken one on the same batches.
"""

import json
import math
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edm_tts_tpu.models.codec.convert import discriminator_to_torch_state_dict
from edm_tts_tpu.models.codec.convert import to_torch_state_dict as codec_to_torch
from edm_tts_tpu.models.codec.losses import ReconstructionLoss as JReconstructionLoss
from edm_tts_tpu.train import gan as j_gan
from edm_tts_tpu.train import watch as j_watch
from edm_tts_tpu.train.optim import adamw as j_adamw
from edm_tts_tpu.train.optim import exponential_schedule as j_exponential
from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.codec.discriminator import Discriminator, DiscriminatorConfig
from edm_tts_tpu_torch.models.codec.losses import ReconstructionLoss
from edm_tts_tpu_torch.train.gan import gan_train_step
from edm_tts_tpu_torch.train.gan_trainer import GANTrainer, GANTrainingArguments
from edm_tts_tpu_torch.train.optim import AdamW, exponential_schedule
from edm_tts_tpu_torch.utils import hub
from test_torch_codec_train import TINY_DISC, TINY_GAN_CODEC, TINY_MEL, disc_pair, gan_codec_pair

PARAM_TOL = dict(atol=1e-6, rtol=1e-6)
LR, GAMMA = 1e-4, 0.999996
B, T = 2, 640
# JAX keys of the three steps: row 0 draws 1 level at the first, 2 at the second
STEP_KEYS = (10, 12, 13)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread: these models are tiny, and the suite runs one
    worker per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batches(seed: int, n: int) -> list[np.ndarray]:
    """tests/test_gan_trainer_loop.py's batches: a 300 Hz tone in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    sig = np.repeat(0.3 * np.sin(2 * np.pi * 300 * t)[None, :, None], B, 0)
    return [(sig + 0.01 * rng.standard_normal((B, T, 1))).astype(np.float32) for _ in range(n)]


def _groups(to_torch, params) -> dict[str, list[str]]:
    """{JAX watch path: the port's state-dict names of that tensor} (a
    stacked RVQ tensor maps to one name per level)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = treedef.unflatten([np.full(np.shape(leaf), i + 1, np.float32)
                                for i, (_, leaf) in enumerate(leaves)])
    groups = defaultdict(list)
    for name, arr in to_torch(marked).items():
        groups[j_watch._leaf_name(leaves[int(arr.flat[0]) - 1][0])].append(name)
    return groups


@pytest.fixture(scope="module")
def steps():
    """Three steps on both sides (the third on a non-finite batch): the
    metrics and both models' state dicts after each."""
    jcodec, g_vars, codec = gan_codec_pair(2)
    jdisc, d_vars, disc = disc_pair(3)
    jcfg, jdcfg = jcodec.config, jdisc.config
    lambdas = {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
               "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0}
    jrecon = JReconstructionLoss(16000, mel_spectrogram_args=dict(TINY_MEL))
    recon = ReconstructionLoss(16000, mel_spectrogram_args=dict(TINY_MEL))

    def tx():
        return j_adamw(j_exponential(LR, GAMMA), b1=0.8, b2=0.99, weight_decay=0.01)

    # one compiled program per state (optax's per-leaf zeros compile one by one eagerly)
    g_state = jax.jit(lambda p: j_gan.TrainState.create(apply_fn=None, params=p, tx=tx()))(g_vars)
    d_state = jax.jit(lambda p: j_gan.TrainState.create(apply_fn=None, params=p, tx=tx()))(d_vars)
    g_opt = AdamW(codec.named_parameters(), exponential_schedule(LR, GAMMA), b1=0.8, b2=0.99,
                  weight_decay=0.01)
    d_opt = AdamW(disc.named_parameters(), exponential_schedule(LR, GAMMA), b1=0.8, b2=0.99,
                  weight_decay=0.01)
    batches = _batches(0, 2)
    batches.append(batches[0].copy())
    batches[2][0, 5, 0] = np.nan
    # optax on the port's own parameters and gradients: the update's
    # reference, on one flat vector (AdamW without clipping is elementwise)
    named = dict(g_opt.named) | {f"disc.{n}": p for n, p in d_opt.named}

    def flat(tensors):
        return np.concatenate([t.detach().numpy().ravel() for t in tensors])

    def unflat(vector):
        sizes = np.cumsum([p.numel() for p in named.values()])[:-1]
        return {n: v.reshape(p.shape) for (n, p), v in zip(named.items(),
                                                           np.split(np.asarray(vector), sizes))}

    ref_params = flat(named.values())
    ref_tx = tx()
    ref_state = ref_tx.init(ref_params)

    @jax.jit
    def ref_update(grads, state, params):
        updates, state = ref_tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    # the step's quantizer-dropout draw, as the JAX step makes it
    thresholds = jax.jit(lambda v, rng: jcodec.apply(
        v, jax.random.split(rng)[0], B, None, True,
        method=lambda m, *a: m.quantizer.active_level_thresholds(*a)))
    out = []
    for i, audio in enumerate(batches):
        rng = jax.random.PRNGKey(STEP_KEYS[i])
        thr = np.asarray(thresholds(g_state.params, rng))
        g_state, d_state, jm = j_gan.gan_train_step(
            jcodec, jdisc, jrecon, g_state, d_state, jnp.asarray(audio), rng, lambdas, True, "all")
        before = {n: p.detach().clone() for n, p in named.items()}
        m = gan_train_step(codec, disc, recon, g_opt, d_opt, torch.from_numpy(audio),
                           thresholds=torch.from_numpy(thr), lambdas=lambdas,
                           skip_nonfinite=True, watch="all")
        ref_params, ref_state = ref_update(flat(p.grad for p in named.values()), ref_state,
                                           ref_params)
        out.append(dict(
            thr=thr, jm={k: float(v) for k, v in jm.items()}, m={k: float(v) for k, v in m.items()},
            before=before, after={n: p.detach().clone() for n, p in named.items()},
            ref=unflat(ref_params), counts=(g_opt.count, d_opt.count, int(g_state.step),
                                    int(d_state.step))))
        ref_params = flat(named.values())
    groups = {"gen/": _groups(lambda p: codec_to_torch(jcfg, p, legacy_wn=True), g_state.params),
              "disc/": _groups(lambda p: discriminator_to_torch_state_dict(jdcfg, p, legacy_wn=True),
                               d_state.params)}
    return out, groups


@pytest.mark.parametrize("i", [0, 1])
def test_gan_step_matches_jax(steps, i):
    """Step ``i``'s metrics against the JAX step's, and both models'
    parameters against optax's AdamW on the step's gradients; the two steps
    draw different dropout thresholds."""
    out, _ = steps
    s = out[i]
    assert i == 0 or not (out[0]["thr"] == out[1]["thr"]).all()
    plain = {k for k in s["jm"] if not k.startswith("watch/")}
    assert plain == {k for k in s["m"] if not k.startswith("watch/")} == {
        "mel/loss", "adv/gen_loss", "adv/feat_loss", "vq/commitment_loss", "vq/codebook_loss",
        "loss", "adv/disc_loss", "skipped_nonfinite"}
    for k in plain:
        assert abs(s["m"][k] - s["jm"][k]) <= 1e-5 * abs(s["jm"][k]) + 1e-12, (k, s["m"][k],
                                                                              s["jm"][k])
    assert s["m"]["skipped_nonfinite"] == 0.0
    for name, value in s["ref"].items():
        assert not torch.equal(s["after"][name], s["before"][name]), name  # every tensor moved
        np.testing.assert_allclose(s["after"][name].numpy(), value, err_msg=name, **PARAM_TOL)
    assert s["counts"] == (i + 1,) * 4


def test_watch_norms_match_jax(steps):
    """The first step's (both sides start from the same weights)."""
    out, groups = steps
    s = out[0]
    for prefix, by_path in groups.items():
        for kind in ("grad_norm", "param_norm"):
            jkeys = {k for k in s["jm"] if k.startswith(f"watch/{prefix}{kind}/")}
            assert jkeys == {f"watch/{prefix}{kind}/{path}" for path in by_path}
            for path, names in by_path.items():
                ours = math.sqrt(sum(s["m"][f"watch/{prefix}{kind}/{n}"] ** 2 for n in names))
                ref = s["jm"][f"watch/{prefix}{kind}/{path}"]
                assert abs(ours - ref) <= 1e-3 * ref + 1e-12, (prefix, kind, path, ours, ref)
        assert sum(len(n) for n in by_path.values()) == len(
            [k for k in s["m"] if k.startswith(f"watch/{prefix}param_norm/")])


def test_nonfinite_batch_is_skipped_on_both_sides(steps):
    out, _ = steps
    s = out[2]
    assert s["jm"]["skipped_nonfinite"] == s["m"]["skipped_nonfinite"] == 1.0
    assert s["counts"] == (3, 3, 3, 3)  # the step counts (and the schedules) advance
    for name, value in s["before"].items():
        torch.testing.assert_close(s["after"][name], value, rtol=0, atol=0, msg=name)


# -- the trainer ------------------------------------------------------------------

def _trainer(out_dir, max_steps, **kw):
    codec = Codec(CodecConfig(**TINY_GAN_CODEC))
    init_random_weights(codec, 0, snake_alpha=1.0)
    disc = Discriminator(DiscriminatorConfig(**{**TINY_DISC, "rates": ()}))
    init_random_weights(disc, 1)
    args = GANTrainingArguments(output_dir=str(out_dir), max_steps=max_steps, logging_steps=1,
                                eval_steps=2, save_steps=2, num_samples_to_log=1, **kw)
    recon = ReconstructionLoss(16000, mel_spectrogram_args={
        "n_mels": (5,), "window_lengths": (64,), "mel_fmin": (0.0,), "mel_fmax": (None,)})
    return GANTrainer(args, codec, disc, recon, device="cpu")


def test_trainer_train_eval_export_resume(tmp_path):
    """tests/test_gan_trainer_loop.py's loop; then the resumed run against an
    unbroken one fed the same batches: equal models and optimizer states;
    the unbroken run's repeated evals each get a fresh pass."""
    batches = _batches(1, 4)
    out = tmp_path / "gan"
    trainer = _trainer(out, 2)
    trainer.train(iter(batches[:2]), lambda: batches[:1])
    assert trainer.ckpt.latest_step() == 2
    assert (out / "best_model" / "config.json").exists()
    assert (out / "best_model" / "model.safetensors").exists()
    assert (out / "samples" / "step_2" / "recon_0.wav").exists()
    assert (out / "samples" / "step_2" / "real_0.wav").exists()
    assert (out / "metrics.jsonl").exists()
    exported = hub.load_codec(str(out / "best_model"), device="cpu")
    for name, value in trainer.codec.state_dict().items():  # the trained pairs, as held
        torch.testing.assert_close(exported.state_dict()[name], value, rtol=0, atol=0)
    with torch.no_grad():
        assert exported(torch.zeros(1, T, 1))["audio"].shape == (1, T, 1)

    resumed = _trainer(out, 4)
    resumed.train(iter(batches[2:]), None)
    assert resumed.g_opt.count == resumed.d_opt.count == 4
    # the unbroken run evaluates through a factory of one-shot generators:
    # each eval gets a fresh pass (tests/test_gan_trainer_loop.py's
    # regression: a bare generator was used up by the first eval)
    unbroken = _trainer(tmp_path / "unbroken", 4)
    unbroken.train(iter(batches), lambda: (b for b in batches[:1]))
    evals = [json.loads(line) for line in open(tmp_path / "unbroken" / "metrics.jsonl")
             if "eval/mel_loss" in line]
    assert [e["step"] for e in evals] == [2, 4]
    assert all(np.isfinite(e["eval/mel_loss"]) for e in evals), evals
    for a, b in ((resumed.state(), unbroken.state()),):
        for part in a:
            flat_a = {k: v for k, v in _flatten(a[part])}
            flat_b = {k: v for k, v in _flatten(b[part])}
            assert flat_a.keys() == flat_b.keys()
            for k in flat_a:
                torch.testing.assert_close(flat_a[k], flat_b[k], rtol=0, atol=0, msg=(part, k))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix, torch.as_tensor(tree)


def test_chip_smoke_carries_the_codec_recipe():
    """chip_smoke.py's path (k) runs configs/dac/train_config.yaml; the card's
    machine has no PyYAML, so the script carries the recipe: it must be the
    file's, key for key."""
    import importlib.util
    from pathlib import Path

    import yaml

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(root / "configs" / "dac" / "train_config.yaml") as f:
        assert chip_smoke.CODEC_RECIPE == yaml.safe_load(f)

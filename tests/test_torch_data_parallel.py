"""Data parallelism with ZeRO-2 in the port's trainers, on 4 gloo ranks
(data 2 x fsdp 2) against one process and against the JAX ``Trainer``.

The ranks (tests/torch_dist_workers.py, spawned once for the file, plus 2
ranks that resume its checkpoint) each take a contiguous quarter of the
global batch of 8; rank r's micro-batch i is the global micro-batch
r * micro_batches + i with that micro-batch's generator, so a 4-rank step
must be the one-process step with 4 micro-batches on the same global batch:

- s2a with the masks drawn from the generators and dropout 0.1 (so the
  per-micro-batch streams matter), 3 steps, and t2s 2 steps: every logged
  loss to a relative 1e-5 and every parameter to ``PARAM_TOL`` of
  tests/test_torch_s2a_train.py (f32, the gradient summed in another
  order);
- each rank's AdamW moments are half of the trainable parameters (ZeRO-2);
- the codec GAN (4 data ranks, quantizer dropout 0.5 drawn for the global
  batch): one step's reduced D and G gradients to ``GRAD_TOL``, the losses
  and the parameters whose gradient is not near zero to ``PARAM_TOL``.
  Adam's first update turns f32 noise of a gradient within ~1e-6 of zero
  into a step of ~lr; D's rate is 0 here, so that such steps of D do not
  move G's gradient (D's reduction is held by its gradients);
- the step-2 checkpoint of the 4-rank s2a run resumes on 1 process and on 2
  ranks, and their step 3 equals the uninterrupted run;
- the JAX ``Trainer`` on a (data 2, fsdp 2) mesh of the virtual CPU devices
  and the port on 4 ranks, 2 steps of s2a with the masks given in the
  batch: the losses to a relative 1e-5 and the parameters to ``PARAM_TOL``
  at a rate of ``JAX_LR``.
"""

import concurrent.futures
import copy
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from edm_tts_tpu.train.optim import freeze_subtree_mask
from edm_tts_tpu.train.trainer import Trainer as JTrainer
from edm_tts_tpu.train.trainer import TrainingArguments as JTrainingArguments
from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.data import collators
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.codec.discriminator import Discriminator, DiscriminatorConfig
from test_torch_codec_train import TINY_DISC, TINY_GAN_CODEC
from test_torch_s2a_train import GRAD_TOL, PARAM_TOL
from torch_dist_workers import gan_trainer, s2a_trainer, spawn, t2s_trainer, train_history, trainable
from torch_port_parity import TINY_S2A, s2a_pair, t2s_pair

B = 8
LOSS_RTOL = 1e-5
# the learning rate of the comparison with JAX: the gradients of the two
# frameworks agree to GRAD_TOL, and Adam's second update turns a gradient
# off by GRAD_TOL's atol at ~1e-5 into a step off by ~1e-3 lr
JAX_LR = 1e-4


def _s2a_batches(rng, steps, with_mask):
    out = []
    for _ in range(steps):
        batch = {"acoustic_tokens": rng.integers(0, 16, (B, 4, 12)).astype(np.int32),
                 "semantic_tokens": rng.integers(0, 8, (B, 12)).astype(np.int32)}
        if with_mask:
            mask = rng.random((B, 12)) < 0.5
            mask[:, 0] = True
            batch["mask"] = mask
        out.append(batch)
    return out


def _t2s_batches(rng, steps):
    out = []
    for _ in range(steps):
        examples = []
        for i in range(B):
            t = int(rng.integers(6, 30))
            examples.append({"id": f"u{i}", "semantic_tokens": rng.integers(1, 8, t),
                             "transcription_bytes": rng.integers(0, 256, int(rng.integers(1, t))
                                                                 ).tolist()})
        out.append(collators.collate_t2s(examples))
    return out


def _jax_params(variables, jmodel, batches, out_dir):
    """2 steps of the JAX Trainer on a (data 2, fsdp 2) mesh, the masks given."""
    def j_loss(p, batch, rng):
        out = jmodel.apply(p, batch["acoustic_tokens"], batch["semantic_tokens"],
                           mask_rng=rng, mask_override=batch["mask"], train=True)
        return out["loss"], {"loss_weight": jnp.sum(out["mask"])}

    args = JTrainingArguments(output_dir=str(out_dir), per_device_train_batch_size=B,
                              learning_rate=JAX_LR, warmup_steps=1, max_steps=2, max_grad_norm=0.05,
                              logging_steps=1, save_steps=1000, adam_beta1=0.8, adam_beta2=0.99,
                              n_fsdp=2)
    trainer = JTrainer(args, j_loss, variables, frozen_mask=freeze_subtree_mask(variables, "codec"),
                       mesh=j_make_mesh(2, 2, devices=jax.devices()[:4]))
    trainer.train(iter(batches))
    params = jax.device_get(trainer.state.params)
    with open(out_dir / "metrics.jsonl") as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    return s2a_to_torch(jmodel.cfg, params), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny one-process runs here share the CPU with 4 ranks
    try:
        yield _runs(tmp_path_factory.mktemp("dp"))
    finally:
        torch.set_num_threads(threads)


def _runs(tmp):
    jmodel, variables, s2a = s2a_pair(seed=3)
    s2a_drop = s2a_pair(seed=4, cfg={**TINY_S2A, "encoder_ff_dropout": 0.1,
                                     "encoder_conv_dropout": 0.1})[2]
    t2s = t2s_pair(seed=7)[2]
    codec = Codec(CodecConfig(**TINY_GAN_CODEC))
    init_random_weights(codec, 0, snake_alpha=1.0)
    disc = Discriminator(DiscriminatorConfig(**{**TINY_DISC, "rates": ()}))
    init_random_weights(disc, 1)
    rng = np.random.default_rng(11)
    inputs = dict(jax_lr=JAX_LR, s2a=s2a, s2a_drop=s2a_drop, t2s=t2s, codec=codec, disc=disc,
                  s2a_batches=_s2a_batches(rng, 3, False), mask_batches=_s2a_batches(rng, 2, True),
                  t2s_batches=_t2s_batches(rng, 2),
                  audio=(0.1 * rng.standard_normal((4, 1280, 1))).astype(np.float32))
    torch.save(inputs, tmp / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        four = pool.submit(spawn, "data_parallel", 4, tmp)
        jax_params = _jax_params(variables, jmodel, inputs["mask_batches"], tmp / "jax")
        four = four.result()
    shutil.copytree(tmp / "s2a" / "checkpoint_2", tmp / "resume2" / "checkpoint_2")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(spawn, "resume2", 2, tmp)
        one = {}
        trainer = s2a_trainer(copy.deepcopy(s2a_drop), tmp / "one", steps=3, batch=B,
                              micro_batches=4)
        one["s2a_losses"] = train_history(trainer, inputs["s2a_batches"])
        one["s2a_params"] = trainable(trainer.model)
        (tmp / "resume1").mkdir()
        shutil.copytree(tmp / "s2a" / "checkpoint_2", tmp / "resume1" / "checkpoint_2")
        trainer = s2a_trainer(copy.deepcopy(s2a_drop), tmp / "resume1", steps=3, batch=B,
                              micro_batches=4)
        one["resume_losses"] = train_history(trainer, inputs["s2a_batches"][2:])
        one["resume_params"] = trainable(trainer.model)
        trainer = t2s_trainer(copy.deepcopy(t2s), tmp / "t2s_one", steps=2, batch=B,
                              micro_batches=4)
        one["t2s_losses"] = train_history(trainer, inputs["t2s_batches"])
        one["t2s_params"] = trainable(trainer.model)
        gan = gan_trainer(copy.deepcopy(codec), copy.deepcopy(disc), tmp / "gan_one", steps=1,
                          disc_lr=0.0)
        gan.train(iter([inputs["audio"]]))
        one["gan_history"] = [r for r in gan.history if "train/loss" in r]
        one["gan_params"] = (trainable(gan.codec), trainable(gan.disc))
        one["gan_grads"] = ({n: p.grad.clone() for n, p in gan.g_opt.named},
                            {n: p.grad.clone() for n, p in gan.d_opt.named})
        two = two.result()
    return dict(four=four, two=two, one=one, jax=jax_params)


def _close(a: dict, b: dict, tol=PARAM_TOL):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), err_msg=n, **tol)


def test_s2a_on_four_ranks_is_one_process_with_four_micro_batches(runs):
    four, one = runs["four"][0], runs["one"]
    np.testing.assert_allclose(four["s2a_losses"], one["s2a_losses"], rtol=LOSS_RTOL)
    _close(four["s2a_params"], one["s2a_params"])


def test_every_rank_ends_with_the_same_parameters(runs):
    for r in runs["four"][1:]:
        _close(r["s2a_params"], runs["four"][0]["s2a_params"], dict(rtol=0, atol=0))
        _close(r["t2s_params"], runs["four"][0]["t2s_params"], dict(rtol=0, atol=0))


def test_each_fsdp_rank_keeps_half_the_adam_moments(runs):
    for r in runs["four"]:
        mu, nu, n = r["moments"]
        assert mu == nu == -(-n // 2) and n > 10_000


def test_t2s_on_four_ranks_is_one_process_with_four_micro_batches(runs):
    four, one = runs["four"][0], runs["one"]
    np.testing.assert_allclose(four["t2s_losses"], one["t2s_losses"], rtol=LOSS_RTOL)
    _close(four["t2s_params"], one["t2s_params"])


def test_gan_step_on_four_ranks_is_one_process_on_the_whole_batch(runs):
    four, one = runs["four"][0], runs["one"]
    for g_four, g_one in zip(four["gan_grads"], one["gan_grads"]):
        _close(g_four, g_one, GRAD_TOL)
    (h4,), (h1,) = four["gan_history"], one["gan_history"]
    for k, v in h1.items():
        if k.startswith("train/") and "time" not in k and "steps_per_sec" not in k:
            assert h4[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    for p4, p1, grads in zip(four["gan_params"], one["gan_params"], one["gan_grads"]):
        for n in p1:
            sure = grads[n].abs() > 1e-6
            np.testing.assert_allclose(p4[n][sure].numpy(), p1[n][sure].numpy(), err_msg=n,
                                       **PARAM_TOL)


def test_four_rank_checkpoint_resumes_on_one_process(runs):
    four, one = runs["four"][0], runs["one"]
    assert one["resume_losses"][0] == pytest.approx(four["s2a_losses"][2], rel=LOSS_RTOL)
    _close(one["resume_params"], four["s2a_params"])


def test_four_rank_checkpoint_resumes_on_two_ranks(runs):
    four = runs["four"][0]
    for r in runs["two"]:
        assert r["losses"][0] == pytest.approx(four["s2a_losses"][2], rel=LOSS_RTOL)
        _close(r["params"], four["s2a_params"])


def test_four_ranks_match_the_jax_trainer_on_a_data2_fsdp2_mesh(runs):
    four = runs["four"][0]
    ref, losses = runs["jax"]
    np.testing.assert_allclose(four["mask_losses"], losses, rtol=LOSS_RTOL)
    for n, p in four["mask_params"].items():
        np.testing.assert_allclose(p.numpy(), ref[n], err_msg=n, **PARAM_TOL)

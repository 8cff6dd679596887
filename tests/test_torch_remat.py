"""Gradient checkpointing (``gradient_checkpointing`` / ``remat_policy``) in
the port, on the CPU in f32.

With dropout 0.1 drawn from an explicit generator, each policy ("full",
"mha", "dots") gives the gradients of the same step without remat (to a
relative 1e-6: the recompute repeats the forward's arithmetic and its
dropout masks) and leaves the generator where a step without remat leaves
it. With the Conformer's attention routed through ``FlashMHA`` (the card's
path; on the CPU its forward and backward are the plain versions), "full"
runs the attention forward twice per block and "mha"/"dots" once: they keep
the ``edm_tts::flash_mha_lse`` outputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import edm_tts_tpu_torch.models.conformer.conformer as conformer_mod
import edm_tts_tpu_torch.ops.attention as attention_mod
from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.data import collators
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic
from edm_tts_tpu_torch.train import run_t2s
from edm_tts_tpu_torch.train.optim import freeze_submodule
from edm_tts_tpu_torch.train.run_s2a import build_model
from torch_port_parity import TINY_CODEC, TINY_S2A, TINY_T2S

POLICIES = ("full", "mha", "dots")
DROP = 0.1


def _s2a():
    cfg = S2AConfig(**{**TINY_S2A, "encoder_ff_dropout": DROP, "encoder_conv_dropout": DROP},
                    codec=CodecConfig(**TINY_CODEC))
    model = InjectionConformer(cfg)
    init_random_weights(model, 0)
    freeze_submodule(model, "acoustic_model")
    rng = np.random.default_rng(0)
    ac = torch.from_numpy(rng.integers(0, 16, (2, 4, 12)))
    sem = torch.from_numpy(rng.integers(0, 8, (2, 12)))

    def step(policy, generator):
        model.cfg = dataclasses.replace(cfg, gradient_checkpointing=policy is not None,
                                        remat_policy=policy or cfg.remat_policy)
        return model.forward_train(ac, sem, generator=generator)["loss"]

    return model, step, cfg.encoder_num_layers


def _t2s():
    cfg = T2SConfig(**{**TINY_T2S, "main_encoder_ff_dropout": DROP,
                       "main_encoder_conv_dropout": DROP, "length_predictor_ff_dropout": DROP})
    model = TextToSemantic(cfg)
    init_random_weights(model, 1)
    rng = np.random.default_rng(1)
    ex = [{"semantic_tokens": rng.integers(0, 8, t), "transcription_bytes": list(range(5 + t // 4))}
          for t in (30, 21, 26)]
    batch = {k: torch.from_numpy(v) for k, v in collators.collate_t2s(ex).items()}

    def step(policy, generator):
        model.cfg = dataclasses.replace(cfg, gradient_checkpointing=policy is not None,
                                        remat_policy=policy or cfg.remat_policy)
        model.conformer.cfg = model.cfg.main_encoder_config
        return model.forward_train(*(batch[k] for k in run_t2s.BATCH_KEYS),
                                   generator=generator)["loss"]

    # the length predictor never remats (as in the JAX config)
    return model, step, cfg.main_encoder_num_layers + cfg.length_predictor_num_layers


def _grad(model, step, policy):
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(5)
    loss = step(policy, gen)
    loss.backward()
    grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
    return loss.item(), grad, gen.get_state()


@pytest.mark.parametrize("build", [_s2a, _t2s], ids=["s2a", "t2s"])
def test_every_policy_gives_the_gradient_without_remat(build):
    model, step, _ = build()
    loss0, grad0, state0 = _grad(model, step, None)
    for policy in POLICIES:
        loss, grad, state = _grad(model, step, policy)
        assert loss == loss0, policy
        assert ((grad - grad0).norm() / grad0.norm()).item() <= 1e-6, policy
        assert torch.equal(state, state0), policy
    # dropout is on: another generator seed gives another gradient
    model.zero_grad(set_to_none=True)
    step(None, torch.Generator().manual_seed(6)).backward()
    other = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
    assert ((other - grad0).norm() / grad0.norm()).item() > 1e-3


@pytest.mark.parametrize("build", [_s2a, _t2s], ids=["s2a", "t2s"])
def test_mha_and_dots_keep_the_attention_output(build, monkeypatch):
    """Count the attention forwards (K3 on the card) per policy, with the
    Conformer's attention going through FlashMHA as it does on the card."""
    model, step, blocks = build()
    calls = []
    true_flash = attention_mod.flash_mha

    def counted(*args, **kwargs):
        calls.append(1)
        return true_flash(*args, **kwargs)

    def card_path_mha(q, k, v, *, mask=None, implementation="auto"):
        return attention_mod.FlashMHA.apply(q, k, v, mask)

    monkeypatch.setattr(attention_mod, "flash_mha", counted)
    monkeypatch.setattr(conformer_mod, "mha", card_path_mha)
    remat_blocks = model.cfg.encoder_num_layers if isinstance(model, InjectionConformer) \
        else model.cfg.main_encoder_num_layers
    grads = {}
    for policy, want in ((None, blocks), ("full", blocks + remat_blocks), ("mha", blocks),
                         ("dots", blocks)):
        calls.clear()
        _, grads[policy], _ = _grad(model, step, policy)
        assert len(calls) == want, (policy, len(calls))
    for policy in POLICIES:
        assert ((grads[policy] - grads[None]).norm() / grads[None].norm()).item() <= 1e-6


def test_unknown_policy_raises_and_the_s2a_recipe_carries_mha():
    model, step, _ = _s2a()
    with pytest.raises(ValueError, match="remat_policy"):
        _grad(model, step, "everything")
    raw = {"seed": 1, "extra_model_params": {**TINY_S2A, "codec": dataclasses.asdict(
        CodecConfig(**TINY_CODEC)), "gradient_checkpointing": True}}
    built = build_model(raw, "cpu")
    assert built.cfg.encoder_config.remat and built.cfg.encoder_config.remat_policy == "mha"
    with torch.no_grad():  # no graph, no remat: the same forward
        out = built.forward_train(torch.zeros(1, 4, 8, dtype=torch.long),
                                  torch.zeros(1, 8, dtype=torch.long),
                                  generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["loss"])

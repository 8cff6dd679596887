"""Text->semantic (with length predictor) training on one CUDA card (port
of run_text_to_semantic_training.py).

    python -m edm_tts_tpu_torch.train.run_t2s configs/text_to_semantic_w_length/train_config.yaml \
        [--device cuda|cpu]

The same YAML as the JAX entry point: the base ``T2SConfig`` overridden by
``extra_model_params``; text + semantic token shards (``dataset_args``),
kept where 20 < semantic length < 1250 and longer than the text
(``t2s_filter``), shuffled through a 2000-item buffer, grouped into
length-bucketed batches and collated into the joint ``[TEXT] bytes [SEP]
[SPEECH] semantic [SEP]`` sequence padded to a multiple of 64; the
optimizer and loop settings of ``TrainingArguments`` with the JAX entry
point's defaults (lr 2.5e-4, 4000 warmup and 300k steps, betas (0.8,
0.99), clip 0.5); ``bf16`` (the forward under bf16 autocast, f32 weights
and optimizer state; with ``bf16: false`` all in f32, as ``run_s2a``
runs it); ``preprocessing_only``; optional held-out
evaluation with a fixed mask draw; auto-resume; and an exported model
directory at the end (``<output_dir>/export``).

Each micro-batch weighs 1 in gradient accumulation (the loss function
gives no ``loss_weight``), as in the JAX trainer. Weights: a seeded
random init (``seed``). ``main_from_dict`` takes the parsed recipe, for
callers without PyYAML. ``--device`` and the lines printed on the card are
``train.cli.recipe_cli``'s.
"""

from __future__ import annotations

import itertools
import logging
import os
import time

import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.data.collators import collate_t2s, length_bucketed, t2s_filter
from edm_tts_tpu_torch.data.pipeline import shuffle_buffer
from edm_tts_tpu_torch.data.token_shards import iter_reference_pt_shards, iter_token_shards
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic
from edm_tts_tpu_torch.train.cli import recipe_cli
from edm_tts_tpu_torch.train.export import save_t2s
from edm_tts_tpu_torch.train.run_s2a import precision, training_arguments
from edm_tts_tpu_torch.train.trainer import Trainer

logger = logging.getLogger(__name__)

BATCH_KEYS = ("input_ids", "attention_mask", "speech_mask", "text_ids", "text_attention_mask",
              "speech_lengths")
# the JAX entry point's defaults where they differ from the s2a ones
T2S_DEFAULTS = dict(output_dir="exp/edm_tts/text_to_semantic_w_length", max_steps=300_000,
                    learning_rate=2.5e-4)


def t2s_batch_iterator(shard_dir, batch_size, seed, use_pt=False):
    """Endless collated batches, reshuffled and rebucketed every epoch.
    Raises where a whole pass over the shards gives no batch (fewer than
    ``batch_size`` items pass ``t2s_filter``), which would otherwise loop
    forever."""
    epoch = 0
    while True:
        it = (iter_reference_pt_shards if use_pt else iter_token_shards)(shard_dir)
        filtered = (ex for ex in shuffle_buffer(it, 2000, seed=seed + epoch) if t2s_filter(ex))
        batched = False
        for group in length_bucketed(filtered, batch_size, seed=seed + epoch):
            batched = True
            yield collate_t2s(group)
        if not batched:
            raise ValueError(f"fewer than {batch_size} items under {shard_dir} pass t2s_filter: "
                             "lower per_device_train_batch_size")
        epoch += 1


def build_model(raw: dict, device) -> TextToSemantic:
    """The f32 model the recipe trains, from a seeded random init."""
    cfg_d = dict(raw.get("model_config", {}))
    cfg_d.update(raw.get("extra_model_params", {}) or {})
    model = TextToSemantic(T2SConfig.from_dict(cfg_d), device=device)
    init_random_weights(model, raw.get("seed", 42))
    return model


def t2s_loss(model: TextToSemantic, *, bf16: bool):
    """``(forward(batch, generator, train) -> outputs, loss_fn)`` for the
    Trainer: the training forward, under bf16 autocast when ``bf16``. A
    batch may carry its own bool ``"mask"``, as ``run_s2a.s2a_loss``'s."""
    device_type = next(model.parameters()).device.type

    def forward(batch, generator, train):
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=bf16):
            return model.forward_train(*(batch[k] for k in BATCH_KEYS), generator=generator,
                                       train=train, mask_override=batch.get("mask"))

    def loss_fn(batch, generator):
        out = forward(batch, generator, True)
        return out["loss"], {"ce_loss": out["ce_loss"], "length_loss": out["length_loss"]}

    return forward, loss_fn


def main_from_dict(raw: dict, *, device="cuda") -> Trainer | None:
    """Train as the recipe ``raw`` says; returns the Trainer (its model and
    logged ``history``), or None for ``preprocessing_only``."""
    device = torch.device(device)
    args = training_arguments(raw, **T2S_DEFAULTS)
    dataset = raw.get("dataset_args", {})
    train_iter = t2s_batch_iterator(dataset.get("data_dir", "data/text_codes"),
                                    args.per_device_train_batch_size, args.seed,
                                    use_pt=dataset.get("format") == "pt")
    if raw.get("preprocessing_only"):
        b = next(train_iter)
        print("preprocessing ok;", {k: v.shape for k, v in b.items()})
        return None
    model = build_model(raw, device)
    bf16 = bool(raw.get("bf16", True))
    forward, loss_fn = t2s_loss(model, bf16=bf16)

    # held-out evaluation: fixed batches, the same mask draw for every batch
    eval_iter, eval_fn = None, None
    ev = raw.get("eval_dataset_args")
    if ev:
        eval_iter = list(itertools.islice(
            t2s_batch_iterator(ev["data_dir"], raw.get("per_device_eval_batch_size", 32),
                               seed=args.seed + 1, use_pt=ev.get("format") == "pt"),
            int(raw.get("eval_batches", 4))))

        def eval_fn(batch):
            gen = torch.Generator(device=device).manual_seed(args.seed + 2)
            out = forward(batch, gen, False)
            return {k: out[k] for k in ("loss", "ce_loss", "length_loss")}

    trainer = Trainer(args, model, loss_fn, eval_fn=eval_fn, device=device)
    with precision(bf16, device):
        trainer.train(train_iter, eval_iter)
    export_dir = os.path.join(args.output_dir, "export")
    t0 = time.perf_counter()
    save_t2s(export_dir, model)
    logger.info("exported the model to %s in %.2f s", export_dir, time.perf_counter() - t0)
    return trainer


def main(argv: list[str] | None = None) -> None:
    recipe_cli(__doc__.split("\n\n")[0], "the training YAML "
               "(configs/text_to_semantic_w_length/train_config.yaml)", main_from_dict, argv)


if __name__ == "__main__":
    main()

"""Semantic->acoustic (injection Conformer) training on one CUDA card (port
of run_semantic_to_acoustic_training.py).

    python -m edm_tts_tpu_torch.train.run_s2a configs/injection_conformer/train_config.yaml \
        [--device cuda|cpu]

The same YAML as the JAX entry point: the base ``S2AConfig`` overridden by
``extra_model_params`` (with the reference's nested ``encoder_config``
mapped to the flat fields), token shards cropped to
``training_segment_length`` seconds, the optimizer and loop settings of
``TrainingArguments``, ``bf16`` (the forward under bf16 autocast, f32
weights and optimizer state; with ``bf16: false`` all in f32, TF32 off on
the card, attention through K3's and K4's f32 kernels), optional held-out
evaluation, auto-resume, and an exported model directory at the end
(``<output_dir>/export``).

Weights: a seeded random init (``seed``), with the frozen codec loaded from
``acoustic_model_path`` and the whole model from ``warm_start_model`` when
they are given (directories written by ``train.export``).
``main_from_dict`` takes the parsed recipe, for callers without PyYAML.
``--device`` (default ``cuda``; without a card the run exits 2 unless
given ``--device cpu``); on the card the run ends with the peak device
memory and the kernel launches (``train.cli.recipe_cli``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import random
import time

import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.data.collators import collate_s2a
from edm_tts_tpu_torch.data.pipeline import crop_code_example, shuffle_buffer
from edm_tts_tpu_torch.data.token_shards import iter_reference_pt_shards, iter_token_shards
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.ops.precision import exact_f32
from edm_tts_tpu_torch.train.cli import recipe_cli
from edm_tts_tpu_torch.train.export import load_codec, load_state, save_s2a
from edm_tts_tpu_torch.train.optim import freeze_submodule
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments

logger = logging.getLogger(__name__)

# the reference's nested encoder_config -> the flat S2AConfig fields
ENCODER_FIELDS = (
    ("depth", "encoder_num_layers"),
    ("heads", "encoder_num_heads"),
    ("ff_mult", "encoder_ff_mult"),
    ("conv_kernel_size", "encoder_conv_kernel_size"),
    ("attn_dropout", "encoder_attn_dropout"),
    ("ff_dropout", "encoder_ff_dropout"),
    ("conv_dropout", "encoder_conv_dropout"),
)


def code_batch_iterator(shard_dir, segment_frames, batch_size, seed, use_pt=False):
    """Endless batches of aligned random crops, reshuffled every epoch.
    Raises where a whole pass over the shards gives no crop (every item
    shorter than ``segment_frames``), which would otherwise loop forever."""
    rng = random.Random(seed)
    epoch = 0
    buf = []
    while True:
        it = (iter_reference_pt_shards if use_pt else iter_token_shards)(shard_dir)
        cropped = False
        for ex in shuffle_buffer(it, 1000, seed=seed + epoch):
            crop = crop_code_example(ex, segment_frames, rng)
            if crop is None:
                continue
            cropped = True
            buf.append(crop)
            if len(buf) == batch_size:
                yield collate_s2a(buf)
                buf = []
        if not cropped:
            raise ValueError(f"no item under {shard_dir} is {segment_frames} frames long: "
                             "shorten training_segment_length")
        epoch += 1


def model_config(raw: dict) -> tuple[dict, str | None]:
    """The recipe's model fields as a flat ``S2AConfig`` dict, and the
    codec directory."""
    d = dict(raw.get("model_config", {}))
    d.update(raw.get("extra_model_params", {}) or {})
    acoustic_model_path = raw.get("acoustic_model_path", d.pop("acoustic_model_path", None))
    d.pop("acoustic_model_path", None)
    enc = d.pop("encoder_config", None) or {}
    for src, dst in ENCODER_FIELDS:
        if src in enc:
            d[dst] = enc[src]
    return d, acoustic_model_path


def training_arguments(raw: dict, **defaults) -> TrainingArguments:
    """The recipe's loop settings; ``defaults`` are the entry point's own
    where they differ from the s2a ones below."""
    names = {f.name for f in dataclasses.fields(TrainingArguments)}
    kw = {k: v for k, v in raw.items() if k in names}
    # the JAX entry point's defaults where they differ from the dataclass's
    for k, v in {"output_dir": "exp/edm_tts/injection_conformer", "adam_beta1": 0.8,
                 "adam_beta2": 0.99, **defaults}.items():
        kw.setdefault(k, v)
    kw.setdefault("watch", os.environ.get("WANDB_WATCH") or None)
    return TrainingArguments(**kw)


def build_model(raw: dict, device) -> InjectionConformer:
    """The f32 model the recipe trains, codec frozen."""
    cfg_d, acoustic_model_path = model_config(raw)
    codec = None
    if acoustic_model_path:
        codec = load_codec(acoustic_model_path, device=device)
        cfg_d["codec"] = dataclasses.asdict(codec.config)
    cfg = S2AConfig.from_dict(cfg_d)
    model = InjectionConformer(cfg, device=device)
    init_random_weights(model, raw.get("seed", 42))
    if codec is not None:
        model.acoustic_model = codec
    if raw.get("warm_start_model"):
        load_state(raw["warm_start_model"], model)
    freeze_submodule(model, "acoustic_model")
    return model


def precision(bf16: bool, device):
    """The scope a training run goes through: at f32 on the card, TF32 off
    for the linears and cuDNN's convolutions (``exact_f32``), as the JAX
    package's f32 computes in full f32; otherwise nothing."""
    return exact_f32() if not bf16 and device.type == "cuda" else contextlib.nullcontext()


def s2a_loss(model: InjectionConformer, *, bf16: bool):
    """``(forward(batch, generator, train) -> outputs, loss_fn)`` for the
    Trainer: the training forward, under bf16 autocast when ``bf16``. A
    batch may carry its own bool ``"mask"`` (the masked positions) in place
    of the generator's draw, as the parity tests give both packages one."""
    device_type = next(model.parameters()).device.type

    def forward(batch, generator, train):
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=bf16):
            return model.forward_train(batch["acoustic_tokens"], batch["semantic_tokens"],
                                       generator=generator, train=train,
                                       mask_override=batch.get("mask"))

    def loss_fn(batch, generator):
        out = forward(batch, generator, True)
        # the masked-token count makes micro-batched accumulation exact
        return out["loss"], {"loss_weight": out["n_masked"]}

    return forward, loss_fn


def main_from_dict(raw: dict, *, device="cuda") -> Trainer | None:
    """Train as the recipe ``raw`` says; returns the Trainer (its model and
    logged ``history``), or None for ``preprocessing_only``."""
    device = torch.device(device)
    args = training_arguments(raw)
    model = build_model(raw, device)
    cfg = model.cfg
    bf16 = bool(raw.get("bf16", True))
    segment_frames = int(raw.get("training_segment_length", 15.36)
                         * cfg.codec.sample_rate / cfg.codec.hop_length)

    forward, loss_fn = s2a_loss(model, bf16=bf16)
    dataset = raw.get("dataset_args", {})
    train_iter = code_batch_iterator(
        dataset.get("data_dir", "data/codes"), segment_frames,
        args.per_device_train_batch_size, args.seed, use_pt=dataset.get("format") == "pt")
    if raw.get("preprocessing_only"):
        b = next(train_iter)
        print("preprocessing ok;", {k: v.shape for k, v in b.items()})
        return None

    # held-out evaluation: fixed batches, the same mask draw for every batch
    eval_iter, eval_fn = None, None
    ev = raw.get("eval_dataset_args")
    if ev:
        eval_iter = list(itertools.islice(
            code_batch_iterator(ev["data_dir"], segment_frames,
                                raw.get("per_device_eval_batch_size", 16),
                                seed=args.seed + 1, use_pt=ev.get("format") == "pt"),
            int(raw.get("eval_batches", 4))))

        def eval_fn(batch):
            gen = torch.Generator(device=device).manual_seed(args.seed + 2)
            return {"loss": forward(batch, gen, False)["loss"]}

    trainer = Trainer(args, model, loss_fn, eval_fn=eval_fn, device=device)
    with precision(bf16, device):
        trainer.train(train_iter, eval_iter)
    export_dir = os.path.join(args.output_dir, "export")
    t0 = time.perf_counter()
    save_s2a(export_dir, model)
    logger.info("exported the model to %s in %.2f s", export_dir, time.perf_counter() - t0)
    return trainer


def main(argv: list[str] | None = None) -> None:
    recipe_cli(__doc__.split("\n\n")[0], "the training YAML "
               "(configs/injection_conformer/train_config.yaml)", main_from_dict, argv)


if __name__ == "__main__":
    main()

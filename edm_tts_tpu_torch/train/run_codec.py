"""Codec GAN training on one CUDA card (port of run_codec_training.py).

    python -m edm_tts_tpu_torch.train.run_codec configs/dac/train_config.yaml [--device cpu]

The same YAML surface as the JAX entry point: ``generator_args``
(``CodecConfig``), ``discriminator_args`` (``DiscriminatorConfig``), the two
optimizers' lr and betas, the ExponentialLR gamma, the reconstruction
losses' args (``waveform_args``, ``multi_scale_stft_args``,
``mel_spectrogram_args``), ``lambdas``, the LibriLight (or LibriSpeech)
pipeline with 0.38 s crops, the -40 dB silence filter and -16 dBFS
normalization, ``validation_split`` files held out for eval
(``validation_segment_length`` s crops, batches of 4), ``seed``,
``per_device_train_batch_size``, the step, eval, save and logging
intervals, and ``preprocessing_only`` (one batch through the pipeline,
then exit). Both models train in f32 from a seeded init with the JAX
package's scales (snake alphas 1, ``g = ||v||``); on the card TF32 is off
for matmuls and convolutions, as the JAX package computes f32, so the
codec's residual units run their plain composition (its "auto" rule) and no
kernel launches. ``--device`` (default ``cuda``; without a card the run
exits 2 unless given ``--device cpu``); on the card the run ends with the
kernel launches and the peak device memory. ``main_from_dict`` takes the
parsed recipe, for callers without PyYAML.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.codec.discriminator import Discriminator, DiscriminatorConfig
from edm_tts_tpu_torch.models.codec.losses import ReconstructionLoss
from edm_tts_tpu_torch.ops.precision import exact_f32
from edm_tts_tpu_torch.train.cli import recipe_cli
from edm_tts_tpu_torch.train.gan_trainer import GANTrainer, GANTrainingArguments


@dataclasses.dataclass
class DataArguments:
    dataset_path: str = "librilight"
    dataset_name: str = "all"
    data_dir: str = "data/libri-light/unlab"
    training_segment_length: float = 0.38
    validation_segment_length: float = 5.0
    silence_threshold: float = -40.0
    volume_normalize: float = -16.0
    shuffle_buffer_size: int = 10000
    validation_split: int = 16
    preprocessing_only: bool = False
    # threads of the C++ FLAC-decode pool (0: decode in the loop)
    dataloader_num_workers: int = 0


def build_pipeline(data_args: DataArguments, sample_rate: int, batch_size: int, seed: int):
    """(endless training batches, a factory of one eval pass's batches)."""
    from edm_tts_tpu_torch.data.collators import collate_codec_audio
    from edm_tts_tpu_torch.data.manifests import librilight_manifest, librispeech_manifest
    from edm_tts_tpu_torch.data.pipeline import batched, codec_audio_pipeline

    if "librispeech" in data_args.dataset_path:
        manifest = list(librispeech_manifest(data_args.data_dir, data_args.dataset_name))
    else:
        manifest = list(librilight_manifest(data_args.data_dir, data_args.dataset_name))
    val = manifest[: data_args.validation_split]
    train = manifest[data_args.validation_split:]

    train_iter = batched(
        codec_audio_pipeline(
            train,
            target_sr=sample_rate,
            segment_seconds=data_args.training_segment_length,
            silence_threshold_db=data_args.silence_threshold,
            normalize_dbfs=data_args.volume_normalize,
            shuffle=data_args.shuffle_buffer_size,
            seed=seed,
            prefetch_threads=data_args.dataloader_num_workers,
        ),
        batch_size,
        stack=collate_codec_audio,
    )

    def val_iter():
        return batched(
            codec_audio_pipeline(
                val,
                target_sr=sample_rate,
                segment_seconds=data_args.validation_segment_length,
                silence_threshold_db=data_args.silence_threshold,
                normalize_dbfs=data_args.volume_normalize,
                shuffle=1,
                seed=0,
                repeat=False,
            ),
            4,
            stack=collate_codec_audio,
        )

    return train_iter, val_iter


def training_arguments(raw: dict) -> GANTrainingArguments:
    gen_opt, disc_opt = raw.get("gen_optimizer_args", {}), raw.get("disc_optimizer_args", {})
    return GANTrainingArguments(
        output_dir=raw.get("output_dir", "exp/edm_tts/dac"),
        seed=raw.get("seed", 42),
        max_steps=raw.get("max_steps", 100_000),
        logging_steps=raw.get("logging_steps", 100),
        eval_steps=raw.get("eval_steps", 1000),
        save_steps=raw.get("save_steps", 10_000),
        gen_lr=gen_opt.get("lr", 1e-4),
        disc_lr=disc_opt.get("lr", 1e-4),
        gen_betas=tuple(gen_opt.get("betas", (0.8, 0.99))),
        disc_betas=tuple(disc_opt.get("betas", (0.8, 0.99))),
        scheduler_gamma=raw.get("gen_scheduler_args", {}).get("gamma", 0.999996),
        skip_nonfinite_updates=raw.get("skip_nonfinite_updates", False),
        # the reference trains the codec under WANDB_WATCH=all
        watch=raw.get("watch", os.environ.get("WANDB_WATCH") or None),
    )


def data_arguments(raw: dict) -> DataArguments:
    dataset = raw.get("dataset_args", {})
    return DataArguments(
        data_dir=dataset.get("data_dir", "data"),
        dataset_name=dataset.get("name", "all"),
        dataset_path=dataset.get("path", "librilight"),
        training_segment_length=raw.get("training_segment_length", 0.38),
        validation_segment_length=raw.get("validation_segment_length", 5.0),
        silence_threshold=raw.get("silence_threshold", -40.0),
        volume_normalize=raw.get("volume_normalize", -16.0),
        shuffle_buffer_size=raw.get("shuffle_buffer_size", 10000),
        validation_split=raw.get("validation_split", 16),
        preprocessing_only=raw.get("preprocessing_only", False),
        dataloader_num_workers=raw.get("dataloader_num_workers", 0),
    )


def build_models(raw: dict, device) -> tuple[Codec, Discriminator]:
    """The f32 generator and discriminator from ``seed``."""
    seed = raw.get("seed", 42)
    codec = Codec(CodecConfig.from_dict(raw.get("generator_args", {})), device=device)
    init_random_weights(codec, seed, snake_alpha=1.0)
    disc = Discriminator(DiscriminatorConfig.from_dict(raw.get("discriminator_args", {})),
                         device=device)
    init_random_weights(disc, seed + 1)
    return codec, disc


def main_from_dict(raw: dict, *, device="cuda") -> GANTrainer | None:
    """Train as the recipe ``raw`` says; returns the trainer (its models and
    logged ``history``), or None for ``preprocessing_only``."""
    device = torch.device(device)
    args = training_arguments(raw)
    data_args = data_arguments(raw)
    gen_cfg = CodecConfig.from_dict(raw.get("generator_args", {}))
    train_iter, val_iter = build_pipeline(
        data_args, gen_cfg.sample_rate, int(raw.get("per_device_train_batch_size", 32)),
        args.seed)
    if data_args.preprocessing_only:
        print("preprocessing ok; batch", np.asarray(next(train_iter)).shape, flush=True)
        return None
    codec, disc = build_models(raw, device)
    recon = ReconstructionLoss(gen_cfg.sample_rate, raw.get("waveform_args"),
                               raw.get("multi_scale_stft_args"),
                               raw.get("mel_spectrogram_args") or {})
    trainer = GANTrainer(args, codec, disc, recon, lambdas=raw.get("lambdas"), device=device)
    with exact_f32() if device.type == "cuda" else contextlib.nullcontext():
        trainer.train(train_iter, val_iter)
    return trainer


def main(argv: list[str] | None = None) -> None:
    recipe_cli(__doc__.split("\n\n")[0], "the training YAML (configs/dac/train_config.yaml)",
               main_from_dict, argv)


if __name__ == "__main__":
    main()

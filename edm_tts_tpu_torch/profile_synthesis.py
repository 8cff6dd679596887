"""Where the time of one synthesis request goes on the card.

    python3 -m edm_tts_tpu_torch.profile_synthesis [--out DIR]

Builds bench.py's full-width models in bf16 from a seeded random init (the
default codec and s2a, the t2s with hidden 384, 12 layers, heads 8 x
dim_head 24), warms up with two requests, then answers one request of
bench.py's shape (10 s of audio, a 150-frame prompt, 16 t2s iterations, 8
s2a steps, full canvas) and each of its three stages under
``torch.profiler``. Last it quantizes the models to int8 and profiles one
served batch: three texts of 20-98 bytes through ``TTSEngine.synthesize``
(bucket 4, ~10 s of audio each). Per part it prints the wall time of an
untraced run, the device kernel time (the sum of the kernels' own device
time), the busy share (device time over that wall time), the port's own
kernels (K1-K6, each summed over its template instances) with their device
time, share and calls, and the kernels by device time. Then the training side: the s2a recipe's model
(``s2a_train_recipe``, f32 weights, bf16 autocast) on one random batch of
B32 x 768 frames, profiled as one whole optimizer step of 4 micro-batches
(``train_step``), one micro-batch's forward and backward
(``train_micro_fwd_bwd``) and the AdamW update alone
(``train_optimizer``); and one step of the t2s recipe (``t2s_train_recipe``)
at B32 on a 960-token canvas (``t2s_train_step``). With ``--out`` each table also goes to
``DIR/profile_<part>.txt``.

``full_width_models``, ``bench_inputs``, ``served_engine``,
``SERVED_TEXTS``, ``s2a_train_recipe`` and ``t2s_train_recipe`` are the
models, requests and recipes that chip_smoke.py drives too.
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time
from pathlib import Path

import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig, s2a_sample
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic, t2s_sample
from edm_tts_tpu_torch.pipeline import e2e_synthesize
from edm_tts_tpu_torch.serving import TTSEngine

GEN_FRAMES = 500      # 10 s at 50 Hz
PROMPT_FRAMES = 150   # 3 s speaker prompt
TEXT_LEN = 100
PRED_ITERS = 16
STEPS = 8
TEXT = ("The quick brown fox jumps over the lazy dog while a zero-shot voice "
        "reads this sentence aloud for the smoke run.")
# served requests of 20, 61, 98 and 120 bytes
SERVED_TEXTS = (
    "Hello there, friend.",
    "The weather today is mild, with a light breeze from the west.",
    "Please remember to bring the signed forms, your identity card and a pen "
    "when you come in tomorrow.",
    "A zero-shot voice reads this longer sentence aloud, so that the served path "
    "carries one request of a hundred and twenty.",
)


def full_width_models(device, seed: int, dtype=torch.bfloat16
                      ) -> tuple[TextToSemantic, InjectionConformer]:
    """bench.py's t2s and s2a (with the default codec) in ``dtype`` (bf16
    unless asked), from ``seed``."""
    s2a_cfg = S2AConfig(codec=CodecConfig())
    t2s_cfg = T2SConfig(hidden_size=384, main_encoder_num_layers=12, main_encoder_num_heads=8,
                        main_encoder_dim_head=24, length_predictor_num_heads=8,
                        length_predictor_dim_head=24)
    s2a = InjectionConformer(s2a_cfg, device=device, dtype=dtype).eval()
    t2s = TextToSemantic(t2s_cfg, device=device, dtype=dtype).eval()
    init_random_weights(s2a, seed)
    init_random_weights(t2s, seed + 1)
    return t2s, s2a


def bench_inputs(s2a_cfg: S2AConfig, device, seed: int) -> dict[str, torch.Tensor]:
    """Byte-tokenised text (+5), a random prompt and ``gt_length`` 500."""
    text = torch.tensor([[b + 5 for b in TEXT.encode()[:TEXT_LEN]]], device=device)
    gen = torch.Generator().manual_seed(seed)
    prompt_ac = torch.randint(0, s2a_cfg.num_codevectors,
                              (1, s2a_cfg.num_quantizers, PROMPT_FRAMES), generator=gen)
    prompt_sem = torch.randint(0, s2a_cfg.num_semantic_tokens, (1, PROMPT_FRAMES), generator=gen)
    return dict(text=text, text_len=torch.tensor([text.shape[1]], device=device),
                prompt_ac=prompt_ac.to(device), prompt_sem=prompt_sem.to(device),
                gt_length=torch.tensor([GEN_FRAMES], device=device))


def s2a_train_recipe(output_dir: str, data_dir: str, seed: int, steps: int) -> dict:
    """configs/injection_conformer/train_config.yaml as a dict, cut to
    ``steps`` optimizer steps with a 2-step warmup, logging every step and
    saving once at the end."""
    return {
        "output_dir": output_dir, "seed": seed,
        "extra_model_params": {
            "num_semantic_tokens": 1024, "hidden_size": 1024,
            "injection_layers": [4, 7, 10, 13], "residual": True, "use_injection": True,
            "loss_all": False,
            "encoder_config": {"depth": 16, "heads": 16, "ff_mult": 4, "conv_kernel_size": 5,
                               "attn_dropout": 0.0, "ff_dropout": 0.0, "conv_dropout": 0.0}},
        "dataset_args": {"data_dir": data_dir, "format": "native"},
        "training_segment_length": 15.36, "per_device_train_batch_size": 32,
        "max_steps": steps, "learning_rate": 3.0e-4, "warmup_steps": 2,
        "weight_decay": 0.0, "adam_beta1": 0.8, "adam_beta2": 0.99, "adam_epsilon": 1.0e-8,
        "max_grad_norm": 0.5, "micro_batches": 4, "logging_steps": 1,
        "save_steps": steps, "save_total_limit": 2, "bf16": True,
    }


def t2s_train_recipe(output_dir: str, data_dir: str, seed: int, steps: int) -> dict:
    """configs/text_to_semantic_w_length/train_config.yaml as a dict, cut to
    ``steps`` optimizer steps with a 2-step warmup, logging every step and
    saving once at the end."""
    return {
        "output_dir": output_dir, "seed": seed,
        "extra_model_params": {
            "hidden_size": 384, "semantic_vocab_size": 1024, "text_vocab_size": 256,
            "main_encoder_num_layers": 12, "main_encoder_num_heads": 8,
            "main_encoder_dim_head": 24, "length_predictor_num_layers": 4,
            "length_predictor_num_heads": 8, "length_predictor_dim_head": 24},
        "dataset_args": {"data_dir": data_dir, "format": "native"},
        "per_device_train_batch_size": 32, "max_steps": steps, "learning_rate": 2.5e-4,
        "warmup_steps": 2, "weight_decay": 0.0, "adam_beta1": 0.8, "adam_beta2": 0.99,
        "adam_epsilon": 1.0e-8, "max_grad_norm": 0.5, "logging_steps": 1, "save_steps": steps,
        "save_total_limit": 2, "bf16": True,
    }


def _profile_training(dev, seed: int, out: Path | None) -> None:
    """One s2a optimizer step at the recipe's size, and its two parts."""
    from edm_tts_tpu_torch.train.run_s2a import build_model, s2a_loss, training_arguments
    from edm_tts_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        raw = s2a_train_recipe(tmp + "/out", tmp, seed, steps=100)
        model = build_model(raw, dev)
        cfg = model.cfg
        _, loss_fn = s2a_loss(model, bf16=True)
        trainer = Trainer(training_arguments(raw), model, loss_fn, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        b, t = raw["per_device_train_batch_size"], 768
        batch = {"acoustic_tokens": torch.randint(0, cfg.num_codevectors, (b, cfg.num_quantizers, t),
                                                  generator=gen, device=dev),
                 "semantic_tokens": torch.randint(0, cfg.num_semantic_tokens, (b, t),
                                                  generator=gen, device=dev)}
        micro = {k: v[: b // raw["micro_batches"]] for k, v in batch.items()}
        steps = iter(range(1000))
        for _ in range(2):  # warm-up
            trainer.train_step(batch, next(steps))
        _profile("train_step", lambda: trainer.train_step(batch, next(steps)), out)

        def micro_fwd_bwd():
            with torch.enable_grad():
                loss, _ = loss_fn(micro, torch.Generator(device=dev).manual_seed(seed))
                loss.backward()

        _profile("train_micro_fwd_bwd", micro_fwd_bwd, out)
        _profile("train_optimizer", trainer.optimizer.step, out)
        trainer.metrics.close()


def _profile_t2s_training(dev, seed: int, out: Path | None) -> None:
    """One t2s optimizer step of the recipe at B32 on a 960-token canvas
    (700 semantic tokens, 210 text bytes: a middle length bucket)."""
    import numpy as np

    from edm_tts_tpu_torch.data.collators import collate_t2s
    from edm_tts_tpu_torch.train import run_t2s
    from edm_tts_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        raw = t2s_train_recipe(tmp + "/out", tmp, seed, steps=100)
        model = run_t2s.build_model(raw, dev)
        _, loss_fn = run_t2s.t2s_loss(model, bf16=True)
        trainer = Trainer(run_t2s.training_arguments(raw, **run_t2s.T2S_DEFAULTS), model,
                          loss_fn, device=dev)
        rng = np.random.default_rng(seed)
        batch = collate_t2s([{"semantic_tokens": rng.integers(0, 1024, 700),
                              "transcription_bytes": rng.integers(0, 256, 210).tolist()}
                             for _ in range(raw["per_device_train_batch_size"])])
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        steps = iter(range(1000))
        for _ in range(2):  # warm-up
            trainer.train_step(batch, next(steps))
        _profile("t2s_train_step", lambda: trainer.train_step(batch, next(steps)), out)
        trainer.metrics.close()


@torch.no_grad()
def served_engine(t2s: TextToSemantic, s2a: InjectionConformer, device, seed: int,
                  semantic=None) -> TTSEngine:
    """An int8 engine over the models (quantized in place) with a random
    150-frame speaker prompt registered as "spk"; ``semantic`` (a
    ``SemanticTokenizerHubert``, not quantized) lets it register speakers
    from wavs.

    Random weights predict lengths of a frame or two; the length head is
    set to predict ~480 frames (~10 s), the length of a long sentence.
    """
    t2s.length_pred_head.weight.mul_(0.02)
    t2s.length_pred_head.bias.fill_(math.log(480.0))
    engine = TTSEngine.from_models(t2s, s2a, semantic, device=device, quantize="int8",
                                   pred_iters=PRED_ITERS, s2a_steps=STEPS, max_speech_len=1250)
    cfg = s2a.cfg
    gen = torch.Generator().manual_seed(seed)
    engine.register_speaker_codes(
        "spk", torch.randint(0, cfg.num_codevectors, (1, cfg.num_quantizers, PROMPT_FRAMES),
                             generator=gen),
        torch.randint(0, cfg.num_semantic_tokens, (1, PROMPT_FRAMES), generator=gen))
    return engine


def _profile(name: str, fn, out: Path | None) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels are the device-side events; a CPU op's device time repeats theirs
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"[{name}] wall {wall * 1e3:.3f} ms, device kernel time {device_us / 1e3:.3f} ms "
          f"in {sum(e.count for e in kernels)} kernels, busy share {device_us / 1e6 / wall:.3f}",
          flush=True)
    # the port's own kernels (K1-K6), whether or not they make the top rows,
    # each summed over its template instances (K5's tiles, K3's query tiles)
    ours: dict[str, list] = {}
    for e in kernels:
        if "edm::" in e.key:
            kernel = ours.setdefault(e.key.split("edm::")[1].split("(")[0].split("<")[0], [0, 0])
            kernel[0] += e.self_device_time_total
            kernel[1] += e.count
    mine = f"[{name}] port kernels: " + (", ".join(
        f"{k} {us / 1e3:.3f} ms ({100 * us / device_us:.1f} %, {n} calls)"
        for k, (us, n) in sorted(ours.items(), key=lambda kv: -kv[1][0])) or "none")
    print(mine, flush=True)
    table = events.table(sort_by="self_device_time_total", row_limit=14, max_name_column_width=60)
    print(table, flush=True)
    if out is not None:
        (out / f"profile_{name}.txt").write_text(f"{mine}\n{table}")


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None, help="directory for the tables")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_synthesis: needs a CUDA device")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    t2s, s2a = full_width_models(dev, args.seed)
    inp = bench_inputs(s2a.cfg, dev, args.seed)

    def request(seed: int) -> dict:
        return e2e_synthesize(
            t2s, s2a, inp["text"], inp["text_len"], inp["prompt_ac"], inp["prompt_sem"],
            torch.Generator().manual_seed(seed), pred_iters=PRED_ITERS, steps=STEPS,
            max_speech_len=GEN_FRAMES, gt_length=inp["gt_length"], assume_full_canvas=True)

    for i in range(2):
        request(i)
    _profile("e2e", lambda: request(7), args.out)
    gen = torch.Generator().manual_seed(args.seed + 5)
    t2s_out = t2s_sample(t2s, inp["text"], inp["text_len"], gen, pred_iters=PRED_ITERS,
                         max_speech_len=GEN_FRAMES, gt_length=inp["gt_length"])
    codes = s2a_sample(s2a, t2s_out["semantic_tokens"], inp["prompt_ac"], inp["prompt_sem"],
                       gen, steps=STEPS)
    _profile("t2s", lambda: t2s_sample(t2s, inp["text"], inp["text_len"], gen,
                                       pred_iters=PRED_ITERS, max_speech_len=GEN_FRAMES,
                                       gt_length=inp["gt_length"]), args.out)
    _profile("s2a", lambda: s2a_sample(s2a, t2s_out["semantic_tokens"], inp["prompt_ac"],
                                       inp["prompt_sem"], gen, steps=STEPS), args.out)
    _profile("decode", lambda: s2a.decode_audio(codes), args.out)
    engine = served_engine(t2s, s2a, dev, args.seed)
    engine.synthesize(list(SERVED_TEXTS[:3]), "spk", seed=1)  # warm-up at these shapes
    _profile("served_int8_batch", lambda: engine.synthesize(list(SERVED_TEXTS[:3]), "spk", seed=7),
             args.out)
    del t2s, s2a, engine
    torch.cuda.empty_cache()
    _profile_training(dev, args.seed, args.out)
    torch.cuda.empty_cache()
    _profile_t2s_training(dev, args.seed, args.out)


if __name__ == "__main__":
    main()

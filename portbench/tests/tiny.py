"""Tiny configurations and cells for the CPU tests: the published
architecture at widths a test run holds, in f32."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness

T2S = {"hidden_size": 64, "semantic_vocab_size": 64, "text_vocab_size": 256,
       "main_encoder_num_layers": 2, "main_encoder_num_heads": 2, "main_encoder_dim_head": 16,
       "main_encoder_ff_mult": 4, "main_encoder_conv_kernel_size": 5,
       "length_predictor_num_layers": 1, "length_predictor_num_heads": 2,
       "length_predictor_dim_head": 16, "length_predictor_ff_mult": 4,
       "length_predictor_conv_kernel_size": 5}
S2A = {"hidden_size": 128, "num_semantic_tokens": 64, "encoder_num_heads": 2,
       "encoder_num_layers": 4, "encoder_ff_mult": 4, "encoder_conv_kernel_size": 5,
       "encoder_attn_dropout": 0.0, "encoder_ff_dropout": 0.0, "encoder_conv_dropout": 0.0,
       "injection_layers": [1, 2], "residual": True, "use_injection": True, "loss_all": False}
CODEC = {"sample_rate": 16000, "encoder_dim": 4, "encoder_rates": [2, 2], "decoder_dim": 32,
         "decoder_rates": [2, 2], "n_codebooks": 4, "codebook_size": 64, "codebook_dim": 8,
         "quantizer_dropout": 0.5}
SERVE_CONFIG = {
    "name": "tiny_int8", "t2s": T2S, "s2a": S2A, "codec": CODEC,
    "serving": {"dtype": "float32", "quantize": "int8", "pred_iters": 4, "s2a_steps": 3,
                "temperature": 1.0, "max_speech_len": 48, "text_bucket": 8, "length_bucket": 8,
                "batch_buckets": [1, 2, 4]},
    "assumed": {"length_head_scale": 0.02, "length_head_frames": 20, "prompt_frames": 6},
    "reduced": [],
}
OFFLINE = {"config": "tiny_int8",
           "traffic": {"kind": "offline_batches", "rows": 4, "text_bytes": [10, 24]},
           "trace": {"first": 1, "count": 1},
           "check": {"calls": 2, "among": 3, "rows_per_block": 2},
           "limits": {"canvas": 0, "length_gap": 1e-3, "t2s_gap": 1e-3, "s2a_start": 1e-4,
                      "s2a_state": 1e-4, "s2a_gap": 1e-3, "decode_err": 1e-4, "answer": 0}}


def context(spec: dict, cfg: dict, *, seed: int = 3, seconds: float = 0.0, traced=False,
            control=None) -> harness.Context:
    return harness.Context("tiny", copy.deepcopy(spec), copy.deepcopy(cfg), seed, seconds, traced,
                           torch.device("cpu"), time.perf_counter(), control)

TRAIN_CONFIG = {
    "name": "tiny_recipe", "s2a": S2A, "codec": CODEC,
    "recipe": {"per_device_train_batch_size": 4, "frames": 16, "micro_batches": 2, "bf16": False,
               "learning_rate": 3e-4, "warmup_steps": 4000, "max_steps": 100000,
               "weight_decay": 0.0, "adam_beta1": 0.8, "adam_beta2": 0.99, "adam_epsilon": 1e-8,
               "max_grad_norm": 0.5},
    "reduced": [],
}
TRAIN = {"config": "tiny_recipe", "traffic": {"kind": "train_steps"},
         "trace": {"first": 1, "count": 1},
         "limits": {"loss": 1e-4, "grad": 1e-3, "update": 1e-2}}

OPEN = {"config": "tiny_int8",
        "traffic": {"kind": "open_loop", "rate": 20.0,
                    "speech_s": {"median": 0.004, "sigma": 0.6, "min": 0.001, "max": 0.01},
                    "bytes_per_s": 3000, "bytes_jitter": 0.2, "lead_s": 0.3, "drain_s": 30,
                    "request_seed": 0,
                    "batcher": {"max_batch": 4, "max_wait_ms": 25, "lookahead": 4,
                                "max_queue": 256}},
        "trace": {"start_s": 0.2, "seconds": 0.3, "settle_s": 0.1},
        "check": {"requests": 2, "rows_per_block": 4},
        "limits": OFFLINE["limits"]}

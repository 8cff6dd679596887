"""The t2s and s2a training entry points' command lines on the CPU: ``main``
takes the recipe and ``--device`` (``cuda`` by default, an error without a
card), trains a tiny recipe to its export, and prints no launch line off
the card; and the batch iterators raise, where they would loop forever, on
shards that can give no batch.
"""

import json

import numpy as np
import pytest
import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.data.token_shards import TokenShardWriter
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.train import run_s2a, run_t2s
from edm_tts_tpu_torch.train.export import save_pretrained
from edm_tts_tpu_torch.utils import hub
from torch_port_parity import TINY_CODEC, TINY_S2A, TINY_T2S


def _shards(path, n, frames, seed=0):
    """``n`` seeded items of ``frames`` frames (4 x 16 codes, 8 semantic
    ids) with text bytes a third as long."""
    rng = np.random.default_rng(seed)
    w = TokenShardWriter(str(path), items_per_shard=8)
    for i in range(n):
        w.add(f"u{i}", rng.integers(0, 16, (4, frames)), rng.integers(0, 8, frames),
              text_bytes=rng.integers(0, 256, frames // 3).tolist())
    w.close()


def _recipe(tmp_path, stage):
    raw = {"output_dir": str(tmp_path / stage), "seed": 3, "bf16": False,
           "dataset_args": {"data_dir": str(tmp_path / "codes"), "format": "native"},
           "per_device_train_batch_size": 4, "max_steps": 2, "warmup_steps": 1,
           "logging_steps": 1, "save_steps": 2}
    if stage == "t2s":
        return {**raw, "extra_model_params": TINY_T2S}
    codec = Codec(CodecConfig(**TINY_CODEC))
    init_random_weights(codec, 4)
    save_pretrained(str(tmp_path / "codec"), codec, codec.config.to_json())
    return {**raw, "acoustic_model_path": str(tmp_path / "codec"),
            "extra_model_params": dict(TINY_S2A), "training_segment_length": 0.32}


@pytest.mark.parametrize("stage", ["t2s", "s2a"])
def test_main_trains_on_the_cpu_and_needs_a_card_by_default(stage, tmp_path, capsys):
    _shards(tmp_path / "codes", 8, 30)
    config = tmp_path / f"{stage}.yaml"
    config.write_text(json.dumps(_recipe(tmp_path, stage)))  # JSON is YAML
    module = run_t2s if stage == "t2s" else run_s2a
    module.main([str(config), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "kernel launches" not in out and "peak device memory" not in out
    records = [json.loads(line) for line in open(tmp_path / stage / "metrics.jsonl")]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in records if "train/loss" in r)
    load = hub.load_t2s if stage == "t2s" else hub.load_s2a
    assert load(str(tmp_path / stage / "export"), device="cpu") is not None
    if not torch.cuda.is_available():  # one argument: the card, as before
        with pytest.raises(SystemExit) as e:
            module.main([str(config)])
        assert e.value.code == 2


def test_batch_iterators_raise_where_no_batch_can_come(tmp_path):
    _shards(tmp_path / "codes", 3, 30)
    codes = str(tmp_path / "codes")
    with pytest.raises(ValueError, match="31 frames long"):
        next(run_s2a.code_batch_iterator(codes, 31, 2, seed=0))
    assert next(run_s2a.code_batch_iterator(codes, 30, 2, seed=0))[
        "acoustic_tokens"].shape == (2, 4, 30)
    with pytest.raises(ValueError, match="fewer than 4 items"):
        next(run_t2s.t2s_batch_iterator(codes, 4, seed=0))
    assert next(run_t2s.t2s_batch_iterator(codes, 3, seed=0))["input_ids"].shape[0] == 3

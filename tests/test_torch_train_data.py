"""The host-side modules of the port's training slice that are copies of
the JAX package's (token shards, the crop and shuffle helpers, the s2a
collator, the YAML loader, the preemption guard), pinned equal to their
originals; and the port's import rules: nothing of jax, flax, optax or the
JAX package anywhere, and no module-level ``yaml`` import (PyYAML is not on
the card's machine).
"""

import ast
import inspect
import random
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from edm_tts_tpu.data import collators as j_collators
from edm_tts_tpu.data import pipeline as j_pipeline
from edm_tts_tpu.data import token_shards as j_token_shards
from edm_tts_tpu.train import preemption as j_preemption
from edm_tts_tpu.utils import config as j_config
from edm_tts_tpu_torch.data import collators, pipeline, token_shards
from edm_tts_tpu_torch.train import preemption
from edm_tts_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parent.parent


def _items(rng, n):
    out = []
    for i in range(n):
        t = int(rng.integers(5, 40))
        out.append((f"utt{i}", rng.integers(0, 1024, (12, t)), rng.integers(0, 1024, (t, 1)),
                    f"text {i}" if i % 2 else None, [int(b) for b in b"abc"] if i % 3 else None))
    return out


def _read_all(it):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in ex.items()}
            for ex in it]


def test_token_shards_equal_jax(tmp_path):
    items = _items(np.random.default_rng(0), 7)
    for pkg, d in ((token_shards, tmp_path / "port"), (j_token_shards, tmp_path / "jax")):
        w = pkg.TokenShardWriter(str(d), rank=1, items_per_shard=3)
        for item_id, a, s, text, tb in items:
            w.add(item_id, a, s, text=text, text_bytes=tb)
        w.close()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 6
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert (_read_all(token_shards.iter_token_shards(str(tmp_path / "jax")))
            == _read_all(j_token_shards.iter_token_shards(str(tmp_path / "jax"))))
    blob = {f"u{i}": {"acoustic_codes": torch.from_numpy(a.astype(np.int16)),
                      "semantic_codes": torch.from_numpy(s.astype(np.int16))}
            for i, (_, a, s, _, _) in enumerate(items)}
    torch.save(blob, tmp_path / "0_0.pt")
    assert (_read_all(token_shards.iter_reference_pt_shards(str(tmp_path)))
            == _read_all(j_token_shards.iter_reference_pt_shards(str(tmp_path))))


def test_crop_shuffle_and_collate_equal_jax():
    rng = np.random.default_rng(1)
    examples = [{"acoustic_tokens": rng.integers(0, 9, (12, t)), "semantic_tokens": rng.integers(0, 9, t)}
                for t in rng.integers(10, 60, 40)]
    for buf, seed in ((1, 0), (7, 3), (100, 5)):
        assert ([id(e) for e in pipeline.shuffle_buffer(examples, buf, seed)]
                == [id(e) for e in j_pipeline.shuffle_buffer(examples, buf, seed)])
    for random_segment in (True, False):
        r1, r2 = random.Random(4), random.Random(4)
        crops = [pipeline.crop_code_example(e, 24, r1, random_segment) for e in examples]
        j_crops = [j_pipeline.crop_code_example(e, 24, r2, random_segment) for e in examples]
        assert [c is None for c in crops] == [c is None for c in j_crops]
        kept = [c for c in crops if c is not None]
        j_kept = [c for c in j_crops if c is not None]
        out, ref = collators.collate_s2a(kept), j_collators.collate_s2a(j_kept)
        assert out.keys() == ref.keys()
        for k in out:
            assert out[k].dtype == ref[k].dtype == np.int32
            np.testing.assert_array_equal(out[k], ref[k])


def test_load_yaml_and_preemption_guard_equal_jax(tmp_path):
    path = ROOT / "configs" / "injection_conformer" / "train_config.yaml"
    assert config.load_yaml(str(path)) == j_config.load_yaml(str(path))
    assert (inspect.getsource(preemption.PreemptionGuard)
            == inspect.getsource(j_preemption.PreemptionGuard))
    with preemption.PreemptionGuard() as guard:
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered


def test_port_imports_no_jax_optax_or_module_level_yaml():
    port = ROOT / "edm_tts_tpu_torch"
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in port.rglob("*.py") if p.name != "__init__.py")
    code = (f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in [*modules, "chip_smoke"])
            + "bad = sorted(m for m in sys.modules\n"
              "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'yaml', 'edm_tts_tpu'))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    for path in [ROOT / "chip_smoke.py", *sorted(port.rglob("*.py"))]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import | ast.ImportFrom):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                roots = {n.split(".")[0] for n in names}
                assert not roots & {"jax", "flax", "optax", "edm_tts_tpu"}, (path, names)
        for node in tree.body:  # module level
            if isinstance(node, ast.Import | ast.ImportFrom):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert "yaml" not in {n.split(".")[0] for n in names}, path


@pytest.mark.parametrize("name", ["train_config.yaml", "longrun_tpu.yaml"])
def test_run_s2a_reads_the_recipes(name):
    """The recipe's nested encoder_config maps to the flat fields, as the
    JAX entry point maps it."""
    from edm_tts_tpu_torch.models.s2a import S2AConfig
    from edm_tts_tpu_torch.train.run_s2a import model_config, training_arguments

    raw = config.load_yaml(str(ROOT / "configs" / "injection_conformer" / name))
    cfg_d, codec_path = model_config(raw)
    cfg = S2AConfig.from_dict(cfg_d)
    assert codec_path == raw["acoustic_model_path"]
    assert (cfg.encoder_num_layers, cfg.encoder_num_heads, cfg.encoder_conv_kernel_size) == (16, 16, 5)
    assert cfg.encoder_ff_dropout == cfg.encoder_attn_dropout == cfg.encoder_conv_dropout == 0.0
    args = training_arguments(raw)
    assert (args.adam_beta1, args.adam_beta2, args.micro_batches, args.max_grad_norm) == (0.8, 0.99, 4, 0.5)
    assert args.per_device_train_batch_size == 32 and args.learning_rate == 3e-4

"""The port's process-group helpers and mesh on 2 gloo ranks (what JAX
tests/test_dist_multiprocess.py holds for ``jax.distributed``).

One spawn of 2 ranks (tests/torch_dist_workers.py) started by
``parallel.dist.initialize`` from ``torchrun``'s environment: rank and
world, a barrier, the gather of a host scalar, the weighted global mean of
per-rank sums, disjoint ``shard_for_process`` slices, the (data, fsdp)
layout and its ValueErrors, and the trainers' eval metrics: each rank
evaluates different batches (a different number of them), and both
report the same global mean, the one computed here from every rank's
batches.
"""

import copy

import numpy as np
import pytest
import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.codec.discriminator import Discriminator, DiscriminatorConfig
from edm_tts_tpu_torch.parallel import dist, mesh
from edm_tts_tpu_torch.train.gan import gan_eval_step
from test_torch_codec_train import TINY_DISC, TINY_GAN_CODEC
from torch_dist_workers import gan_trainer, spawn
from torch_port_parity import s2a_pair


def _eval_batches(rng, n):
    out = []
    for _ in range(n):
        mask = rng.random((4, 12)) < 0.5
        mask[:, 0] = True
        out.append({"acoustic_tokens": rng.integers(0, 16, (4, 4, 12)).astype(np.int32),
                    "semantic_tokens": rng.integers(0, 8, (4, 12)).astype(np.int32),
                    "mask": mask})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    s2a = s2a_pair(seed=3)[2]
    codec = Codec(CodecConfig(**{**TINY_GAN_CODEC, "quantizer_dropout": 0.0}))
    init_random_weights(codec, 0, snake_alpha=1.0)
    disc = Discriminator(DiscriminatorConfig(**{**TINY_DISC, "rates": ()}))
    init_random_weights(disc, 1)
    rng = np.random.default_rng(3)
    inputs = dict(s2a=s2a, codec=codec, disc=disc,
                  eval_batches=[_eval_batches(rng, 2), _eval_batches(rng, 3)],
                  eval_audio=[[(0.1 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
                               for _ in range(n)] for n in (2, 3)])
    torch.save(inputs, tmp / "inputs.pt")
    return spawn("dist", 2, tmp), inputs


def test_process_info_barrier_and_gather(run):
    results, _ = run
    assert [r["info"] for r in results] == [(0, 2), (1, 2)]
    assert all(r["gathered"] == [1.0, 2.0] for r in results)


def test_global_mean_metrics_weights_each_rank_by_its_count(run):
    results, _ = run
    # sums 10 and 20 over 1 + 2 batches; b: 0 and 1
    for r in results:
        assert r["global_mean"] == pytest.approx({"a": 30.0 / 3, "b": 1.0 / 3})


def test_shard_for_process_gives_disjoint_slices(run):
    results, _ = run
    assert results[0]["shard"] == [0, 2, 4, 6, 8]
    assert results[1]["shard"] == [1, 3, 5, 7, 9]


def test_mesh_layout_and_its_checks(run):
    results, _ = run
    for rank, r in enumerate(results):
        shape, coords, batch_index, fsdp_ranks, data_group = r["mesh"]
        assert shape == {"data": 1, "fsdp": 2, "model": 1}
        assert coords == {"data": 0, "fsdp": rank, "model": 0} and batch_index == rank
        assert fsdp_ranks == [0, 1] and data_group is None  # a data axis of 1: no group
        assert r["mesh_errors"] == [True] * 4
        assert r["hybrid"] == {"data": 1, "fsdp": 2, "model": 1}


def test_trainer_eval_metrics_are_global(run):
    results, inputs = run
    model = inputs["s2a"]
    total, n = 0.0, 0
    with torch.no_grad():
        for rank, batches in enumerate(inputs["eval_batches"]):
            for b in batches:  # each rank evaluates its half of the rows
                rows = {k: torch.as_tensor(v[rank * 2:(rank + 1) * 2]) for k, v in b.items()}
                total += float(model.forward_train(rows["acoustic_tokens"], rows["semantic_tokens"],
                                                   mask_override=rows["mask"])["loss"])
                n += 1
    assert results[0]["s2a_eval"] == results[1]["s2a_eval"]
    assert results[0]["s2a_eval"]["loss"] == pytest.approx(total / n, rel=1e-6)


def test_gan_eval_metrics_are_global(run, tmp_path):
    results, inputs = run
    gan = gan_trainer(copy.deepcopy(inputs["codec"]), copy.deepcopy(inputs["disc"]), tmp_path,
                      steps=1)
    losses = []
    for rank, batches in enumerate(inputs["eval_audio"]):
        for audio in batches:
            mel, _ = gan_eval_step(gan.codec, gan.recon_loss,
                                   torch.as_tensor(audio[rank:rank + 1]))
            losses.append(float(mel))
    assert results[0]["gan_eval"] == results[1]["gan_eval"]
    assert results[0]["gan_eval"]["mel_loss"] == pytest.approx(np.mean(losses), rel=1e-6)


def test_one_process_is_a_world_of_one():
    assert dist.process_info() == (0, 1)
    assert dist.initialize("cpu") == torch.device("cpu")  # no torchrun environment: nothing
    assert dist.all_gather_metrics(3.0).tolist() == [3.0]
    assert dist.global_mean_metrics({"a": 6.0}, 3) == {"a": 2.0}
    m = mesh.make_mesh()
    assert m.shape == {"data": 1, "fsdp": 1, "model": 1} and not m.distributed
    assert m.group("data") is None and m.local_rows({"x": np.arange(4)})["x"].tolist() == [0, 1, 2, 3]
    for kw in ({"n_fsdp": 2}, {"n_seq": 2}, {"n_model": 2}):
        with pytest.raises(ValueError, match="processes"):
            mesh.make_mesh(**kw)
    with pytest.raises(ValueError, match="ring"):
        from edm_tts_tpu_torch.ops import mha

        q = torch.zeros(1, 4, 1, 8)
        mha(q, q, q, implementation="ring")

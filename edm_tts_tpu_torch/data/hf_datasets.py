"""HF ``datasets`` compatibility wrappers (a copy of
edm_tts_tpu/data/hf_datasets.py, pinned equal by
tests/test_torch_preprocess.py).

The reference exposes its corpora as HF datasets builder scripts consumed
via ``datasets.load_dataset(path=<script>, ...)``. The port's pipeline is
manifest-based (data/manifests.py), but users coming from the reference
can get ``datasets.Dataset``/``IterableDataset`` objects with the same
schemas through these wrappers. ``datasets`` is imported only inside
``load_dataset``; nothing on the card's path calls it.
"""

from __future__ import annotations

from typing import Iterator

from edm_tts_tpu_torch.data.manifests import (
    libriheavy_manifest,
    librilight_manifest,
    librispeech_manifest,
)


def load_dataset(name: str, data_dir: str, subset: str = "all",
                 streaming: bool = True, **kwargs):
    """``name`` in {librispeech, librilight, libriheavy, codes, text_codes}.

    Returns an HF ``IterableDataset`` (streaming=True) or ``Dataset``.
    """
    import datasets

    def gen() -> Iterator[dict]:
        if name == "librispeech":
            yield from librispeech_manifest(data_dir, subset)
        elif name == "librilight":
            yield from librilight_manifest(data_dir, subset)
        elif name == "libriheavy":
            yield from libriheavy_manifest(data_dir, subset)
        elif name in ("codes", "text_codes"):
            from edm_tts_tpu_torch.data.token_shards import iter_token_shards

            yield from iter_token_shards(data_dir)
        else:
            raise ValueError(f"unknown dataset {name!r}")

    if streaming:
        return datasets.IterableDataset.from_generator(gen)
    return datasets.Dataset.from_generator(gen)

"""YAML training configs (``load_yaml`` of edm_tts_tpu/utils/config.py).

PyYAML is imported only when a file is read: the card's machine does not
have it, and there the recipe is passed as a dict
(``train.run_s2a.main_from_dict``).
"""

from __future__ import annotations


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)

"""YAML training configs (``load_yaml`` of edm_tts_tpu/utils/config.py).

PyYAML is imported only when a file that is not JSON is read. The card's
machine does not have it: there a recipe is passed as a dict
(``main_from_dict`` of the training entry points) or written as JSON, which
is YAML too and which ``load_yaml`` reads with ``json`` (PyYAML would take
an exponent without a dot, ``1e-05``, for a string).
"""

from __future__ import annotations

import json


def load_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml

        return yaml.safe_load(text)

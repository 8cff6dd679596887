"""The command line that every training entry point shares
(``train.run_codec``, ``train.run_t2s``, ``train.run_s2a``)."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from edm_tts_tpu_torch.kernels import all_launches
from edm_tts_tpu_torch.utils.config import load_yaml
from edm_tts_tpu_torch.utils.logging import setup_logging


def recipe_cli(description: str, config_help: str, main_from_dict,
               argv: list[str] | None = None) -> None:
    """A training entry point's command line: the recipe's path and
    ``--device`` (``cuda`` by default, an error without a card; ``cpu``);
    runs ``main_from_dict`` on the recipe, then on the card prints the peak
    device memory and, last, the kernel launches."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("config", help=config_help)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device here (pass --device cpu to run on "
                 "the CPU)")
    setup_logging()
    main_from_dict(load_yaml(args.config), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device)} bytes", flush=True)
        print(f"kernel launches: {json.dumps(all_launches())}", flush=True)

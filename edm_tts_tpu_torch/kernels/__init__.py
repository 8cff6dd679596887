"""Hand-written CUDA kernels: build, bindings and launch counters.

``launches`` counts, per kernel, how many times its wrapper launched it on
the card. It is the one piece of global state in the port: a run resets it,
drives the main path and reads it back to show which kernels the path went
through. Wrappers that take the plain version (CPU tensors) do not count.
"""

from __future__ import annotations

KERNELS = ("resunit", "decoder_block", "attention", "int8_dense")

launches: dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0

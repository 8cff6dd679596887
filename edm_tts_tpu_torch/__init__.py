"""PyTorch/CUDA port of the EDM-TTS synthesis path.

Mirrors edm_tts_tpu (the JAX package, which stays the reference): ops/,
models/{codec,conformer,t2s,s2a}/ and pipeline.py, plus csrc/ (the
hand-written CUDA kernels) and kernels/ (their nvcc build, ctypes bindings
and launch counters). Imports torch and numpy, never jax.
"""

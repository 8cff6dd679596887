"""The plain reference the benchmark judges the port against.

Plain PyTorch in float32 (TF32 off on the card), written from the
published EDM-TTS models: the Conformer block, the text->semantic model
with its length predictor, the semantic->acoustic injection Conformer, the
DAC decoder with its residual VQ, weight-only int8 quantization, the
samplers' positional noise and the recipe's AdamW. It imports nothing of
the port, of JAX or of the JAX package, and takes nothing the port made:
every function reads a state dict of reference-format names that the
benchmark made from the seed (``portbench.weights``) and works out its own
quantized weights, features and noise from it.
"""

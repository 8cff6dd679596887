"""The benchmark of the PyTorch/CUDA port (``edm_tts_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card (see ``run.py`` and
``README.md``). Importing this package imports nothing of the port.
"""

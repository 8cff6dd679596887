"""Model definitions of the port (counterparts of edm_tts_tpu/models)."""

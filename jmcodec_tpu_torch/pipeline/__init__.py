"""Encode-side pipeline pieces: rate control (the port's copy of
jmcodec_tpu/pipeline/ratecontrol.py)."""

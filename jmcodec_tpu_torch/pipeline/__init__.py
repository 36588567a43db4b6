"""Pipeline pieces: rate control (the port's copy of
jmcodec_tpu/pipeline/ratecontrol.py) and GOP scheduling with resumable
transcode manifests (gop.py)."""

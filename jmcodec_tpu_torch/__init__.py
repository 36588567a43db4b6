"""PyTorch/CUDA port of jmcodec_tpu's device paths.

The package stands alone: it imports torch and numpy, never jax and never
jmcodec_tpu. The host front end (codec/: NAL, parameter-set and
slice-header parsing, FrameSymbols, HevcFramePlan; native/: the C++ slice
parsers; utils/bits.py) is its own copy under the same relative names as
in jmcodec_tpu. Everything that ran on the TPU is written anew in torch
(kernels/, ops/), with one hand-written CUDA kernel per Pallas kernel
(csrc/). The entry points run on the card unless the caller names a device.
"""

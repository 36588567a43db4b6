"""PyTorch/CUDA port of jmcodec_tpu's device paths.

The package stands alone: it imports torch and numpy, never jax and never
jmcodec_tpu. The host side (codec/: NAL, parameter-set and slice-header
parsing, FrameSymbols, HevcFramePlan, the numpy H.264 decoder of the
session's host path; native/: the C++ slice parsers; ops/: the numpy
twins the host decoder calls; utils/bits.py, utils/metrics.py) is its own
copy under the same relative names as in jmcodec_tpu. Everything that ran
on the TPU is written anew in torch (kernels/, ops/), with one
hand-written CUDA kernel per Pallas kernel (csrc/). The entry points
(api/: the streaming DecoderSession, the batch and stream decodes;
parallel/: the multi-rank layer on torch.distributed; pipeline/gop.py and
the CLIs under tools/; entry.py) run on the card unless the caller names
a device.
"""

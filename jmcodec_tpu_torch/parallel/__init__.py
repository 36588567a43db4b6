"""The parallel layer on torch.distributed: the port of
jmcodec_tpu/parallel. One process per rank, NCCL on the card and gloo on
the CPU; where the JAX package builds a mesh and shard_maps a function,
every rank here calls the function with the same arguments and works on
its own shard (mesh.py, distributed.py, decode_sharded.py, transcode.py,
spatial.py, framepp.py)."""

"""H.264 pixel math on int32 torch tensors, with its spec tables."""

"""HEVC host front end: NAL units, parameter sets, slice headers, the
HevcFramePlan tensors and the spec tables of transform and intra."""

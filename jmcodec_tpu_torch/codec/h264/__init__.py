"""H.264 host front end: NAL units, parameter sets, slice headers, the
native-parser picture front end and its FrameSymbols."""

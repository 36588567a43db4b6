"""Bitstream syntax layers and the host/device interface types."""

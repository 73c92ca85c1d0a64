"""Zoo CNNs of the port (NCHW tensors in channels_last memory)."""

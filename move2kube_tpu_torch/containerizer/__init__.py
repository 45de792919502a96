"""Emission of the port: the image payload for a detected GPU workload
(:mod:`.cuda_emit`)."""

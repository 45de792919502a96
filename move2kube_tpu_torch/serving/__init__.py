"""Paged-KV serving of the port."""

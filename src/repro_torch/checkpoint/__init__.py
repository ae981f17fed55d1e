"""Atomic checkpoints of tensor trees (port of ``repro/checkpoint``)."""

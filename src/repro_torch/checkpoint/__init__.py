"""Atomic, leaf-named checkpoints (port of ``repro.checkpoint``)."""

"""Device meshes (port of the batch part of ``repro.distributed``)."""

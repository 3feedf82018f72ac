"""Launchers on torch (port of ``repro.launch``): the fleet registry, the
serving entry point, the meshes (``mesh``: emulated, or one process a
shard) and the distributed tracking CLI (``track``)."""

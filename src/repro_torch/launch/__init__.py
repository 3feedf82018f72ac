"""Launchers on torch (port of ``repro.launch``): the fleet registry and
the serving entry point."""

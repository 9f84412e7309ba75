"""Launchers of the port: the end-to-end training launcher (port of
``repro/launch``; the mesh and the multi-pod dry run are not ported)."""

"""Launchers of the port (port of ``repro/launch``): the end-to-end
training launcher (``train``), the production meshes (``mesh``: the
single-pod 16x16 and the multi-pod 2x16x16) and the dry run of every cell
on either (``dryrun``)."""
